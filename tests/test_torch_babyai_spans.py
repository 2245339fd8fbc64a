"""The BabyAI generator's and verifier's spans (``envs/babyai/level.py``,
``levelgen.py``, ``core.py``): in a traced eager BossLevel rollout,
``babyai.generate`` holds ``babyai.generate.rooms``, ``.instr`` and
``.accept`` and carries its attempts and layouts, and ``babyai.verify``
runs inside ``lanes.transition``; with tracing off no record is kept and
the layouts are the same; the counter ``babyai.generate.attempts`` adds
each call's attempts.  On a card (``-m cuda``), a captured regen step
stamps every one of them.  This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_babyai_spans.py -q
"""

from __future__ import annotations

import math
from collections import Counter

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

ENV = "BabyAI-BossLevel-v0"
B, T = 12, 3
PARTS = ("babyai.generate.rooms", "babyai.generate.instr", "babyai.generate.accept")


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A recorder of each test's own."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _attempts(n: int) -> int:
    return max(n + 8, math.ceil(1.5 * n))


def _rollout(device="cpu", b=B, horizon=T, seed=5):
    env = port.make(ENV)
    g = torch.Generator(device=device).manual_seed(seed)
    return lanes.lane_rollout(env, g, b, horizon, "regen", device=device)


def _check_nesting(recs, generates: int, verifies: int) -> None:
    by_id = {r["id"]: r for r in recs}
    names = Counter(r["name"] for r in recs)
    assert names["babyai.generate"] == generates
    for part in PARTS:
        assert names[part] == generates, part
    assert names["babyai.verify"] == verifies
    for r in recs:
        if r["name"] in PARTS:
            assert by_id[r["parent"]]["name"] == "babyai.generate", r["name"]
        if r["name"] == "babyai.generate":
            assert by_id[r["parent"]]["name"] == "generator.generate"
        if r["name"] == "babyai.verify":
            assert by_id[r["parent"]]["name"] == "lanes.transition"


def test_traced_eager_rollout_spans_the_generator_and_verifier():
    with profiling.tracing():
        _rollout()
    recs = profiling.records()
    # The first batch and one a step; the verifier once a step.
    _check_nesting(recs, T + 1, T)
    for r in recs:
        if r["name"] == "babyai.generate":
            assert r["attrs"] == {"attempts": _attempts(B), "layouts": B}
    by_id = {r["id"]: r for r in recs}
    for gen in (r for r in recs if r["name"] == "babyai.generate"):
        parts = [r for r in recs if r["parent"] == gen["id"]]
        assert {r["name"] for r in parts} == set(PARTS)
        assert sum(r["device_ms"] for r in parts) <= gen["device_ms"]
        assert by_id[gen["parent"]]["name"] == "generator.generate"


def test_tracing_off_keeps_no_record_and_the_same_layouts():
    env = port.make(ENV)

    def layouts():
        return env.generate(torch.Generator().manual_seed(3), env.params, B, "cpu")

    off = layouts()
    assert profiling.records() == []
    with profiling.tracing():
        on = layouts()
    assert [r["name"] for r in profiling.records()].count("babyai.generate") == 1
    for name in off.__dataclass_fields__:
        assert torch.equal(getattr(off, name), getattr(on, name)), name


@pytest.mark.parametrize("n", [1, 12, 40])
def test_attempts_counter_adds_each_call(n):
    env = port.make(ENV)
    g = torch.Generator().manual_seed(n)
    before = profiling.counter("babyai.generate.attempts")
    env.generate(g, env.params, n, "cpu")
    env.generate(g, env.params, n, "cpu")
    assert profiling.counter("babyai.generate.attempts") - before == 2 * _attempts(n)


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamps are a kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_regen_step_stamps_every_babyai_span(card):
    """A graphed BossLevel regen rollout under ``tracing()``: each new span
    is stamped in the step's graph and counts ``horizon`` replays (and
    once more eagerly in the capture's warm-up); the graph's generate keeps
    its attributes; the result equals the untraced call's."""
    b, horizon = 1024, 6
    off = _rollout(card, b, horizon)
    assert profiling.records() == []
    with profiling.tracing():
        on = _rollout(card, b, horizon)
    recs = profiling.records()
    assert torch.equal(on.obs_checksum, off.obs_checksum) and torch.equal(on.resets_per_env, off.resets_per_env)
    graphed = {r["name"]: r for r in recs if r["attrs"].get("graph")}
    for name in ("babyai.generate", "babyai.verify") + PARTS:
        assert graphed[name]["count"] == horizon and graphed[name]["device_ms"] > 0, name
    assert graphed["babyai.generate"]["attrs"] == {"graph": True, "attempts": _attempts(b), "layouts": b}
    by_id = {r["id"]: r for r in recs}
    for part in PARTS:
        assert by_id[graphed[part]["parent"]] is graphed["babyai.generate"], part
    assert by_id[graphed["babyai.verify"]["parent"]] is graphed["lanes.transition"]
    # The eager records: the first batch and the capture's warm-up step.
    _check_nesting([r for r in recs if not r["attrs"].get("graph")], 2, 1)
