"""The port's tracing layer (``utils/profiling.py``) on the CPU: spans keep
records only while tracing is on, and then on the profiler's clock with
their parent and request; the rollout's and the key-domain solve's spans
where the work happens; the recorder's bound; the counters.  The in-graph
stamps need a card (``tests/test_torch_on_card.py``)."""

from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

torch.set_num_threads(1)

ENV = "MiniGrid-DoorKey-8x8-v0"
B, T = 24, 30
STEP_PARTS = ("lanes.step", "lanes.transition", "lanes.select", "lanes.observation")


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A recorder of each test's own."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _rollout(mode: str, seed: int = 3):
    env = port.make(ENV)
    env.params = env.params.replace(max_steps=12)  # lanes reset within the horizon
    g = torch.Generator().manual_seed(seed)
    return lanes.lane_rollout(env, g, B, T, mode, 2, device="cpu")


def _solve(seed: int = 4):
    env = port.make(ENV)
    _, state = env.reset(torch.Generator().manual_seed(seed), 3, "cpu")
    layout = tkey.extract_key_layout(state, max_doors=1)
    v = cuda_vi.cuda_key_value_iteration(layout, 0.99, 16)
    return v, tkey.key_greedy_policy(v, layout, 0.99)


def _by_name(recs):
    return Counter(r["name"] for r in recs)


def test_tracing_off_keeps_no_record():
    assert not profiling.is_tracing()
    _rollout("regen")
    _solve()
    with profiling.span("outside") as rec:
        assert rec is None
    assert profiling.records() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("mode", ["pool", "regen", "cached"])
def test_rollout_bit_identical_with_tracing_on_and_off(mode):
    off = _rollout(mode)
    with profiling.tracing():
        on = _rollout(mode)
    assert profiling.records()
    for name in lanes._FIELDS:
        assert torch.equal(getattr(on.final_state, name), getattr(off.final_state, name)), name
    for name in ("total_reward", "episodes", "obs_checksum", "resets_per_env", "successes", "failures"):
        assert torch.equal(getattr(on, name), getattr(off, name)), name


def test_dp_chain_bit_identical_with_tracing_on_and_off():
    v_off, pol_off = _solve()
    with profiling.tracing():
        v_on, pol_on = _solve()
    assert torch.equal(v_on, v_off) and torch.equal(pol_on, pol_off)
    recs = profiling.records()
    assert _by_name(recs) == {"dp.extract": 1, "dp.vi": 1, "dp.policy": 1}
    assert all(r["parent"] is None and r["request"] == r["id"] for r in recs)
    assert all(r["count"] == 1 and r["device_ms"] > 0 for r in recs)


def test_spans_lie_on_the_profiler_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.is_tracing()
        with profiling.span("warm-up"):
            pass
        with profiling.span("outer", k=1):
            with profiling.span("inner"):
                torch.ones(64).cumsum(0)
            with profiling.graph_span("eager-part"):
                torch.ones(64).sum()
    assert not profiling.is_tracing()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    recs = {r["name"]: r for r in profiling.records()}
    for name in ("outer", "inner", "eager-part"):
        r, e = recs[name], events[name]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert r["start_ns"] < end and start < r["end_ns"], name
        assert abs(r["start_ns"] - start) < 1_000_000, name
    outer = recs["outer"]
    assert outer["parent"] is None and outer["request"] == outer["id"] and outer["attrs"] == {"k": 1}
    for name in ("inner", "eager-part"):
        assert recs[name]["parent"] == outer["id"] and recs[name]["request"] == outer["id"]
    assert recs["warm-up"]["request"] != outer["id"]


@pytest.mark.parametrize("mode", ["pool", "regen"])
def test_eager_rollout_records_each_part_once_a_step(mode):
    with profiling.tracing():
        _rollout(mode)
    recs = profiling.records()
    names = _by_name(recs)
    for part in STEP_PARTS:
        assert names[part] == T, part
    # The pool's one batch of layouts; in "regen" the initial batch and
    # one a step.
    assert names["generator.generate"] == (1 if mode == "pool" else T + 1)
    for name in ("lanes.rollout", "lanes.pool", "lanes.replay", "lanes.result"):
        assert names[name] == 1, name
    by_id = {r["id"]: r for r in recs}
    (call,) = [r for r in recs if r["name"] == "lanes.rollout"]
    assert all(r["request"] == call["id"] for r in recs)
    parent = {
        "lanes.pool": "lanes.rollout", "lanes.replay": "lanes.rollout",
        "lanes.result": "lanes.rollout", "lanes.step": "lanes.replay",
        "lanes.transition": "lanes.step", "lanes.select": "lanes.step",
        "lanes.observation": "lanes.step",
    }
    for r in recs:
        if r["name"] in parent:
            assert by_id[r["parent"]]["name"] == parent[r["name"]], r["name"]
    gens = [by_id[r["parent"]]["name"] for r in recs if r["name"] == "generator.generate"]
    assert Counter(gens) == ({"lanes.pool": 1} if mode == "pool" else {"lanes.pool": 1, "lanes.step": T})
    for step in (r for r in recs if r["name"] == "lanes.step"):
        parts = [r for r in recs if r["parent"] == step["id"]]
        assert sum(p["device_ms"] for p in parts) <= step["device_ms"]


def test_recorder_bound_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(capacity=3))
    with profiling.tracing():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r["name"] for r in profiling.records()] == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_counters_count_with_tracing_off():
    assert profiling.counter("x") == 0
    profiling.count("x")
    profiling.count("x", 2.5)
    assert profiling.counter("x") == 3.5 and profiling.counters() == {"x": 3.5}
    with profiling.tracing():
        profiling.count("y")
    profiling.clear()
    assert profiling.counters() == {"x": 3.5, "y": 1}


def test_tracing_blocks_nest():
    with profiling.tracing():
        with profiling.tracing():
            assert profiling.is_tracing()
        assert profiling.is_tracing()
    assert not profiling.is_tracing()
