"""The port's guards, telemetry and profiling, as JAX's
``tests/test_guards.py`` holds its own (``device_audit`` probes a TPU
backend and is not ported): the checked step and reset, the NaN/Inf
tripwire, the acceptance telemetry (loop mode on BabyAI and MultiRoom,
the structural fallback, JAX's report keys), and the trace with its
spans."""

from __future__ import annotations

import json
import os

import jax
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.utils.telemetry import generation_acceptance as jax_acceptance

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.utils.guards import (
    check_state,
    checked_reset,
    checked_step,
    debug_mode,
)
from minigrid_dynamicprogramming_tpu_torch.utils.profiling import SPANS_FILE, TRACE_FILE, span, trace
from minigrid_dynamicprogramming_tpu_torch.utils.telemetry import (
    GenStats,
    generation_acceptance,
    pooled_stats,
)

torch.set_num_threads(1)


def _reset(env_id: str, b: int = 16):
    env = port.make(env_id)
    return env, env.reset(torch.Generator().manual_seed(0), b, "cpu")[1]


def test_checked_step_clean_episode():
    env, state = _reset("MiniGrid-DoorKey-8x8-v0")
    step = checked_step(env)
    g = torch.Generator().manual_seed(1)
    for _ in range(20):
        a = torch.randint(0, 7, (16,), generator=g)
        err, (obs, state, r, term, trunc, _) = step(state, a, g)
        err.throw()  # no invariant violated on the healthy path
        assert err.get() is None


def test_checked_step_catches_corrupted_state():
    env, state = _reset("MiniGrid-Empty-8x8-v0", 4)
    step = checked_step(env)
    pos = state.agent_pos.clone()
    pos[1] = torch.tensor([99, 1])
    err, _ = step(state.replace(agent_pos=pos), 0)
    with pytest.raises(RuntimeError, match="out of bounds"):
        err.throw()
    grid = state.grid_obj.clone()
    grid[2, 2, 2] = 200
    err, _ = step(state.replace(grid_obj=grid), 0)
    assert err.get() == "grid object code outside the encoding table"
    with pytest.raises(RuntimeError, match="object code"):
        err.throw()
    assert check_state(env.params, state).get() is None


def test_checked_reset_all_flagship_envs():
    for env_id in ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0", "BabyAI-GoToDoor-v0"]:
        err, (obs, state) = checked_reset(port.make(env_id))(torch.Generator().manual_seed(0), 8, "cpu")
        err.throw()
        assert state.agent_dir.shape == (8,)


def test_debug_mode_trips_on_nan():
    x = torch.zeros(1)
    with debug_mode():
        with pytest.raises(FloatingPointError, match="NaN in the output of aten.div"):
            x / x
        with pytest.raises(FloatingPointError, match="Inf in the output of aten.div"):
            (x + 1) / x
        (x + 1) * 2  # finite outputs pass
    with debug_mode(nans=False):
        x / x
    assert torch.isnan(x / x).all()  # off outside the block


def _check_keys(rep: dict, want: dict):
    assert set(rep) == set(want), (rep, want)
    assert rep["mode"] == want["mode"]


def test_generation_acceptance_loop_mode():
    """BabyAI levels report their pooled attempts (the JAX report's keys
    and mode on the same id)."""
    rep = generation_acceptance(port.make("BabyAI-GoToDoor-v0"), n=512, device="cpu")
    _check_keys(rep, jax_acceptance(mgtpu.make("BabyAI-GoToDoor-v0"), n=8))
    assert rep["mode"] == "loop"
    assert rep["accept_rate"] == 1.0
    assert 1.0 <= rep["mean_tries"] <= rep["max_tries"]
    assert 0.0 < rep["first_try_rate"] <= 1.0


def test_generation_acceptance_multiroom():
    rep = generation_acceptance(port.make("MiniGrid-MultiRoom-N6-v0"), n=512, device="cpu")
    assert rep["mode"] == "loop"
    assert rep["accept_rate"] >= 0.99
    assert rep["mean_tries"] > 1.0  # a six-room chain often fails


def test_generation_acceptance_structural_fallback():
    rep = generation_acceptance(port.make("MiniGrid-Empty-8x8-v0"), n=256, device="cpu")
    _check_keys(rep, jax_acceptance(mgtpu.make("MiniGrid-Empty-8x8-v0"), n=8))
    assert rep["mode"] == "structural"
    assert rep["accept_rate"] == 1.0


def test_pooled_stats():
    ok = torch.tensor([False, True, True, False, False, True, False])
    got = pooled_stats(ok, 3)
    assert got.tries.tolist() == [2, 1, 3] and got.ok.all()
    short = pooled_stats(ok, 5)  # two repeats, charged the last attempt
    assert short.tries.tolist() == [2, 1, 3, 1, 1] and short.ok.tolist() == [True] * 3 + [False] * 2
    none = pooled_stats(torch.zeros(4, dtype=torch.bool), 2)
    assert isinstance(none, GenStats) and none.tries.tolist() == [4, 4] and not none.ok.any()


def test_profiler_trace_writes_events(tmp_path):
    env = port.make("MiniGrid-Empty-8x8-v0")
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with span("reset", batch=4):
            env.reset(torch.Generator().manual_seed(0), 4, "cpu")
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "reset" in names, "the span's range is in the trace"
    assert any(str(n).startswith("aten::") for n in names), "operators are in the trace"
    with open(os.path.join(logdir, SPANS_FILE)) as f:
        spans = json.load(f)
    (rec,) = [r for r in spans["records"] if r["name"] == "reset"]
    assert rec["attrs"] == {"batch": 4} and rec["count"] == 1 and rec["device_ms"] > 0
    assert set(spans) == {"records", "dropped", "counters"}
