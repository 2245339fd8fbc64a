"""Each driver, run through the harness on the CPU at a small size, agrees
with the plain reference; its control (the reference one step below the
configuration's precision) and each fault planted in the timed path make
``correct`` come out false."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

ROLLOUT = dict(batch=64, horizon=48)
# At this size and seed the random actions reach the goal a few times, so
# that the reward's precision shows.
ROLLOUT_SUCCESSES = dict(batch=256, horizon=700)
# One layout at the cell's 256 sweeps, which converge at 16x16.
DP = dict(layouts=1, sweeps=256, ring=2, check_calls=1, check_block=1)


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def run(bench, cell, overrides, seed=20260417, control=False):
    return harness.run_cell(bench, cell, seed, 0.0, False, "cpu", time.time(),
                            overrides=overrides, control=control)


@pytest.mark.parametrize("cell", ["doorkey-8x8.rollout-pool", "doorkey-8x8.rollout-regen"])
def test_rollout_agrees_with_the_reference(bench, cell):
    line = run(bench, cell, ROLLOUT)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert line["metrics"]["env_steps_per_s"]["value"] > 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


def test_dp_solve_agrees_with_the_reference(bench):
    line = run(bench, "doorkey-16x16.vi-key", DP)
    assert line["correct"], line["checks"]
    assert line["checks"]["v_gap"]["value"] == 0 and line["checks"]["policy_value_gap"]["value"] == 0
    assert {"dp_layouts_per_s", "dp_solve_ms_p95", "setup_s"} <= set(line["metrics"])


def test_rollout_control_fails(bench):
    line = run(bench, "doorkey-8x8.rollout-pool", ROLLOUT_SUCCESSES, seed=1, control=True)
    assert not line["correct"]
    reward = line["checks"]["reward_gap"]
    assert reward["value"] > 3 * reward["limit"]


def test_dp_control_fails(bench):
    line = run(bench, "doorkey-16x16.vi-key", DP, control=True)
    assert not line["correct"]
    assert line["checks"]["v_gap"]["value"] > 3 * line["checks"]["v_gap"]["limit"]


# --- faults planted in the timed path ------------------------------------

def _rollout_fault(monkeypatch, fault: str) -> None:
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    real_step, real_obs = lanes.step_lanes, lanes.obs_lanes

    def unchanged(params, ls, action):
        b = action.shape[0]
        return ls, torch.zeros(b), torch.zeros(b, dtype=torch.bool)

    def half(params, ls, action):
        new, reward, term = real_step(params, ls, action)
        b = action.shape[0]
        keep = torch.arange(b) >= b // 2
        mixed = {}
        for name in lanes._FIELDS:
            a, o = getattr(new, name), getattr(ls, name)
            mixed[name] = torch.where(keep, o, a)
        return (lanes.LaneState(**mixed), torch.where(keep, 0.0, reward),
                torch.where(keep, False, term))

    def altered(params, ls):
        obj, color, state, vis = real_obs(params, ls)
        agent_cell = (params.agent_view_size - 1) * params.agent_view_size + params.agent_view_size // 2
        obj = obj.clone()
        obj[agent_cell, 0] += 1
        return obj, color, state, vis

    if fault == "unchanged":
        monkeypatch.setattr(lanes, "step_lanes", unchanged)
    elif fault == "half":
        monkeypatch.setattr(lanes, "step_lanes", half)
    else:
        monkeypatch.setattr(lanes, "obs_lanes", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["doorkey-8x8.rollout-pool", "doorkey-8x8.rollout-regen"])
def test_rollout_faults_fail(bench, monkeypatch, cell, fault):
    _rollout_fault(monkeypatch, fault)
    line = run(bench, cell, ROLLOUT)
    assert not line["correct"], (fault, line["checks"])


def _dp_fault(monkeypatch, fault: str) -> None:
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK

    real_values, real_policy = TK.key_vi_values, TK.key_greedy_policy

    def unchanged(layout, gamma, n):
        return real_values(layout, gamma, 0)

    def half(layout, gamma, n):
        v = real_values(layout, gamma, n)
        v[v.shape[0] // 2:] = 0.0
        return v

    def altered(layout, gamma, n):
        v = real_values(layout, gamma, n)
        v.view(-1)[v.numel() // 3] += 1e-2
        return v

    def stay(v, layout, gamma):
        return torch.full_like(real_policy(v, layout, gamma), 6)

    patch = {"unchanged": ("key_vi_values", unchanged), "half": ("key_vi_values", half),
             "altered": ("key_vi_values", altered), "policy": ("key_greedy_policy", stay)}[fault]
    monkeypatch.setattr(TK, *patch)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "policy"])
def test_dp_faults_fail(bench, monkeypatch, fault):
    _dp_fault(monkeypatch, fault)
    line = run(bench, "doorkey-16x16.vi-key", DP)
    assert not line["correct"], (fault, line["checks"])
