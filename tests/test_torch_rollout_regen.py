"""The "regen" autoreset on the CPU: the lane rollout that generates a
fresh batch of layouts every step, and PPO's collector in that mode.

On a CUDA device the rollout's step (``parallel/lanes.py:_Scan.step``)
and PPO's collector step (``models/ppo.py:_collect_step``) are captured
as CUDA graphs with ``env.generate`` inside them.  Here:

* both steps, in "regen", run under ``_torch_graph.py``'s
  ``NoHostReads`` on DoorKey-8x8, LavaGapS7, MultiRoom-N6,
  Dynamic-Obstacles-8x8 (its hooks draw), BabyAI-GoToDoor and
  BabyAI-BossLevel, after one warm-up step;
* ``lane_rollout(..., "regen")`` equals a hand-written loop of
  ``step_lanes_env``, ``generate`` and ``select_lanes`` that draws from a
  generator in the same state, in that order (actions, the hooks'
  draws, generation): final state, resets, episodes, reward, checksum;
* against JAX's ``rollout(env, key, B, None, T, "regen")`` on LavaGapS7
  and DoorKey-5x5 at B=1024, T=64: the two draw from different streams
  (``torch.Generator`` against threefry), so episodes per env-step and
  reward per env-step are held by distribution, within 4 standard errors
  of their difference (the standard error from the port's per-env
  totals, the same for both packages' estimates);
* with a step limit of 1 every lane resets every step, so the final state
  is the last step's fresh layouts: each passes its family's invariants
  (``test_torch_generators.py``'s checks).
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel.rollout import rollout as jax_rollout

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

from ._torch_generators import common
from ._torch_graph import NoHostReads
from .test_torch_generators import INVARIANTS

torch.set_num_threads(1)

IDS = [
    "MiniGrid-DoorKey-8x8-v0", "MiniGrid-LavaGapS7-v0", "MiniGrid-MultiRoom-N6-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0", "BabyAI-GoToDoor-v0", "BabyAI-BossLevel-v0",
]
B = 4


def _env(env_id: str, max_steps: int = 2):
    """The env with its step limit cut, so that lanes reset (a BabyAI
    level keeps its per-episode limit in an aux slot, which its generator
    fills from the params' limit where that is fixed)."""
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=max_steps)
    if env_id.startswith("BabyAI-"):
        env.params = env.params.with_extra(fixed_max_steps=True)
    return env


@pytest.mark.parametrize("env_id", IDS)
def test_regen_step_reads_nothing_to_the_host(env_id):
    env = _env(env_id)
    g = torch.Generator().manual_seed(1)
    pool = tlanes.lane_pool(env, g, B, "regen", 4, "cpu")
    scan = tlanes._Scan(env, g, pool, B, 4, "regen", 4, None)
    scan.step(scan.carry.clone())  # warm-up, as the capture's
    before = to_numpy(pool)
    with NoHostReads():
        for _ in range(3):
            scan.step(scan.carry)
    assert int(scan.carry.t) == 3
    for name, value in to_numpy(pool).items():
        np.testing.assert_array_equal(value, before[name], err_msg=name)


@pytest.mark.parametrize("env_id", IDS)
def test_regen_collector_step_reads_nothing_to_the_host(env_id):
    env = _env(env_id)
    ppo = PPO(env, PPOConfig(num_envs=B, rollout_len=3, epochs=1, num_minibatches=2,
                             autoreset="regen"), device="cpu")
    ts = ppo.init(0)
    assert ts.pool is None
    c = ppo._rollout_carry(ts)
    ppo._collect_step(c, ts.model, None, ts.generator)  # warm-up, as the capture's
    ppo._load(c, ts)
    with NoHostReads():
        for _ in range(3):
            ppo._collect_step(c, ts.model, None, ts.generator)
    assert int(c.t) == 3
    assert bool(c.traj.dones.any()), "lanes reset inside the rollout"


def _hand_regen(env, g: torch.Generator, b: int, horizon: int) -> dict:
    """The regen rollout written out: each step draws the actions, steps
    (the hooks drawing after them), generates a fresh batch and takes it
    where the lane finished."""
    ls = tlanes.to_lanes(env.generate(g, env.params, b, "cpu"))
    resets = torch.zeros(b, dtype=torch.int32)
    per_env_reward = torch.zeros(b, dtype=torch.float64)
    rewards, dones, checksums = [], [], []
    for _ in range(horizon):
        act = torch.randint(0, env.action_dim, (b,), generator=g, dtype=torch.int32)
        ls, reward, term = tlanes.step_lanes_env(env, ls, act, g)
        done = term | ls.truncated
        fresh = tlanes.to_lanes(env.generate(g, env.params, b, "cpu"))
        ls = tlanes.select_lanes(done, fresh, ls)
        obj, color, obj_state, vis = tlanes.obs_lanes(env.params, ls)
        checksums.append(((obj.to(torch.int64) + color + obj_state) * vis).sum())
        rewards.append(reward.sum())
        dones.append(done.sum())
        resets += done.to(torch.int32)
        per_env_reward += reward.double()
    return {
        "final": ls, "resets": resets, "episodes": torch.stack(dones).sum(),
        "total_reward": torch.stack(rewards).sum(),
        "checksum": torch.stack(checksums).sum() % (1 << 32),
        "per_env_reward": per_env_reward,
    }


@pytest.mark.parametrize("env_id", IDS)
def test_regen_rollout_equals_a_hand_written_loop(env_id):
    env = _env(env_id)
    b, horizon = 6, 5
    g, h = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = tlanes.lane_rollout(env, g, b, horizon, "regen", device="cpu")
    want = _hand_regen(env, h, b, horizon)
    for name, value in to_numpy(got.final_state).items():
        np.testing.assert_array_equal(value, to_numpy(want["final"])[name], err_msg=name)
    assert torch.equal(got.resets_per_env, want["resets"])
    assert int(got.episodes) == int(want["episodes"]) >= b
    assert torch.equal(got.total_reward, want["total_reward"])
    assert int(got.obs_checksum) == int(want["checksum"])
    assert torch.equal(g.get_state(), h.get_state())


def test_regen_needs_a_generator():
    env = _env(IDS[0])
    pool = tlanes.lane_pool(env, torch.Generator().manual_seed(0), B, "regen", 4, "cpu")
    with pytest.raises(ValueError, match="regen"):
        tlanes._Scan(env, None, pool, B, 2, "regen", 4, torch.zeros(2, B, dtype=torch.int32))


@pytest.mark.parametrize("env_id", ["MiniGrid-LavaGapS7-v0", "MiniGrid-DoorKey-5x5-v0"])
def test_regen_rollout_agrees_with_jax_in_distribution(env_id):
    b, horizon = 1024, 64
    env = port.make(env_id)
    g, h = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    got = tlanes.lane_rollout(env, g, b, horizon, "regen", device="cpu")
    # The same rollout by hand, for each env's own totals.
    hand = _hand_regen(env, h, b, horizon)
    assert torch.equal(got.total_reward, hand["total_reward"])
    assert torch.equal(got.resets_per_env, hand["resets"])
    want = jax_rollout(mgtpu.make(env_id), jax.random.PRNGKey(11), b, None, horizon, "regen")
    steps = b * horizon
    for what, port_rate, jax_rate, per_env in (
        ("episodes", int(got.episodes) / steps, int(want.episodes) / steps,
         got.resets_per_env.double()),
        ("reward", float(got.total_reward) / steps, float(want.total_reward) / steps,
         hand["per_env_reward"]),
    ):
        se = float(per_env.std()) / math.sqrt(b) / horizon
        tol = 4 * math.sqrt(2) * se
        assert abs(port_rate - jax_rate) <= tol, (what, port_rate, jax_rate, tol)
        assert port_rate > 0 and jax_rate > 0, what


@pytest.mark.parametrize("env_id", sorted(INVARIANTS))
def test_final_layouts_pass_the_invariants(env_id):
    """At a step limit of 1 every lane resets every step: the final state
    is the last step's fresh layouts."""
    env = _env(env_id, max_steps=1)
    res = tlanes.lane_rollout(env, torch.Generator().manual_seed(5), 64, 3, "regen", device="cpu")
    assert res.resets_per_env.tolist() == [3] * 64
    s = to_numpy(tlanes.from_lanes(env.params, res.final_state))
    common(s)
    INVARIANTS[env_id](s, env_id)
