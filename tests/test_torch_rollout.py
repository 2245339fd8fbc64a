"""The PyTorch port's pool-autoreset rollout against JAX ``lane_rollout``.

JAX's pool (``_lane_pool`` from the same key split as ``lane_rollout``)
crosses over through numpy, and JAX's own action draws (``split(k_scan,
T)``, then per step ``split(key_t)[0]`` -> ``randint(.., (B,), 0, 7)``) are
fed to the port, so the two runs see the same layouts and actions, in
both autoreset modes ("pool" draws each reset from the next pool round,
"cached" replays each lane's first layout).  DoorKey-5x5 has max_steps 250 < T = 300, so every lane resets.  The final
state, resets per env, episodes and the observation checksum must be equal;
the total reward sums float32 in another order, so it agrees within rtol
1e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

ENV_ID = "MiniGrid-DoorKey-5x5-v0"
BATCH = 128
HORIZON = 300
ROUNDS = 3


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def _jax_actions(k_scan, batch, horizon, action_dim):
    def draw(key_t):
        k_act, _ = jax.random.split(key_t)
        return jax.random.randint(k_act, (batch,), 0, action_dim)

    return np.array(jax.vmap(draw)(jax.random.split(k_scan, horizon)))


@pytest.mark.parametrize("autoreset", ["pool", "cached"])
def test_rollout_matches_jax_given_pool_and_actions(autoreset):
    jenv = mgtpu.make(ENV_ID)
    key = jax.random.PRNGKey(7)
    want = jlanes.lane_rollout(jenv, key, BATCH, HORIZON, autoreset, ROUNDS)

    k_init, k_scan = jax.random.split(key)
    jpool = jlanes._lane_pool(jenv, k_init, BATCH, autoreset, ROUNDS)
    pool = from_numpy(tlanes.LaneState, _np(jpool), "cpu")
    actions = torch.from_numpy(_jax_actions(k_scan, BATCH, HORIZON, jenv.action_dim))

    tenv = port.make(ENV_ID)
    got = tlanes._lane_scan(
        tenv, None, pool, BATCH, HORIZON, autoreset, ROUNDS, actions=actions
    )

    assert int(want.episodes) > 0
    final = to_numpy(got.final_state)
    for name, value in _np(want.final_state).items():
        if name != "rng":
            np.testing.assert_array_equal(final[name], value, err_msg=name)
    np.testing.assert_array_equal(
        got.resets_per_env.numpy(), np.asarray(want.resets_per_env)
    )
    assert int(got.episodes) == int(want.episodes)
    assert got.steps == int(want.steps)
    assert int(got.obs_checksum) == int(want.obs_checksum)
    np.testing.assert_allclose(
        float(got.total_reward), float(want.total_reward), rtol=1e-5
    )


def test_lane_rollout_draws_and_resets_on_cpu():
    """The port's own draws: pool generation plus uniform actions."""
    env = port.make(ENV_ID)
    res = tlanes.lane_rollout(
        env, torch.Generator().manual_seed(3), 32, horizon=300,
        pool_rounds=3, device="cpu",
    )
    assert int(res.episodes) > 0
    assert res.steps == 32 * 300
    assert int(res.obs_checksum) != 0
    assert int(res.resets_per_env.min()) >= 1
    # Below the max_steps=250 limit: truncated lanes were replaced.
    assert int(res.final_state.step_count.max()) < 250
