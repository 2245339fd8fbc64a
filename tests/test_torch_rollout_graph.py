"""The rollout's step as the card captures it, checked on the CPU.

On a CUDA device ``parallel/lanes.py:_lane_scan`` captures one step of
its scan (``_Scan.step``) as a CUDA graph and replays it; a capture
refuses a step that reads a value back to the host, makes a tensor of
data-dependent shape, or copies host data onto the device.  Here there
is no card, so:

* ``test_step_reads_nothing_to_the_host`` runs the step under a dispatch
  mode that raises on each of those operators (``_torch_graph.py``'s
  ``NoHostReads``: ``data_dependent_output`` and ``dynamic_output_shape``
  tags, boolean-mask indexing, and ``lift_fresh``, a tensor made from
  Python data), and checks that it writes nothing but its carry: the
  pool, which "cached" mode reads as its fresh layouts, is left as it was;
* ``test_scan_matches_jax_given_pool_and_actions`` holds the scan, given
  a pool and JAX's own action draws, bit for bit against JAX's
  ``_lane_scan`` at horizons 1, 2 and 7, with the step limit cut to 2 so
  that lanes reset from the pool.  JAX runs its scan op by op
  (``jax.disable_jit``), which compiles no program.  DynamicObstacles'
  balls draw from the port's ``torch.Generator`` and from per-env keys
  in JAX, so there JAX's pre-step hook is replaced by the port's own
  moves, step by step, after a check that JAX hands it the state that
  the port moved from.

Both run DoorKey-8x8 and ``bench_torch.py``'s eight family ids, in both
autoreset modes; the first with drawn and with given actions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

import bench_torch
import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

from ._torch_families import jax_actions
from ._torch_graph import NoHostReads

torch.set_num_threads(1)

IDS = ["MiniGrid-DoorKey-8x8-v0"] + [env_id for env_id, _ in bench_torch.FAMILIES.values()]
DRAWING = "MiniGrid-Dynamic-Obstacles-8x8-v0"  # the one id whose hooks draw
BATCH = 8
ROUNDS = 2
MAX_STEPS = 2

def _env(env_id: str):
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=MAX_STEPS)
    return env


def _pool(env, g, autoreset: str) -> tlanes.LaneState:
    """The port's layouts, with a step limit kept in an aux slot (BabyAI's)
    cut to ``MAX_STEPS`` as well."""
    pool = tlanes.lane_pool(env, g, BATCH, autoreset, ROUNDS, "cpu")
    slot = env.params.opt("dynamic_max_steps_slot")
    if slot is not None:
        pool.aux[:, slot] = MAX_STEPS
    return pool


@pytest.mark.parametrize("given", [False, True], ids=["drawn", "given"])
@pytest.mark.parametrize("autoreset", ["pool", "cached"])
@pytest.mark.parametrize("env_id", IDS)
def test_step_reads_nothing_to_the_host(env_id, autoreset, given):
    horizon = 3
    env = _env(env_id)
    g = torch.Generator().manual_seed(1)
    pool = _pool(env, g, autoreset)
    before = to_numpy(pool)
    actions = (
        torch.randint(0, env.action_dim, (horizon, BATCH), generator=g, dtype=torch.int32)
        if given else None
    )
    scan = tlanes._Scan(env, g, pool, BATCH, horizon, autoreset, ROUNDS, actions)
    carry = scan.carry
    with NoHostReads():
        for _ in range(horizon):
            scan.step(carry)
    assert scan.carry is carry and int(carry.t) == horizon
    for name, value in to_numpy(pool).items():
        np.testing.assert_array_equal(value, before[name], err_msg=name)


def _jax_lanes(arrays: dict, rng) -> jlanes.LaneState:
    return jlanes.LaneState(**{k: jnp.asarray(v) for k, v in arrays.items()}, rng=rng)


def _replay_port_moves(tenv, jenv):
    """Record the port's pre-step (its draws) and make JAX's return the
    same moves, after a check that JAX moves from the state the port did."""
    moves = []
    port_pre = tenv.pre_step_lanes

    def copied(ls) -> dict:  # the step writes its carry in place
        return {name: value.copy() for name, value in to_numpy(ls).items()}

    def recording(params, generator, ls, action):
        moved = port_pre(params, generator, ls, action)
        moves.append((copied(ls), copied(moved)))
        return moved

    def replaying(params, keys, ls, action):
        start, moved = moves.pop(0)
        for name, value in start.items():
            np.testing.assert_array_equal(np.asarray(getattr(ls, name)), value, err_msg=name)
        return _jax_lanes(moved, ls.rng)

    tenv.pre_step_lanes = recording
    jenv.pre_step_lanes = replaying
    return moves


@pytest.mark.parametrize("horizon", [1, 2, 7])
@pytest.mark.parametrize("autoreset", ["pool", "cached"])
@pytest.mark.parametrize("env_id", IDS)
def test_scan_matches_jax_given_pool_and_actions(env_id, autoreset, horizon):
    tenv = _env(env_id)
    jenv = mgtpu.make(env_id)
    jenv.params = jenv.params.replace(max_steps=MAX_STEPS)
    g = torch.Generator().manual_seed(2)
    pool = _pool(tenv, g, autoreset)
    rounds = ROUNDS if autoreset == "pool" else 1
    jpool = _jax_lanes(to_numpy(pool), jnp.zeros((rounds, BATCH, 2), jnp.uint32))
    k_scan = jax.random.PRNGKey(horizon)
    actions = torch.from_numpy(jax_actions(k_scan, BATCH, horizon, jenv.action_dim))
    moves = _replay_port_moves(tenv, jenv) if env_id == DRAWING else None

    got = tlanes._lane_scan(tenv, g, pool, BATCH, horizon, autoreset, ROUNDS, actions=actions)
    with jax.disable_jit():
        want = jlanes._lane_scan(jenv, k_scan, jpool, BATCH, horizon, autoreset, ROUNDS)

    if moves is not None:
        assert moves == []  # JAX took every move the port made
    final = to_numpy(got.final_state)
    for name, value in final.items():
        np.testing.assert_array_equal(value, np.asarray(getattr(want.final_state, name)), err_msg=name)
    np.testing.assert_array_equal(got.resets_per_env.numpy(), np.asarray(want.resets_per_env))
    assert int(got.episodes) == int(want.episodes)
    assert got.steps == int(want.steps) == BATCH * horizon
    assert int(got.obs_checksum) == int(want.obs_checksum)
    assert got.total_reward.numpy().tobytes() == np.asarray(want.total_reward).tobytes()
    if horizon >= MAX_STEPS:
        assert int(got.episodes) >= BATCH
