"""The port's exact DP against the JAX package's, on the same layouts.

States come from the JAX generator and cross over through numpy.  The
restricted domain (``tabular``) must match bit for bit, values and policy;
the key-position domain (``tabular_key``) within atol 1e-6, the tolerance
the JAX package holds its own key-domain kernel to.  ``solve``'s policy,
stepped by the port's ``step_lanes``, must be optimal.  The CUDA wrappers
are tested in ``test_torch_cuda_vi.py``.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp import tabular as jtab
from minigrid_dynamicprogramming_tpu.dp import tabular_key as jkey

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_DOOR, OBJ_KEY
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

GAMMA = 0.995
ENV_IDS = ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-DoorKey-8x8-v0"]


def _np(tree) -> dict:
    names = tree._fields if hasattr(tree, "_fields") else tree.__dataclass_fields__
    return {n: np.asarray(getattr(tree, n)) for n in names}


def _states(env_id: str, batch: int, seed: int):
    """(JAX batch of states, the same states in the port)."""
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    return states, from_numpy(EnvState, _np(states), "cpu")


def _assert_records_equal(got, want: dict):
    got = to_numpy(got)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("max_doors", [1, 2])
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_extract_layouts_equal_jax(env_id, max_doors):
    jstates, tstates = _states(env_id, 16, seed=0)
    want = jax.vmap(partial(jtab.extract_layout, max_doors=max_doors))(jstates)
    _assert_records_equal(ttab.extract_layout(tstates, max_doors), _np(want))
    want = jax.vmap(partial(jkey.extract_key_layout, max_doors=max_doors))(jstates)
    _assert_records_equal(tkey.extract_key_layout(tstates, max_doors), _np(want))


@pytest.mark.parametrize("max_doors", [1, 2])
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_value_iteration_bit_exact(env_id, max_doors):
    jstates, tstates = _states(env_id, 8, seed=1)
    jlay = jax.vmap(partial(jtab.extract_layout, max_doors=max_doors))(jstates)
    jv, jpol = jax.jit(
        jax.vmap(partial(jtab.value_iteration, gamma=GAMMA, n_sweeps=64))
    )(jlay)
    tlay = ttab.extract_layout(tstates, max_doors)
    tv, tpol = ttab.value_iteration(tlay, GAMMA, 64)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpol.numpy(), np.asarray(jpol))
    assert (tv.numpy() > 0).any()
    np.testing.assert_array_equal(
        ttab.steps_to_go(tv, GAMMA).numpy(), np.asarray(jtab.steps_to_go(jv, GAMMA))
    )
    np.testing.assert_array_equal(
        ttab.state_value(tv, tlay, tstates).numpy(),
        np.asarray(jax.vmap(jtab.state_value)(jv, jlay, jstates)),
    )


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_key_value_iteration_matches_jax(env_id):
    jstates, tstates = _states(env_id, 3, seed=2)
    jlay = jax.vmap(partial(jkey.extract_key_layout, max_doors=1))(jstates)
    jv, _ = jax.jit(
        jax.vmap(partial(jkey.key_value_iteration, gamma=GAMMA, n_sweeps=48))
    )(jlay)
    tlay = tkey.extract_key_layout(tstates, 1)
    tv, _ = tkey.key_value_iteration(tlay, GAMMA, 48)
    assert (tv.numpy() > 0).any()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tkey.key_steps_to_go(tkey.key_state_value(tv, tlay, tstates), GAMMA).numpy(),
        np.asarray(
            jkey.key_steps_to_go(jax.vmap(jkey.key_state_value)(jv, jlay, jstates), GAMMA)
        ),
    )


def test_greedy_rollout_is_optimal():
    """``solve``'s greedy policy, stepped by the port's ``step_lanes``,
    reaches the goal in exactly ``steps_to_go`` steps with the closed-form
    return."""
    env = port.make("MiniGrid-DoorKey-6x6-v0")
    b = 8
    states, layouts, v, policy = ttab.solve(
        env, torch.Generator().manual_seed(11), b, GAMMA, 128, max_doors=1, device="cpu"
    )
    vals = ttab.state_value(v, layouts, states)
    dists = ttab.steps_to_go(vals, GAMMA)
    assert torch.isfinite(dists).all()

    params = env.params
    ls = tlanes.to_lanes(states)
    done = torch.zeros(b, dtype=torch.bool)
    steps = torch.zeros(b, dtype=torch.float32)
    rew = torch.zeros(b)
    for t in range(int(dists.max()) + 1):
        act = ttab.greedy_action(policy, layouts, tlanes.from_lanes(params, ls))
        ls, r, term = tlanes.step_lanes(params, ls, act)
        newly = term & ~done
        rew = torch.where(newly, r, rew)
        steps = torch.where(newly, float(t + 1), steps)
        done |= term
    assert done.all()
    torch.testing.assert_close(steps, dists, rtol=0, atol=0)
    want_r = ttab.env_return(vals, GAMMA, 0, params.max_steps)
    torch.testing.assert_close(rew, want_r.to(rew.dtype), rtol=0, atol=1e-5)


def test_assert_dp_scope():
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    states = env.generate(torch.Generator().manual_seed(0), env.params, 4, device="cpu")
    ttab.assert_dp_scope(states, 1)
    # A second key on the grid leaves the domain.
    two_keys = states.replace(grid_obj=states.grid_obj.clone())
    two_keys.grid_obj[2, 1, 6] = OBJ_KEY  # right of every split column
    with pytest.raises(ValueError, match=r"layouts \[2\].*one key"):
        ttab.assert_dp_scope(two_keys, 1)
    # A second, locked door past a one-door budget would be frozen as a wall.
    two_doors = states.replace(grid_obj=states.grid_obj.clone())
    two_doors.grid_obj[1, 2, 6] = OBJ_DOOR
    two_doors = two_doors.replace(grid_state=two_doors.grid_state.clone())
    two_doors.grid_state[1, 2, 6] = 2
    with pytest.raises(ValueError, match=r"layouts \[1\]"):
        ttab.assert_dp_scope(two_doors, 1)
    ttab.assert_dp_scope(two_doors, 2)
