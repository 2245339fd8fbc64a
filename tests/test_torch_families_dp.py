"""The port's exact DP on the new families' layouts against the JAX
package's: LavaGapS7, LavaCrossingS9N2, FourRooms, DistShift1 and
Empty-Random-6x6, the layouts that ``dp/tabular.py`` covers exactly (lava,
no doors, no key).  States come from the JAX generator and cross over
through numpy; layouts, values and policy must be equal bit for bit.  The
port's ``solve`` on its own LavaGap layouts, stepped by ``step_lanes_env``,
must reach the goal in exactly ``steps_to_go`` steps with the closed-form
return, as ``chip_smoke.py`` requires on the card."""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp import tabular as jtab

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

GAMMA = 0.995


def _np(tree) -> dict:
    names = tree._fields if hasattr(tree, "_fields") else tree.__dataclass_fields__
    return {n: np.asarray(getattr(tree, n)) for n in names}


@pytest.mark.parametrize("env_id", [
    "MiniGrid-LavaGapS7-v0",
    "MiniGrid-LavaCrossingS9N2-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-DistShift1-v0",
    "MiniGrid-Empty-Random-6x6-v0",
])
def test_value_iteration_equals_jax(env_id):
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    jstates = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    tstates = from_numpy(EnvState, _np(jstates), "cpu")
    jlay = jax.vmap(partial(jtab.extract_layout, max_doors=1))(jstates)
    tlay = ttab.extract_layout(tstates, 1)
    got = to_numpy(tlay)
    for name, value in _np(jlay).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    sweeps = 48
    jv, jpol = jax.jit(jax.vmap(partial(jtab.value_iteration, gamma=GAMMA, n_sweeps=sweeps)))(jlay)
    tv, tpol = ttab.value_iteration(tlay, GAMMA, sweeps)
    assert (tv.numpy() > 0).any()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpol.numpy(), np.asarray(jpol))
    np.testing.assert_array_equal(
        ttab.state_value(tv, tlay, tstates).numpy(),
        np.asarray(jax.vmap(jtab.state_value)(jv, jlay, jstates)),
    )


def test_solve_lavagap_greedy_is_optimal():
    env = port.make("MiniGrid-LavaGapS7-v0")
    b = 16
    states, layouts, v, policy = ttab.solve(
        env, torch.Generator().manual_seed(3), b, GAMMA, 64, max_doors=1, device="cpu"
    )
    assert layouts.lava.any(dim=(1, 2)).all()
    vals = ttab.state_value(v, layouts, states)
    dists = ttab.steps_to_go(vals, GAMMA)
    assert torch.isfinite(dists).all()
    ls = tlanes.to_lanes(states)
    done = torch.zeros(b, dtype=torch.bool)
    steps = torch.zeros(b)
    rew = torch.zeros(b)
    for t in range(int(dists.max()) + 1):
        act = ttab.greedy_action(policy, layouts, tlanes.from_lanes(env.params, ls))
        ls, r, term = tlanes.step_lanes_env(env, ls, act)
        newly = term & ~done
        rew = torch.where(newly, r, rew)
        steps = torch.where(newly, float(t + 1), steps)
        done |= term
    assert done.all() and (rew > 0).all()
    torch.testing.assert_close(steps, dists, rtol=0, atol=0)
    want_r = ttab.env_return(vals, GAMMA, 0, env.params.max_steps)
    torch.testing.assert_close(rew, want_r.to(rew.dtype), rtol=0, atol=1e-5)
