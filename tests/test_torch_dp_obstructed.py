"""The port's obstructed-domain DP (``dp/tabular_obstructed.py``) against
the JAX package's on ObstructedMaze-1Dlhb (a key in a box, a blocking
ball) and BlockedUnlockPickup (a blocking ball; the target the box, as the
JAX bench picks it), two JAX-generated layouts each: the layouts equal
field by field, V within 1e-6 and the greedy policy equal wherever the
best action leads the next by more than 1e-6, at 24 sweeps.  Then the
greedy policy, stepped by the port's ``step_lanes_env``, realizes
``obstructed_steps_to_go`` on a 1Dlhb layout at 80 sweeps (the JAX test's
count)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu.dp import tabular_obstructed as jobs

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BOX
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_obstructed as tobs
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

from .test_torch_dp_key_families import _np, jax_states

torch.set_num_threads(1)

GAMMA = 0.995


def targets(states):
    """(type, color) of each layout's target, from aux slots 0-1."""
    return np.array(states.aux[:, 0]), np.array(states.aux[:, 1])


def box_target(states):
    """(type, color) of each layout's one box, as ``bench.py`` picks
    BlockedUnlockPickup's target."""
    obj = np.asarray(states.grid_obj)
    n = len(obj)
    flat = (obj == OBJ_BOX).reshape(n, -1).argmax(axis=1)
    color = np.asarray(states.grid_color).reshape(n, -1)[np.arange(n), flat]
    return np.full(n, OBJ_BOX, np.int32), color.astype(np.int32)


CASES = [
    ("MiniGrid-ObstructedMaze-1Dlhb-v0", targets),
    ("MiniGrid-BlockedUnlockPickup-v0", box_target),
]


def unique_best(v, layouts) -> torch.Tensor:
    """Where the best action's value leads every other's by more than
    1e-6: (N, Bl, K, Cd, 4, H, W) bool."""
    tables = tobs._tables(layouts, v.shape[1], v.shape[2])
    out = torch.empty(v.shape, dtype=torch.bool)
    for d, t in enumerate(tables):
        q = torch.stack(list(tobs._action_values(v, t, d, layouts.box_idx, GAMMA)))
        top2 = q.topk(2, dim=0).values
        out[:, :, :, :, d] = top2[0] - top2[1] > 1e-6
    return out


@pytest.mark.parametrize("env_id,target", CASES)
def test_layout_values_and_policy_equal_jax(env_id, target):
    js = jax_states(env_id, 2, seed=1)
    ts = from_numpy(EnvState, _np(js), "cpu")
    tt, tc = target(js)
    jl = jax.vmap(lambda s, a, b: jobs.extract_obstructed_layout(s, 1, a, b))(js, tt, tc)
    tl = tobs.extract_obstructed_layout(ts, 1, torch.from_numpy(tt), torch.from_numpy(tc))
    got = to_numpy(tl)
    for name, value in _np(jl).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert (tl.ball0 < 66).all() and (tl.target_pos >= 0).all()

    sweeps = 24
    run = jax.jit(jax.vmap(lambda lay: jobs.obstructed_value_iteration(lay, GAMMA, sweeps)))
    jv, jpol = run(jl)
    tv, tpol = tobs.obstructed_value_iteration(tl, GAMMA, sweeps)
    assert (tv > 0).any()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    unique = unique_best(tv, tl)
    assert unique.float().mean() > 0.5
    np.testing.assert_array_equal(tpol[unique].numpy(), np.asarray(jpol)[unique.numpy()])


def test_greedy_realizes_steps_to_go():
    env_id = "MiniGrid-ObstructedMaze-1Dlhb-v0"
    env = port.make(env_id)
    states = from_numpy(EnvState, _np(jax_states(env_id, 1, seed=2)), "cpu")
    layouts = tobs.extract_obstructed_layout(states, 1, states.aux[:, 0], states.aux[:, 1])
    assert layouts.box_idx[0] >= 0 and layouts.ball0[0] < 66  # a key box, a ball
    v, policy = tobs.obstructed_value_iteration(layouts, GAMMA, 80)
    dist = float(tobs.obstructed_steps_to_go(tobs.obstructed_state_value(v, layouts, states), GAMMA)[0])
    assert np.isfinite(dist)
    ls = tlanes.to_lanes(states)
    for t in range(int(dist)):
        act = tobs.obstructed_greedy_action(policy, layouts, tlanes.from_lanes(env.params, ls))
        ls, r, term = tlanes.step_lanes_env(env, ls, act)
        assert bool(term[0]) == (t + 1 == int(dist)), t
    assert float(r[0]) > 0
