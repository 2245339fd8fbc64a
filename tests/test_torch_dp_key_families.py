"""The port's key-position DP on the families it was written for,
KeyCorridor and ObstructedMaze-1Dl, against the JAX package's: the
layouts (target from aux slots 0-1) equal field by field, and the plain
``key_value_iteration`` within 1e-6 of JAX's, on two JAX-generated layouts
each.  KeyCorridorS3R2 holds up to six doors (C = 64 configs, the
kernel's global route on the card); ObstructedMaze-1Dl is 11 wide and 6
high, the first grid that is not square.  Then the greedy policy, stepped
by the port's ``step_lanes_env`` with the family's hook, picks up the
target in exactly ``key_steps_to_go`` steps, as ``chip_smoke.py`` requires
on the card."""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp import tabular_key as jkey

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

GAMMA = 0.995
CASES = [("MiniGrid-KeyCorridorS3R2-v0", 6), ("MiniGrid-ObstructedMaze-1Dl-v0", 1)]


def _np(tree) -> dict:
    names = tree._fields if hasattr(tree, "_fields") else tree.__dataclass_fields__
    return {n: np.asarray(getattr(tree, n)) for n in names if n != "rng"}


def jax_states(env_id: str, n: int, seed: int):
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)(keys, env.params)


def target_layouts(states: EnvState, max_doors: int) -> tkey.KeyTabularLayout:
    return tkey.extract_key_layout(states, max_doors, states.aux[:, 0], states.aux[:, 1])


@pytest.mark.parametrize("env_id,max_doors", CASES)
def test_layout_and_values_equal_jax(env_id, max_doors):
    js = jax_states(env_id, 2, seed=3)
    ts = from_numpy(EnvState, _np(js), "cpu")
    jl = jax.vmap(lambda s: jkey.extract_key_layout(s, max_doors, s.aux[0], s.aux[1]))(js)
    tl = target_layouts(ts, max_doors)
    got = to_numpy(tl)
    for name, value in _np(jl).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert (tl.target_pos >= 0).all()
    sweeps = 32
    jv, _ = jax.jit(jax.vmap(partial(jkey.key_value_iteration, gamma=GAMMA, n_sweeps=sweeps)))(jl)
    tv, _ = tkey.key_value_iteration(tl, GAMMA, sweeps)
    assert tv.shape[2] == 1 << max_doors and (tv > 0).any()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("env_id,max_doors", CASES)
def test_greedy_realizes_steps_to_go(env_id, max_doors):
    env = port.make(env_id)
    states = from_numpy(EnvState, _np(jax_states(env_id, 4, seed=9)), "cpu")
    layouts = target_layouts(states, max_doors)
    v, policy = tkey.key_value_iteration(layouts, GAMMA, 80)
    dists = tkey.key_steps_to_go(tkey.key_state_value(v, layouts, states), GAMMA)
    assert torch.isfinite(dists).all()
    ls = tlanes.to_lanes(states)
    done = torch.zeros(len(dists), dtype=torch.bool)
    steps = torch.zeros(len(dists))
    for t in range(int(dists.max())):
        act = tkey.key_greedy_action(policy, layouts, tlanes.from_lanes(env.params, ls))
        ls, r, term = tlanes.step_lanes_env(env, ls, act)
        steps = torch.where(term & ~done & (r > 0), float(t + 1), steps)
        done |= term
    assert done.all()
    torch.testing.assert_close(steps, dists, rtol=0, atol=0)
