"""MultiRoom's pooled generator: the port's ``generate`` against JAX's
``generate_batch`` (the counterpart of ``tests/test_generate_batch.py``).

The laws, by two-sample chi-square at N layouts: the number of doors (one
fewer than the rooms chained), the cells inside rooms (the room sizes),
the wall cells, the door colors and the agent's cell.  Then, on the port's
layouts at n = 4096 for every id: the attempts that chained every room
number at least n (the margin never falls short, so no layout repeats),
every layout has all its rooms, and the goal lies in reach of the agent
once doors open.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_WALL,
)

from ._torch_generators import common
from .test_torch_roomgrid_generators import chi2_same, reach

torch.set_num_threads(1)

N = 2048
ROOMS = {"MiniGrid-MultiRoom-N2-S4-v0": 2, "MiniGrid-MultiRoom-N4-S5-v0": 6, "MiniGrid-MultiRoom-N6-v0": 6}


def laws(s: dict) -> dict:
    obj = s["grid_obj"]
    n, h, w = obj.shape
    inside = np.isin(obj, (OBJ_EMPTY, OBJ_GOAL)) & (reach(s))
    return {
        "doors": np.bincount((obj == OBJ_DOOR).sum(axis=(1, 2)), minlength=8),
        "cells inside rooms": np.bincount(inside.sum(axis=(1, 2)), minlength=h * w),
        "wall cells": np.bincount((obj == OBJ_WALL).sum(axis=(1, 2)), minlength=h * w),
        "door colors": np.bincount(s["grid_color"][obj == OBJ_DOOR], minlength=6),
        "agent cell": np.bincount(s["agent_pos"][:, 1] * w + s["agent_pos"][:, 0], minlength=h * w),
    }


@pytest.mark.parametrize("env_id", ["MiniGrid-MultiRoom-N2-S4-v0", "MiniGrid-MultiRoom-N6-v0"])
def test_pooled_law_equals_jax_generate_batch(env_id):
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    jstates = jax.jit(jenv.generate_batch, static_argnums=(1, 2))(jax.random.PRNGKey(1), jenv.params, N)
    want = {k: np.asarray(getattr(jstates, k)) for k in jstates.__dataclass_fields__ if k != "rng"}
    got = to_numpy(tenv.generate(torch.Generator().manual_seed(1), tenv.params, N, device="cpu"))
    a, b = laws(got), laws(want)
    for name in a:
        chi2_same(a[name], b[name], f"{env_id}: {name}")


@pytest.mark.parametrize("env_id", sorted(ROOMS))
def test_margin_never_falls_short(env_id):
    env = port.make(env_id)
    n = 4096
    states, accepted = env.generate(
        torch.Generator().manual_seed(3), env.params, n, device="cpu", return_accepted=True
    )
    assert int(accepted) >= n, (env_id, int(accepted))
    s = to_numpy(states)
    common(s, walled=False)
    obj = s["grid_obj"]
    assert ((obj == OBJ_DOOR).sum(axis=(1, 2)) == ROOMS[env_id] - 1).all()
    goal = obj == OBJ_GOAL
    assert (goal.sum(axis=(1, 2)) == 1).all()
    assert (reach(s) & goal).any(axis=(1, 2)).all()
