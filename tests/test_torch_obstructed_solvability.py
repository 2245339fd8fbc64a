"""ObstructedMaze solvability on the port's layouts: the check of
``tests/test_obstructed_solvability.py`` (the blue ball's room must have a
door whose key survives inside a box).  Over 2048 mazes of each -v1 id the
port buries no key.  The -v0 generator keeps the reference's flaw (a later
blocking ball overwrites a key's box): on 2Dlhb-v0 the port's rate must lie
within four binomial standard deviations of the JAX generator's own rate,
measured here on as many mazes."""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_BLUE,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
)

torch.set_num_threads(1)

TOTAL = 2048
ROOM_PITCH = 5


def buried(s: dict) -> np.ndarray:
    """(N,) bool: no door of the blue ball's room has its key in a box."""
    go, gc, co, cc = (s[k] for k in ("grid_obj", "grid_color", "contains_obj", "contains_color"))
    out = np.zeros(len(go), dtype=bool)
    for b in range(len(go)):
        by, bx = np.argwhere((go[b] == OBJ_BALL) & (gc[b] == COLOR_BLUE))[0]
        top_x, top_y = (bx // ROOM_PITCH) * ROOM_PITCH, (by // ROOM_PITCH) * ROOM_PITCH
        room = go[b][top_y:top_y + 6, top_x:top_x + 6]
        door_colors = gc[b][top_y:top_y + 6, top_x:top_x + 6][room == OBJ_DOOR]
        boxed = cc[b][(go[b] == OBJ_BOX) & (co[b] == OBJ_KEY)]
        out[b] = not any(c in boxed for c in door_colors)
    return out


def port_rate(env_id: str) -> float:
    env = port.make(env_id)
    s = to_numpy(env.generate(torch.Generator().manual_seed(123), env.params, TOTAL, device="cpu"))
    return float(buried(s).mean())


@pytest.mark.parametrize("env_id", [
    "MiniGrid-ObstructedMaze-2Dlhb-v1",
    "MiniGrid-ObstructedMaze-1Q-v1",
    "MiniGrid-ObstructedMaze-2Q-v1",
    "MiniGrid-ObstructedMaze-Full-v1",
])
def test_v1_never_buries_a_key(env_id):
    assert port_rate(env_id) == 0.0


def test_v0_buries_at_the_jax_rate():
    env_id = "MiniGrid-ObstructedMaze-2Dlhb-v0"
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(123), TOTAL)
    js = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)(keys, env.params)
    want = float(buried({k: np.asarray(getattr(js, k)) for k in
                         ("grid_obj", "grid_color", "contains_obj", "contains_color")}).mean())
    got = port_rate(env_id)
    p = (got + want) / 2
    sigma = math.sqrt(p * (1 - p) * 2 / TOTAL)
    assert 0.03 < want < 0.15, want  # JAX's own rate, as its test measures it
    assert abs(got - want) <= 4 * sigma, (got, want, sigma)
