"""The port's generators of the families with hooks: each family's exact
invariants on N port layouts (the targets and missions the hooks read
name what the layout holds), and the layouts' marginals against N JAX
layouts at the TV tolerance of ``_torch_generators``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ._torch_generators import (
    COLOR_BLUE,
    COLOR_RED,
    OBJ_BALL,
    OBJ_KEY,
    agent_fixed,
    assert_same_marginals,
    common,
    doors,
    goal_bottom_right,
    jax_layouts,
    objects_at,
    placed_objects,
    port_layouts,
)

torch.set_num_threads(1)


def _gotodoor(s, env_id):
    xs, ys, colors, _ = doors(s, 4, states=(1,))  # four closed doors
    assert all(len(set(c)) == 4 for c in colors.tolist())
    tx, ty = s["aux"][:, 0], s["aux"][:, 1]
    hit = (xs == tx[:, None]) & (ys == ty[:, None])
    assert (hit.sum(1) == 1).all()
    assert (colors[hit] == s["mission"][:, 0]).all()


def _gotoobject(s, env_id):
    k = 2
    xs, ys, types, colors = placed_objects(s, k)
    assert all(len(set(zip(t, c))) == k for t, c in zip(types.tolist(), colors.tolist()))
    t, c = objects_at(s, s["aux"][:, 0], s["aux"][:, 1])
    assert (c == s["mission"][:, 0]).all() and (t == s["mission"][:, 1]).all()


def _fetch(s, env_id):
    k = 3 if "N3" in env_id else 2
    _, _, types, colors = placed_objects(s, k)
    assert np.isin(types, (OBJ_KEY, OBJ_BALL)).all()
    syntax, color, kind = s["mission"][:, 0], s["mission"][:, 1], s["mission"][:, 2]
    assert ((syntax >= 0) & (syntax < 5)).all()
    assert ((types == kind[:, None]) & (colors == color[:, None])).any(axis=1).all()
    assert (s["aux"][:, 0] == kind).all() and (s["aux"][:, 1] == color).all()


def _putnear(s, env_id):
    k = 3 if "N3" in env_id else 2
    xs, ys, types, colors = placed_objects(s, k)
    assert all(len(set(zip(t, c))) == k for t, c in zip(types.tolist(), colors.tolist()))
    for i in range(k):
        for j in range(i):
            assert (np.maximum(abs(xs[:, i] - xs[:, j]), abs(ys[:, i] - ys[:, j])) > 1).all()
    aux, m = s["aux"], s["mission"]
    t, c = objects_at(s, aux[:, 2], aux[:, 3])
    assert (c == m[:, 2]).all() and (t == m[:, 3]).all()
    assert (aux[:, 0] == m[:, 1]).all() and (aux[:, 1] == m[:, 0]).all()
    move = (types == aux[:, 0, None]) & (colors == aux[:, 1, None])
    assert (move.sum(1) == 1).all()
    target = (xs == aux[:, 2, None]) & (ys == aux[:, 3, None])
    assert not (move & target).any()


def _redbluedoors(s, env_id):
    size = s["grid_obj"].shape[1]
    xs, ys, colors, _ = doors(s, 2, states=(1,))
    red, blue = colors == COLOR_RED, colors == COLOR_BLUE
    assert (red.sum(1) == 1).all() and (blue.sum(1) == 1).all()
    assert (xs[red] == size // 2).all() and (xs[blue] == size // 2 + size - 1).all()
    np.testing.assert_array_equal(s["aux"][:, :4], np.stack([xs[red], ys[red], xs[blue], ys[blue]], 1))
    ax = s["agent_pos"][:, 0]
    assert ((ax > size // 2) & (ax < size // 2 + size - 1)).all()


def _memory(s, env_id):
    obj, color = s["grid_obj"], s["grid_color"]
    n, h, w = obj.shape
    mid, rows = h // 2, np.arange(n)
    start = obj[:, mid - 1, 1]
    assert np.isin(start, (OBJ_KEY, OBJ_BALL)).all() and (color[:, mid - 1, 1] == 1).all()
    sx = s["aux"][:, 0]
    up, down = obj[rows, mid - 2, sx], obj[rows, mid + 2, sx]
    assert np.isin(up, (OBJ_KEY, OBJ_BALL)).all() and (up != down).all()
    match_y = np.where(up == start, mid - 1, mid + 1)
    assert (s["aux"][:, 1] == match_y).all() and (s["aux"][:, 2] == sx).all()
    assert (s["aux"][:, 3] == 2 * mid - match_y).all()
    assert (s["agent_pos"][:, 1] == mid).all() and (s["agent_pos"][:, 0] < sx).all()


def _dynamicobstacles(s, env_id):
    goal_bottom_right(s)
    if "Random" not in env_id:
        agent_fixed(s)
    obj = s["grid_obj"]
    n = obj.shape[0]
    n_obs = 3 if "6x6" in env_id else 4
    balls = obj == OBJ_BALL
    assert (balls.sum(axis=(1, 2)) == n_obs).all()
    assert (s["grid_color"][balls] == COLOR_BLUE).all()
    for i in range(n_obs):
        assert balls[np.arange(n), s["aux"][:, 2 * i + 1], s["aux"][:, 2 * i]].all()
    cells = s["aux"][:, 1:2 * n_obs:2] * 100 + s["aux"][:, 0:2 * n_obs:2]
    assert all(len(set(c)) == n_obs for c in cells.tolist())


INVARIANTS = {
    "MiniGrid-GoToDoor-8x8-v0": _gotodoor,
    "MiniGrid-GoToObject-8x8-N2-v0": _gotoobject,
    "MiniGrid-Fetch-8x8-N3-v0": _fetch,
    "MiniGrid-PutNear-8x8-N3-v0": _putnear,
    "MiniGrid-RedBlueDoors-6x6-v0": _redbluedoors,
    "MiniGrid-MemoryS13Random-v0": _memory,
    "MiniGrid-Dynamic-Obstacles-8x8-v0": _dynamicobstacles,
    "MiniGrid-Dynamic-Obstacles-Random-6x6-v0": _dynamicobstacles,
}


@pytest.mark.parametrize("env_id", sorted(INVARIANTS))
def test_invariants_and_marginals(env_id):
    got = port_layouts(env_id, seed=1)
    # GoToDoor's room may be smaller than the grid: only its own walls.
    common(got, walled="GoToDoor" not in env_id)
    INVARIANTS[env_id](got, env_id)
    assert_same_marginals(got, jax_layouts(env_id, seed=2))
