"""The port's generators of the hook-free families: each family's exact
invariants on N port layouts, and the layouts' marginals against N JAX
layouts at the TV tolerance of ``_torch_generators`` (per-cell object and
agent marginals, the agent's direction, object colors, aux and mission
slots).  DistShift draws nothing, so its layouts must equal JAX's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ._torch_generators import (
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    STATE_LOCKED,
    agent_fixed,
    assert_same_marginals,
    common,
    doors,
    goal_bottom_right,
    jax_layouts,
    port_layouts,
    reachable,
)

torch.set_num_threads(1)


def _empty(s, env_id):
    goal_bottom_right(s)
    if "Random" not in env_id:
        agent_fixed(s)
    obj = s["grid_obj"]
    assert np.isin(obj, (1, OBJ_WALL, OBJ_GOAL)).all()


def _fourrooms(s, env_id):
    obj = s["grid_obj"]
    n, h, w = obj.shape
    assert (obj == OBJ_GOAL).sum(axis=(1, 2)).tolist() == [1] * n
    # The inner walls: one gap in each of the four segments.
    col, row = obj[:, :, w // 2] == OBJ_WALL, obj[:, h // 2, :] == OBJ_WALL
    for seg in (col[:, 1:h // 2], col[:, h // 2 + 1:-1], row[:, 1:w // 2], row[:, w // 2 + 1:-1]):
        assert ((~seg).sum(axis=1) == 1).all()
    assert col[:, h // 2].all()


def _crossing(s, env_id):
    goal_bottom_right(s)
    agent_fixed(s)
    obj = s["grid_obj"]
    n, h, w = obj.shape
    k = int(env_id.split("N")[-1].split("-")[0])
    river = OBJ_LAVA if "Lava" in env_id else OBJ_WALL
    inner = obj[:, 1:-1, 1:-1] == river  # (N, H-2, W-2)
    # A river is a candidate line (even, in [2, size-2)) with one opening,
    # never where two rivers cross; every obstacle lies on a river.
    cand = np.arange(2, w - 2, 2) - 1
    v = inner[:, :, cand].sum(axis=1) == h - 3  # (N, lines)
    hz = inner[:, cand, :].sum(axis=2) == w - 3
    assert (v.sum(1) + hz.sum(1) == k).all()
    on_river = np.zeros_like(inner)
    for i, c in enumerate(cand):
        on_river[:, :, c] |= v[:, i, None]
        on_river[:, c, :] |= hz[:, i, None]
    assert not (inner & ~on_river).any()
    for b in range(0, n, 97):
        assert reachable(obj[b], (1, 1), (w - 2, h - 2), blocked=(OBJ_WALL, OBJ_LAVA))


def _lavagap(s, env_id):
    goal_bottom_right(s)
    agent_fixed(s)
    obj = s["grid_obj"]
    n, h, w = obj.shape
    lava = np.argwhere(obj == OBJ_LAVA)
    assert len(lava) == n * (h - 3)
    cols = lava[:, 2].reshape(n, h - 3)
    assert (cols == cols[:, :1]).all() and ((cols[:, 0] >= 2) & (cols[:, 0] < w - 2)).all()


def _lockedroom(s, env_id):
    obj = s["grid_obj"]
    n, h, w = obj.shape
    xs, ys, colors, st = doors(s, 6)
    assert all(len(set(c)) == 6 for c in colors.tolist())
    locked = st == STATE_LOCKED
    assert (locked.sum(1) == 1).all()
    locked_color = colors[locked]
    key = np.argwhere(obj == OBJ_KEY)
    assert len(key) == n
    assert (s["grid_color"][key[:, 0], key[:, 1], key[:, 2]] == locked_color).all()
    goal = np.argwhere(obj == OBJ_GOAL)
    assert len(goal) == n
    # The goal behind the locked door: same side of the hallway, same band.
    lx, ly = xs[locked], ys[locked]
    left = lx < w // 2
    assert ((goal[:, 2] < w // 2 - 2) == left).all()
    assert (np.abs(goal[:, 1] - ly) <= 3).all()
    # The key in another room.
    same = ((key[:, 2] < w // 2) == left) & (np.abs(key[:, 1] - ly) <= 3)
    assert not same.any()
    ax = s["agent_pos"][:, 0]
    assert ((ax >= w // 2 - 2) & (ax < w // 2 + 2)).all()
    assert (s["mission"][:, 0] == locked_color).all()


INVARIANTS = {
    "MiniGrid-Empty-8x8-v0": _empty,
    "MiniGrid-Empty-Random-6x6-v0": _empty,
    "MiniGrid-FourRooms-v0": _fourrooms,
    "MiniGrid-LavaCrossingS9N2-v0": _crossing,
    "MiniGrid-SimpleCrossingS11N5-v0": _crossing,
    "MiniGrid-LavaGapS7-v0": _lavagap,
    "MiniGrid-LockedRoom-v0": _lockedroom,
}


@pytest.mark.parametrize("env_id", sorted(INVARIANTS))
def test_invariants_and_marginals(env_id):
    got = port_layouts(env_id, seed=1)
    common(got)
    INVARIANTS[env_id](got, env_id)
    assert_same_marginals(got, jax_layouts(env_id, seed=2))


@pytest.mark.parametrize("env_id", ["MiniGrid-DistShift1-v0", "MiniGrid-DistShift2-v0"])
def test_distshift_equals_jax(env_id):
    got, want = port_layouts(env_id, seed=1, n=4), jax_layouts(env_id, seed=2, n=4)
    common(got)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
