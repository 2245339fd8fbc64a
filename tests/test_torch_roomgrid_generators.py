"""The port's generators of the RoomGrid families and Playground against the
JAX package's: their laws by two-sample chi-square on marginals, at N
layouts each, and their exact invariants on every port layout.

Marginals: the agent's cell and direction; where doors stand and their
colors; the target's kind and color (aux slots 0-1); for KeyCorridor the
row of the locked room.  Invariants: the wall lattice (a RoomGrid cell on
the lattice is wall or door, but for KeyCorridor's corridor); every room
reachable from the agent once doors open and objects step aside (in
ObstructedMaze, whose unused rooms have no door, the target's room); each
locked door's key (bare, or in a box) of the door's color, where the
family guarantees one.  MultiRoom's laws are held in
``test_torch_multiroom.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
    OBJ_WALL,
    STATE_LOCKED,
)

from ._torch_generators import common, jax_layouts, port_layouts

torch.set_num_threads(1)

N = 2048


def chi2_same(a: np.ndarray, b: np.ndarray, what: str) -> None:
    """Two-sample chi-square of two count histograms of equal totals; bins
    with fewer than 10 counts in both samples together are pooled.  Fails
    above the 99.9% quantile of chi2(dof), about dof + 3.29 sqrt(2 dof) + 5
    (as ``tests/test_generate_batch.py``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    small = (a + b) < 10
    a = np.append(a[~small], a[small].sum())
    b = np.append(b[~small], b[small].sum())
    keep = (a + b) > 0
    a, b = a[keep], b[keep]
    chi2 = ((a - b) ** 2 / (a + b)).sum()
    dof = max(len(a) - 1, 1)
    assert chi2 < dof + 3.29 * np.sqrt(2 * dof) + 5, (what, chi2, dof)


def marginals(s: dict, env_id: str) -> dict:
    obj = s["grid_obj"]
    n, h, w = obj.shape
    out = {
        "agent cell": np.bincount(s["agent_pos"][:, 1] * w + s["agent_pos"][:, 0], minlength=h * w),
        "agent dir": np.bincount(s["agent_dir"], minlength=4),
        "door cells": (obj == OBJ_DOOR).sum(axis=0).ravel(),
        "door colors": np.bincount(s["grid_color"][obj == OBJ_DOOR], minlength=6),
        "doors per layout": np.bincount((obj == OBJ_DOOR).sum(axis=(1, 2)), minlength=13),
        "target kind": np.bincount(s["aux"][:, 0], minlength=11),
        "target color": np.bincount(s["aux"][:, 1], minlength=11),
    }
    if "KeyCorridor" in env_id:
        locked = np.argwhere(s["grid_state"] == STATE_LOCKED)
        assert len(locked) == n and (locked[:, 0] == np.arange(n)).all()
        pitch = int(env_id.split("S")[1].split("R")[0]) - 1
        out["locked room row"] = np.bincount(locked[:, 1] // pitch, minlength=3)
    return out


def reach(s: dict) -> np.ndarray:
    """(N, H, W) bool: the cells reachable from the agent, doors open and
    objects stepped aside (a flood fill over the batch)."""
    free = s["grid_obj"] != OBJ_WALL
    n = len(free)
    reach = np.zeros_like(free)
    reach[np.arange(n), s["agent_pos"][:, 1], s["agent_pos"][:, 0]] = True
    while True:
        grown = reach.copy()
        grown[:, 1:] |= reach[:, :-1]
        grown[:, :-1] |= reach[:, 1:]
        grown[:, :, 1:] |= reach[:, :, :-1]
        grown[:, :, :-1] |= reach[:, :, 1:]
        grown &= free
        if (grown == reach).all():
            return reach
        reach = grown


def reach_all(s: dict) -> np.ndarray:
    """(N,) bool: every cell but walls is reachable from the agent."""
    return (reach(s) == (s["grid_obj"] != OBJ_WALL)).all(axis=(1, 2))


def lattice(s: dict, room_size: int, corridor_rows: int = 0) -> None:
    """Every lattice cell is wall or door; KeyCorridor's merged middle
    column (rows 1..corridor_rows-1 of column 1) has no wall inside."""
    obj = s["grid_obj"]
    _, h, w = obj.shape
    pitch = room_size - 1
    ys, xs = np.mgrid[0:h, 0:w]
    on = (xs % pitch == 0) | (ys % pitch == 0)
    opened = np.zeros_like(on)
    for j in range(1, corridor_rows):
        opened |= (ys == j * pitch) & (xs > pitch) & (xs < 2 * pitch)
    assert np.isin(obj[:, on & ~opened], (OBJ_WALL, OBJ_DOOR)).all()
    assert (obj[:, opened] != OBJ_WALL).all()


def keys_match_locked_doors(s: dict) -> None:
    """For each locked door, a key of its color lies bare or in a box."""
    obj, color = s["grid_obj"], s["grid_color"]
    for b in range(len(obj)):
        locked = color[b][(obj[b] == OBJ_DOOR) & (s["grid_state"][b] == STATE_LOCKED)]
        keys = set(color[b][obj[b] == OBJ_KEY]) | set(
            s["contains_color"][b][(obj[b] == OBJ_BOX) & (s["contains_obj"][b] == OBJ_KEY)]
        )
        assert set(locked) <= keys, b


def _keycorridor(s, env_id):
    size, rows = (int(v) for v in env_id.split("S")[1].split("-")[0].split("R"))
    lattice(s, size, corridor_rows=rows)
    assert ((s["grid_state"] == STATE_LOCKED).sum(axis=(1, 2)) == 1).all()
    keys_match_locked_doors(s)
    # The target, named by aux, lies in the locked room's column.
    t = np.argwhere((s["grid_obj"] == s["aux"][:, 0, None, None])
                    & (s["grid_color"] == s["aux"][:, 1, None, None]))
    assert (t[:, 2] > 2 * (size - 1)).all()


def _unlock(s, env_id):
    lattice(s, 6)
    keys_match_locked_doors(s)
    obj, st = s["grid_obj"], s["grid_state"]
    n = len(obj)
    doors = np.argwhere(obj == OBJ_DOOR)
    assert len(doors) == n and (st[doors[:, 0], doors[:, 1], doors[:, 2]] == STATE_LOCKED).all()
    assert (doors[:, 2] == 5).all() and (s["agent_pos"][:, 0] < 5).all()
    if env_id == "MiniGrid-Unlock-v0":
        np.testing.assert_array_equal(s["aux"][:, :2], doors[:, [2, 1]])
    else:
        box = np.argwhere(obj == OBJ_BOX)
        assert len(box) == n and (box[:, 2] > 5).all()
        np.testing.assert_array_equal(s["aux"][:, 1], s["grid_color"][box[:, 0], box[:, 1], box[:, 2]])
        np.testing.assert_array_equal(s["mission"][:, 0], s["aux"][:, 1])
    if "Blocked" in env_id:  # the ball right left of the door
        assert (obj[doors[:, 0], doors[:, 1], 4] == 6).all()


def _obstructed(s, env_id):
    lattice(s, 6)
    # v0 may bury a key under a later blocking ball (the reference's flaw);
    # the 1D variants and v1 never do.
    if "-v1" in env_id or "1Dl" in env_id:
        keys_match_locked_doors(s)
    blue_balls = (s["grid_obj"] == 6) & (s["grid_color"] == 2)
    assert (blue_balls.sum(axis=(1, 2)) == 1).all()
    # Rooms no door leads to stay closed off; the target's room never is.
    assert (reach(s) & blue_balls).any(axis=(1, 2)).all()


def _playground(s, env_id):
    obj = s["grid_obj"]
    assert ((obj == OBJ_DOOR).sum(axis=(1, 2)) == 12).all()
    assert (np.isin(obj, (5, 6, 7)).sum(axis=(1, 2)) == 12).all()


INVARIANTS = {
    "MiniGrid-KeyCorridorS3R2-v0": _keycorridor,
    "MiniGrid-KeyCorridorS6R3-v0": _keycorridor,
    "MiniGrid-Unlock-v0": _unlock,
    "MiniGrid-UnlockPickup-v0": _unlock,
    "MiniGrid-BlockedUnlockPickup-v0": _unlock,
    "MiniGrid-ObstructedMaze-1Dlhb-v0": _obstructed,
    "MiniGrid-ObstructedMaze-2Q-v1": _obstructed,
    "MiniGrid-ObstructedMaze-Full-v0": _obstructed,
    "MiniGrid-Playground-v0": _playground,
}


@pytest.mark.parametrize("env_id", sorted(INVARIANTS))
def test_invariants_and_chi_square(env_id):
    got = port_layouts(env_id, seed=1, n=N)
    common(got)
    assert "ObstructedMaze" in env_id or reach_all(got).all()
    INVARIANTS[env_id](got, env_id)
    want = jax_layouts(env_id, seed=2, n=N)
    a, b = marginals(got, env_id), marginals(want, env_id)
    for name in a:
        chi2_same(a[name], b[name], f"{env_id}: {name}")


def test_chi_square_tells_laws_apart():
    """The statistic is strong enough at N to see a wrong law: a color law
    that moves a sixth of one color's mass to another fails."""
    rng = np.random.default_rng(0)
    fair = np.bincount(rng.integers(0, 6, N), minlength=6)
    skew = np.bincount(np.minimum(rng.integers(0, 7, N), 5), minlength=6)
    chi2_same(fair, np.bincount(rng.integers(0, 6, N), minlength=6), "fair")
    with pytest.raises(AssertionError):
        chi2_same(fair, skew, "skewed")
