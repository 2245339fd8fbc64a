"""Helpers of the port's generator tests: layouts from both packages, the
marginals they are compared by, and each family's exact invariants.

The two generators draw from different streams (``torch.Generator``
against threefry), so their layouts agree in distribution only.  Each
marginal is a frequency over N layouts: per cell, how often it holds an
object type, or the agent; per value, how often the agent faces that way,
an object type has that color, or an aux or mission slot holds it.
Normalised, two marginals are compared by total variation (TV).  The
tolerance is ``3 * E0 + 0.02``, where E0 is the mean TV between two
independent samples of N correct layouts, computed from the pooled
frequencies f (with S = sum f): ``E0 = sum(sqrt(f (1 - f) / (pi N))) / S``.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import torch

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_BLUE,
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_RED,
    NUM_OBJECTS,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    STATE_CLOSED,
    STATE_LOCKED,
)

N = 4096


def port_layouts(env_id: str, seed: int, n: int = N) -> dict:
    env = port.make(env_id)
    g = torch.Generator().manual_seed(seed)
    return to_numpy(env.generate(g, env.params, n, device="cpu"))


def jax_layouts(env_id: str, seed: int, n: int = N) -> dict:
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    return {k: np.asarray(getattr(states, k)) for k in states.__dataclass_fields__ if k != "rng"}


def marginals(s: dict) -> dict:
    """Name -> frequencies over the layouts (see the module docstring)."""
    obj = s["grid_obj"]
    n, h, w = obj.shape
    out = {}
    for o in range(NUM_OBJECTS):
        if (obj == o).any():
            out[f"cells of {o}"] = (obj == o).mean(axis=0).ravel()
            if o not in (OBJ_EMPTY, OBJ_WALL):
                out[f"colors of {o}"] = np.bincount(s["grid_color"][obj == o], minlength=6) / n
    cell = s["agent_pos"][:, 1] * w + s["agent_pos"][:, 0]
    out["agent cell"] = np.bincount(cell, minlength=h * w) / n
    out["agent dir"] = np.bincount(s["agent_dir"], minlength=4) / n
    for name in ("aux", "mission"):
        for j in range(8):
            col = s[name][:, j]
            if col.any():
                out[f"{name}[{j}]"] = np.bincount(col, minlength=max(h, w) + 1) / n
    return out


def assert_same_marginals(got: dict, want: dict, n: int = N) -> None:
    a, b = marginals(got), marginals(want)
    assert set(a) == set(b), (sorted(a), sorted(b))
    for name in a:
        k = max(len(a[name]), len(b[name]))
        fa, fb = (np.pad(x, (0, k - len(x))) for x in (a[name], b[name]))
        f = np.clip((fa + fb) / 2, 0, 1)
        s = f.sum()
        e0 = np.sqrt(f * (1 - f) / (math.pi * n)).sum() / s
        tv = 0.5 * np.abs(fa / fa.sum() - fb / fb.sum()).sum()
        assert tv <= 3 * e0 + 0.02, (name, tv, 3 * e0 + 0.02)


# --- exact invariants, per family -------------------------------------------


def _cells(obj: np.ndarray, o: int):
    """(layout, y, x) of each cell holding o, in raster order."""
    return np.argwhere(obj == o)


def _per_layout(obj: np.ndarray, o: int, count: int):
    """(y, x) arrays of shape (N, count): each layout holds o exactly count
    times."""
    hits = _cells(obj, o)
    n = obj.shape[0]
    assert len(hits) == n * count and (hits[:, 0] == np.repeat(np.arange(n), count)).all(), o
    return hits[:, 1].reshape(n, count), hits[:, 2].reshape(n, count)


def common(s: dict, walled: bool = True) -> None:
    """The agent stands on an empty cell facing a direction; the episode is
    fresh; the border is grey wall."""
    obj = s["grid_obj"]
    n, h, w = obj.shape
    ax, ay = s["agent_pos"][:, 0], s["agent_pos"][:, 1]
    assert ((ax >= 0) & (ax < w) & (ay >= 0) & (ay < h)).all()
    assert (obj[np.arange(n), ay, ax] == OBJ_EMPTY).all()
    assert ((s["agent_dir"] >= 0) & (s["agent_dir"] < 4)).all()
    assert (s["step_count"] == 0).all() and not s["terminated"].any()
    assert not s["truncated"].any() and (s["carrying_obj"] == OBJ_EMPTY).all()
    if walled:
        border = np.zeros((h, w), bool)
        border[[0, -1], :] = border[:, [0, -1]] = True
        assert (obj[:, border] == OBJ_WALL).all() and (s["grid_color"][:, border] == COLOR_GREY).all()


def goal_bottom_right(s: dict) -> None:
    obj, color = s["grid_obj"], s["grid_color"]
    _, h, w = obj.shape
    gy, gx = _per_layout(obj, OBJ_GOAL, 1)
    assert (gx == w - 2).all() and (gy == h - 2).all()
    assert (color[:, h - 2, w - 2] == COLOR_GREEN).all()


def agent_fixed(s: dict, x: int = 1, y: int = 1, d: int = 0) -> None:
    assert (s["agent_pos"] == [x, y]).all() and (s["agent_dir"] == d).all()


def reachable(obj: np.ndarray, start, goal, blocked=(OBJ_WALL, OBJ_LAVA)) -> bool:
    """Breadth-first search on one (H, W) grid."""
    h, w = obj.shape
    seen = {tuple(start)}
    frontier = [tuple(start)]
    while frontier:
        x, y = frontier.pop()
        if (x, y) == tuple(goal):
            return True
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < w and 0 <= ny < h and (nx, ny) not in seen and obj[ny, nx] not in blocked:
                seen.add((nx, ny))
                frontier.append((nx, ny))
    return False


def objects_at(s: dict, xs: np.ndarray, ys: np.ndarray):
    """(type, color) of the cells (xs[b], ys[b])."""
    rows = np.arange(len(xs))
    return s["grid_obj"][rows, ys, xs].astype(np.int32), s["grid_color"][rows, ys, xs].astype(np.int32)


def placed_objects(s: dict, k: int):
    """(xs, ys, types, colors), each (N, k): the k objects (keys, balls,
    boxes) of each layout in raster order."""
    obj = s["grid_obj"]
    is_obj = np.isin(obj, (OBJ_KEY, OBJ_BALL, OBJ_BOX))
    hits = np.argwhere(is_obj)
    n = obj.shape[0]
    assert len(hits) == n * k and (hits[:, 0] == np.repeat(np.arange(n), k)).all()
    ys, xs = hits[:, 1].reshape(n, k), hits[:, 2].reshape(n, k)
    rows = np.arange(n)[:, None]
    return xs, ys, obj[rows, ys, xs].astype(np.int32), s["grid_color"][rows, ys, xs].astype(np.int32)


def doors(s: dict, k: int, states=(STATE_CLOSED, STATE_LOCKED)):
    """(xs, ys, colors, states) of the k doors of each layout."""
    ys, xs = _per_layout(s["grid_obj"], OBJ_DOOR, k)
    rows = np.arange(len(xs))[:, None]
    st = s["grid_state"][rows, ys, xs]
    assert np.isin(st, states).all()
    return xs, ys, s["grid_color"][rows, ys, xs].astype(np.int32), st


__all__ = [
    "N", "port_layouts", "jax_layouts", "assert_same_marginals", "common",
    "goal_bottom_right", "agent_fixed", "reachable", "objects_at", "placed_objects",
    "doors", "COLOR_BLUE", "COLOR_RED", "OBJ_BALL", "OBJ_LAVA", "OBJ_GOAL", "OBJ_KEY",
    "OBJ_WALL", "STATE_LOCKED",
]
