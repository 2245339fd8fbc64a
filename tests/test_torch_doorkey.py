"""The port's DoorKey generator: layout invariants, and the draws held
against the JAX generator's by distribution.

The two generators draw from different random streams (``torch.Generator``
against threefry), so their layouts agree only in distribution.  The
two-sample chi-square test of each histogram must give a p-value above
1e-3: with at most ten histograms, a correct generator fails one of them
about once in a hundred seeds, and the seeds below are fixed.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_YELLOW,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_WALL,
    STATE_LOCKED,
)

torch.set_num_threads(1)

N = 2048
P_FLOOR = 1e-3  # chi-square p-value each histogram must exceed


def _port_layouts(env_id: str, seed: int) -> dict:
    env = port.make(env_id)
    g = torch.Generator().manual_seed(seed)
    return to_numpy(env.generate(g, env.params, N, device="cpu"))


def _jax_layouts(env_id: str, seed: int) -> dict:
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    return {n: np.asarray(getattr(states, n)) for n in ("grid_obj", "agent_pos", "agent_dir")}


def _draws(s: dict) -> dict:
    """split column, door row, agent direction, agent column, key column."""
    door = np.argwhere(s["grid_obj"] == OBJ_DOOR)  # the door is on the split
    key = np.argwhere(s["grid_obj"] == OBJ_KEY)
    return {
        "split": door[:, 2],
        "door_row": door[:, 1],
        "agent_dir": s["agent_dir"],
        "agent_x": s["agent_pos"][:, 0],
        "key_x": key[:, 2],
    }


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-DoorKey-8x8-v0"])
def test_layout_invariants(env_id):
    s = _port_layouts(env_id, seed=1)
    obj, color, st = s["grid_obj"], s["grid_color"], s["grid_state"]
    b, h, w = obj.shape
    rows = np.arange(b)
    border = np.zeros((h, w), bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    assert (obj[:, border] == OBJ_WALL).all() and (color[:, border] == COLOR_GREY).all()

    # Exactly one locked yellow door, on a split column that is wall elsewhere.
    doors = np.argwhere(obj == OBJ_DOOR)
    assert len(doors) == b and (doors[:, 0] == rows).all()
    split, door_row = doors[:, 2], doors[:, 1]
    assert ((split >= 2) & (split < w - 2)).all()
    assert ((door_row >= 1) & (door_row < w - 2)).all()
    assert (color[rows, door_row, split] == COLOR_YELLOW).all()
    assert (st[rows, door_row, split] == STATE_LOCKED).all()
    column = obj[rows, :, split]  # (B, H)
    assert ((column == OBJ_WALL) | (np.arange(h) == door_row[:, None])).all()

    # One yellow key and the agent, both left of the wall, on distinct cells.
    keys = np.argwhere(obj == OBJ_KEY)
    assert len(keys) == b and (keys[:, 0] == rows).all()
    assert ((keys[:, 2] >= 1) & (keys[:, 2] < split)).all()
    assert (color[rows, keys[:, 1], keys[:, 2]] == COLOR_YELLOW).all()
    ax, ay = s["agent_pos"][:, 0], s["agent_pos"][:, 1]
    assert ((ax >= 1) & (ax < split) & (ay >= 1) & (ay < h - 1)).all()
    assert (obj[rows, ay, ax] == OBJ_EMPTY).all()
    assert ((s["agent_dir"] >= 0) & (s["agent_dir"] < 4)).all()

    # The goal bottom-right; every other cell empty.
    assert (obj[:, h - 2, w - 2] == OBJ_GOAL).all() and (color[:, h - 2, w - 2] == COLOR_GREEN).all()
    counts = np.stack([(obj == o).sum(axis=(1, 2)) for o in (OBJ_DOOR, OBJ_KEY, OBJ_GOAL)])
    assert (counts == 1).all()
    others = ~np.isin(obj, (OBJ_WALL, OBJ_DOOR, OBJ_KEY, OBJ_GOAL))
    assert (obj[others] == OBJ_EMPTY).all()
    assert (s["step_count"] == 0).all() and not s["terminated"].any()


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-DoorKey-8x8-v0"])
def test_draws_match_jax_in_distribution(env_id):
    got, want = _draws(_port_layouts(env_id, seed=2)), _draws(_jax_layouts(env_id, seed=2))
    for name in got:
        values = np.union1d(got[name], want[name])
        table = np.stack([(got[name][:, None] == values).sum(0), (want[name][:, None] == values).sum(0)])
        if len(values) == 1:
            continue  # one value on both sides: nothing to test
        p = stats.chi2_contingency(table).pvalue
        assert p > P_FLOOR, (name, table.tolist(), p)
