"""Lava/Simple Crossing: ``num_crossings`` rivers (lava or wall lines on
even rows and columns), a uniform subset of the candidate lines, then a
zig-zag path opened through them: a shuffled sequence of room-to-room
crossings, each opening one random cell of the next river.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/crossing.py``, with
the same subset draw (a permutation's prefix) and the same room walk, each
written out over the batch.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_RED,
    OBJ_GOAL,
    OBJ_LAVA,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G

MISSION_LAVA = "avoid the lava and get to the green goal square"
MISSION_WALL = "find the opening and get to the green goal square"


def make_crossing(
    env_id: str, size: int = 9, num_crossings: int = 1, obstacle: str = "lava"
) -> Environment:
    assert size % 2 == 1
    params = EnvParams(
        width=size, height=size, max_steps=4 * size * size, see_through_walls=False
    )
    obj, col = (OBJ_LAVA, COLOR_RED) if obstacle == "lava" else (OBJ_WALL, COLOR_GREY)
    mission = MISSION_LAVA if obstacle == "lava" else MISSION_WALL
    # Candidate rivers: vertical at even x, horizontal at even y, in [2, size-2).
    cand = list(range(2, size - 2, 2))
    nc = len(cand)
    k = num_crossings

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b, h, w = batch_size, p.height, p.width
        state = new_state(b, h, w, dev)
        state = G.wall_rect(state, 0, 0, w, h)
        state = G.set_agent(state, 1, 1, 0)
        state = G.put_obj(state, w - 2, h - 2, OBJ_GOAL, COLOR_GREEN)

        # A uniform k-subset of the 2 * nc candidates: a permutation's prefix.
        perm = G.permutation(generator, b, 2 * nc, dev)
        slots = torch.arange(2 * nc, device=dev)
        sel = (slots[None, None, :] == perm[:, :k, None]).any(dim=1)  # (B, 2nc)
        sel_v, sel_h = sel[:, :nc], sel[:, nc:]

        # Paint: a vertical river spans y in [1, H-1), a horizontal one x.
        ys, xs = G.coord_grids(h, w, dev)
        interior_y = (ys >= 1) & (ys < h - 1)
        interior_x = (xs >= 1) & (xs < w - 1)
        river = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
        for i, c in enumerate(cand):
            river |= sel_v[:, i, None, None] & (xs == c) & interior_y
            river |= sel_h[:, i, None, None] & (ys == c) & interior_x
        state = G.paint(state, river, obj, col)

        # Room limits: 0, the selected rivers sorted (unselected sort to the
        # sentinel size-1), size-1.
        pos = G.const(cand, torch.int32, dev)
        edge0 = torch.zeros((b, 1), dtype=torch.int32, device=dev)

        def limits(selected, last):
            inner = torch.where(selected, pos, last).sort(dim=1).values
            return torch.cat([edge0, inner, torch.full_like(edge0, last)], dim=1)

        limits_v = limits(sel_v, w - 1)
        limits_h = limits(sel_h, h - 1)

        # Shuffled crossing order: nv crossings over the vertical rivers
        # (horizontal moves), k - nv over the horizontal ones.
        nv = sel_v.sum(dim=1)
        order = G.permutation(generator, b, k, dev)
        steps = torch.arange(k, device=dev)
        path_is_h = (
            (steps[None, None, :] == order[:, :, None])
            & (steps[None, :, None] < nv[:, None, None])
        ).any(dim=1)  # (B, k)

        # The room walk, one opened cell per crossing.
        room_i = torch.zeros(b, dtype=torch.int64, device=dev)
        room_j = torch.zeros(b, dtype=torch.int64, device=dev)

        def at(lim, i):
            return lim.gather(1, i[:, None])[:, 0]

        for t in range(k):
            is_h = path_is_h[:, t]
            y_rand = G.randint(generator, at(limits_h, room_j) + 1, at(limits_h, room_j + 1), b, dev)
            x_rand = G.randint(generator, at(limits_v, room_i) + 1, at(limits_v, room_i + 1), b, dev)
            open_x = torch.where(is_h, at(limits_v, room_i + 1), x_rand)
            open_y = torch.where(is_h, y_rand, at(limits_h, room_j + 1))
            state = G.clear_cell(state, open_x, open_y)
            room_i = room_i + is_h
            room_j = room_j + ~is_h
        return state

    return Environment(env_id, params, generate, mission_text=lambda c: mission)
