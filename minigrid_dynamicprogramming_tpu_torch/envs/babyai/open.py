"""BabyAI Open levels (the reference's ``envs/babyai/open.py``).

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/open.py``.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import COLOR_RED, OBJ_DOOR
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import (
    accept_all,
    make_level,
    objs_reachable,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg

_OPEN = B.single_profile("open")
_CIDX = {"red": 0, "green": 1, "blue": 2, "purple": 3, "yellow": 4, "grey": 5}


def _open_codes(state, color, strict=0, loc=B.LOC_NONE):
    return B.single_codes(state, B.KIND_OPEN, OBJ_DOOR, color, strict=strict, loc=loc)


def rand_color_subset(generator, b: int, n: int, device) -> torch.Tensor:
    """``_rand_subset(COLOR_NAMES, n)`` (minigrid_env.py:276-293): the first
    n of a uniform permutation of the six colors, (B, n) int32."""
    return G.permutation(generator, b, 6, device)[:, :n].to(torch.int32)


def _pick_door_edge(generator, ctx):
    """A uniform (room, slot) door entry, (x, y) each (B,): a door between
    two rooms is listed by both, so it weighs double, as in the
    reference's doors list (open.py:39-47)."""
    b = ctx.edge.shape[0]
    has_door = (ctx.edge == rg.EDGE_DOOR).reshape(b, 1, -1)
    idx, _, _ = G.sample_mask_pos(generator, has_door)
    idx = idx.long()[:, None]
    return ctx.door_x.reshape(b, -1).gather(1, idx)[:, 0], ctx.door_y.reshape(b, -1).gather(
        1, idx
    )[:, 0]


def make_open(env_id: str, room_size: int = 8, num_rows: int = 3, num_cols: int = 3) -> Environment:
    """open.py Open: open a uniform door of a connected maze."""

    def gen(generator, p, state, ctx):
        b = state.grid_obj.shape[0]
        state = rg.place_agent(generator, state, room_size, rows=num_rows, cols=num_cols)
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        state, ctx, _, _, _ = rg.add_distractors(
            generator, state, ctx, room_size, num_rows, num_cols,
            num_distractors=18, all_unique=False,
        )
        ok = objs_reachable(state)
        x, y = _pick_door_edge(generator, ctx)
        flat = (y * p.width + x).long()[:, None]
        color = state.grid_color.reshape(b, -1).gather(1, flat)[:, 0].to(torch.int32)
        return state, _open_codes(state, color), ok

    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=_OPEN)


def make_open_red_door(env_id: str) -> Environment:
    """open.py OpenRedDoor: two rooms of size 5, a red door between."""
    room_size = 5

    def gen(generator, p, state, ctx):
        state, ctx, _, _, _ = rg.add_door(
            generator, state, ctx, 0, 0, door_idx=0, color=COLOR_RED, locked=False
        )
        state = rg.place_agent(generator, state, room_size, i=0, j=0, rows=1, cols=2)
        return state, _open_codes(state, COLOR_RED), accept_all(state)

    return make_level(env_id, gen, room_size, 1, 2, instr_profile=_OPEN)


def make_open_door(env_id: str, debug: bool = False, select_by=None) -> Environment:
    """open.py OpenDoor: four doors of distinct colors on the centre room;
    the target named by color or by location."""
    room_size = 8

    def gen(generator, p, state, ctx):
        b, dev = state.grid_obj.shape[0], state.grid_obj.device
        colors = rand_color_subset(generator, b, 4, dev)
        for i in range(4):
            state, ctx, _, _, _ = rg.add_door(
                generator, state, ctx, 1, 1, door_idx=i, color=colors[:, i], locked=False
            )
        if select_by is None:
            by_color = G.randint(generator, 0, 2, b, dev) == 0
        else:
            by_color = torch.full((b,), select_by == "color", device=dev)
        loc = G.randint(generator, 1, 5, b, dev)  # LOC_LEFT..LOC_BEHIND
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        codes = torch.where(
            by_color[:, None],
            _open_codes(state, colors[:, 0], strict=int(debug)),
            _open_codes(state, B.COLOR_ANY, strict=int(debug), loc=loc),
        )
        return state, codes, accept_all(state)

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=_OPEN)


def make_open_two_doors(
    env_id: str, first_color=None, second_color=None, strict: bool = False
) -> Environment:
    """open.py OpenTwoDoors: open the left door, then the right one."""
    room_size = 6

    def gen(generator, p, state, ctx):
        b, dev = state.grid_obj.shape[0], state.grid_obj.device
        colors = rand_color_subset(generator, b, 2, dev)
        c1 = _CIDX[first_color] if first_color else colors[:, 0]
        c2 = _CIDX[second_color] if second_color else colors[:, 1]
        state, ctx, _, _, _ = rg.add_door(
            generator, state, ctx, 1, 1, door_idx=2, color=c1, locked=False
        )
        state, ctx, _, _, _ = rg.add_door(
            generator, state, ctx, 1, 1, door_idx=0, color=c2, locked=False
        )
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        codes = B.instr_codes(
            b, dev, B.COMB_BEFORE,
            B.clause(B.KIND_OPEN, strict=int(strict), d1=(OBJ_DOOR, c1, 0)),
            B.clause(B.KIND_OPEN, d1=(OBJ_DOOR, c2, 0)),
        )
        return state, codes, accept_all(state)

    return make_level(
        env_id, gen, room_size, 3, 3, max_steps=20 * room_size**2,
        instr_profile=(("before",), ("open",), (), ("open",), ()),
    )


def make_open_doors_order(env_id: str, num_doors: int, debug: bool = False) -> Environment:
    """open.py OpenDoorsOrder: open one door, or two in a given order."""
    room_size = 6

    def gen(generator, p, state, ctx):
        b, dev = state.grid_obj.shape[0], state.grid_obj.device
        colors = rand_color_subset(generator, b, num_doors, dev)
        for i in range(num_doors):
            state, ctx, _, _, _ = rg.add_door(
                generator, state, ctx, 1, 1, color=colors[:, i], locked=False
            )
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        two = G.permutation(generator, b, num_doors, dev)[:, :2]
        c1, c2 = colors.gather(1, two[:, :1])[:, 0], colors.gather(1, two[:, 1:])[:, 0]
        mode = G.randint(generator, 0, 3, b, dev)
        s = int(debug)
        first = B.clause(B.KIND_OPEN, strict=s, d1=(OBJ_DOOR, c1, 0))
        second = B.clause(B.KIND_OPEN, strict=s, d1=(OBJ_DOOR, c2, 0))
        single = B.instr_codes(b, dev, B.COMB_SINGLE, first)
        before = B.instr_codes(b, dev, B.COMB_BEFORE, first, second)
        after = B.instr_codes(b, dev, B.COMB_AFTER, first, second)
        codes = torch.where(
            (mode == 0)[:, None], single, torch.where((mode == 1)[:, None], before, after)
        )
        return state, codes, accept_all(state)

    return make_level(
        env_id, gen, room_size, 3, 3, max_steps=20 * room_size**2,
        instr_profile=(("single", "before", "after"), ("open",), (), ("open",), ()),
    )
