"""BabyAI GoTo levels (the reference's ``envs/babyai/goto.py``).

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/goto.py``:
each level is a batched ``gen_mission`` plugged into
:func:`..level.make_level`; the reference's retry loops become ``ok``
flags and uniform draws over validity masks.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_BLUE,
    COLOR_GREY,
    COLOR_RED,
    OBJ_BALL,
    OBJ_DOOR,
    OBJ_KEY,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import (
    accept_all,
    batch_of,
    make_level,
    objs_reachable,
    open_all_doors,
    pick,
    select_state,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg

_GOTO = B.single_profile("goto")


def _goto_codes(state, kind, color):
    """GoToInstr(ObjDesc(kind, color)) as (B, 48) codes."""
    return B.single_codes(state, B.KIND_GOTO, kind, color)


def other_room(generator, b: int, rows: int, cols: int, i, j, dev):
    """A uniform room other than (i, j) per env: (ri, rj), each (B,)."""
    rooms = torch.arange(rows * cols, device=dev)
    valid = ~((rooms % cols == i[:, None]) & (rooms // cols == j[:, None]))
    pick, _, _ = G.sample_mask_pos(generator, valid[:, None, :])
    return pick % cols, pick // cols


def distractors_per_room(generator, state, ctx, room_size, rows, cols, per_room, skip_i, skip_j):
    """``per_room`` objects of uniform kind and color in every room, the
    room (skip_i, skip_j) left as it was (each draw is made all the same,
    as JAX's scan over the rooms makes it)."""
    b, dev = batch_of(state)
    for r in range(rows * cols):
        i, j = r % cols, r // cols
        sub, sub_ctx = state, ctx
        for _ in range(per_room):
            kind = G.lookup(
                G.const(rg.OBJ_KINDS, torch.int64, dev), G.randint(generator, 0, 3, b, dev)
            )
            color = G.randint(generator, 0, 6, b, dev)
            sub, sub_ctx, _, _ = rg.place_in_room(
                generator, sub, sub_ctx, room_size, i, j, kind, color
            )
        skip = (skip_i == i) & (skip_j == j)
        state, ctx = select_state(skip, state, sub), select_state(skip, ctx, sub_ctx)
    return state, ctx


def make_goto_red_ball_grey(env_id: str, room_size: int = 8, num_dists: int = 7) -> Environment:
    """goto.py:12-77: a red ball among grey distractors, one room."""

    def gen(generator, p, state, ctx):
        state = rg.place_agent(generator, state, room_size)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 0, 0, OBJ_BALL, COLOR_RED
        )
        state, ctx, _, _, poss = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        grid_color = state.grid_color
        for t in range(num_dists):  # every distractor repainted grey (goto.py:71-72)
            grid_color = G.cell_set(grid_color, poss[:, t, 1], poss[:, t, 0], COLOR_GREY)
        state = state.replace(grid_color=grid_color)
        return state, _goto_codes(state, OBJ_BALL, COLOR_RED), objs_reachable(state)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=_GOTO)


def make_goto_red_ball(env_id: str, room_size: int = 8, num_dists: int = 7) -> Environment:
    """goto.py:80-140 (and :143-192 without distractors)."""

    def gen(generator, p, state, ctx):
        state = rg.place_agent(generator, state, room_size)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 0, 0, OBJ_BALL, COLOR_RED
        )
        state, ctx, _, _, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        return state, _goto_codes(state, OBJ_BALL, COLOR_RED), objs_reachable(state)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=_GOTO)


def make_goto_obj(env_id: str, room_size: int = 8) -> Environment:
    """goto.py:195-259: one object, no distractors."""

    def gen(generator, p, state, ctx):
        state = rg.place_agent(generator, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0, num_distractors=1, all_unique=True
        )
        return state, _goto_codes(state, kinds[:, 0], colors[:, 0]), accept_all(state)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=_GOTO)


def make_goto_local(env_id: str, room_size: int = 8, num_dists: int = 8) -> Environment:
    """goto.py:262-337: go to one of the distractors, one room."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        ok = objs_reachable(state)
        n = G.randint(generator, 0, num_dists, b, dev)
        return state, _goto_codes(state, pick(kinds, n), pick(colors, n)), ok

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=_GOTO)


def make_goto(
    env_id: str,
    room_size: int = 8,
    num_rows: int = 3,
    num_cols: int = 3,
    num_dists: int = 18,
    doors_open: bool = False,
) -> Environment:
    """goto.py:340-425: a maze of rooms, many distractors."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size, rows=num_rows, cols=num_cols)
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, num_rows, num_cols,
            num_distractors=num_dists, all_unique=False,
        )
        ok = objs_reachable(state)
        n = G.randint(generator, 0, num_dists, b, dev)
        codes = _goto_codes(state, pick(kinds, n), pick(colors, n))
        if doors_open:
            state = open_all_doors(state)
        return state, codes, ok

    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=_GOTO)


def make_goto_imp_unlock(
    env_id: str, room_size: int = 8, num_rows: int = 3, num_cols: int = 3
) -> Environment:
    """goto.py:428-524: the target inside a locked room, its key in
    another room; unlocking is implicit."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        # A locked door on a uniform room (goto.py:485-488).
        id_ = G.randint(generator, 0, num_cols, b, dev)
        jd = G.randint(generator, 0, num_rows, b, dev)
        state, ctx, _, door_color, _ = rg.add_door(generator, state, ctx, id_, jd, locked=True)
        # The key in a uniform other room (goto.py:491-497).
        ki, kj = other_room(generator, b, num_rows, num_cols, id_, jd, dev)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, ki, kj, OBJ_KEY, door_color
        )
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        # Two distractors in every unlocked room (goto.py:505-508).
        state, ctx = distractors_per_room(
            generator, state, ctx, room_size, num_rows, num_cols, 2, id_, jd
        )
        # The agent anywhere but the locked room (goto.py:511-517).
        ai, aj = other_room(generator, b, num_rows, num_cols, id_, jd, dev)
        state = rg.place_agent(
            generator, state, room_size, i=ai, j=aj, rows=num_rows, cols=num_cols
        )
        ok = objs_reachable(state)
        # One object inside the locked room; go to it (goto.py:521-524).
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, num_rows, num_cols, id_, jd,
            num_distractors=1, all_unique=False,
        )
        return state, _goto_codes(state, kinds[:, 0], colors[:, 0]), ok

    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=_GOTO)


def make_goto_red_blue_ball(env_id: str, room_size: int = 8, num_dists: int = 7) -> Environment:
    """goto.py:603-676: exactly one red or blue ball among distractors."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        # No red or blue ball among the distractors (goto.py:666-668).
        bad = ((kinds == OBJ_BALL) & ((colors == COLOR_RED) | (colors == COLOR_BLUE))).any(dim=1)
        color = torch.where(G.randint(generator, 0, 2, b, dev) == 0, COLOR_RED, COLOR_BLUE)
        state, ctx, _, _ = rg.place_in_room(generator, state, ctx, room_size, 0, 0, OBJ_BALL, color)
        return state, _goto_codes(state, OBJ_BALL, color), ~bad & objs_reachable(state)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=_GOTO)


def make_goto_door(env_id: str, room_size: int = 7) -> Environment:
    """goto.py:679-743: four doors on the centre room; go to one."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        colors = []
        for _ in range(4):
            state, ctx, _, c, _ = rg.add_door(generator, state, ctx, 1, 1)
            colors.append(c)
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        n = G.randint(generator, 0, 4, b, dev)
        codes = _goto_codes(state, OBJ_DOOR, pick(torch.stack(colors, 1), n))
        return state, codes, accept_all(state)

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=_GOTO)


def make_goto_obj_door(env_id: str, room_size: int = 8) -> Environment:
    """goto.py:746-814: go to one of 8 distractors or 4 doors in the
    centre room."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 3, 3, 1, 1, num_distractors=8, all_unique=False
        )
        door_colors = []
        for _ in range(4):
            state, ctx, _, c, _ = rg.add_door(generator, state, ctx, 1, 1)
            door_colors.append(c)
        all_kinds = torch.cat(
            [kinds, torch.full((b, 4), OBJ_DOOR, dtype=kinds.dtype, device=dev)], 1
        )
        all_colors = torch.cat([colors, torch.stack(door_colors, 1).to(colors.dtype)], 1)
        ok = objs_reachable(state)
        n = G.randint(generator, 0, 12, b, dev)
        return state, _goto_codes(state, pick(all_kinds, n), pick(all_colors, n)), ok

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=_GOTO)
