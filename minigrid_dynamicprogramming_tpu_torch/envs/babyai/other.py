"""BabyAI's other levels (the reference's ``envs/babyai/other.py``).

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/other.py``.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL, OBJ_DOOR, OBJ_KEY
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import (
    accept_all,
    batch_of,
    make_level,
    pick,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg


def make_action_obj_door(env_id: str) -> Environment:
    """other.py ActionObjDoor: go to, open or pick up one of five objects
    or four doors of the centre room."""
    room_size = 7

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 3, 3, 1, 1, num_distractors=5, all_unique=True
        )
        door_colors = []
        for _ in range(4):
            state, ctx, _, c, _ = rg.add_door(generator, state, ctx, 1, 1, locked=False)
            door_colors.append(c)
        all_kinds = torch.cat(
            [kinds, torch.full((b, 4), OBJ_DOOR, dtype=kinds.dtype, device=dev)], 1
        )
        all_colors = torch.cat([colors, torch.stack(door_colors, 1).to(colors.dtype)], 1)
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        n = G.randint(generator, 0, 9, b, dev)
        kind, color = pick(all_kinds, n), pick(all_colors, n)
        coin = G.randint(generator, 0, 2, b, dev) == 0
        # Doors: GoTo or Open; objects: GoTo or Pickup (other.py:33-43).
        instr_kind = torch.where(
            coin, B.KIND_GOTO, torch.where(kind == OBJ_DOOR, B.KIND_OPEN, B.KIND_PICKUP)
        )
        return state, B.single_codes(state, instr_kind, kind, color), accept_all(state)

    return make_level(
        env_id, gen, room_size, 3, 3, instr_profile=B.single_profile("goto", "open", "pickup")
    )


def make_find_obj(env_id: str, room_size: int = 5) -> Environment:
    """other.py FindObjS5: one object hidden in a uniform room (the
    reference draws i from the rows and j from the columns, other.py:160-162,
    which is the same on its square 3x3 lattice)."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        i = G.randint(generator, 0, 3, b, dev)
        j = G.randint(generator, 0, 3, b, dev)
        state, ctx, _, kind, _ = rg.add_object(generator, state, ctx, room_size, i, j)
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        return state, B.single_codes(state, B.KIND_PICKUP, kind, B.COLOR_ANY), accept_all(state)

    return make_level(
        env_id, gen, room_size, 3, 3, max_steps=20 * room_size**2,
        instr_profile=B.single_profile("pickup"),
    )


def make_key_corridor(
    env_id: str, num_rows: int = 3, room_size: int = 6, obj_type: int = OBJ_BALL
) -> Environment:
    """other.py KeyCorridor: the target in a locked room on the right, its
    key on the left, the middle column a hallway."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        for j in range(1, num_rows):
            state, ctx = rg.remove_wall(state, ctx, room_size, 1, j, 3)
        row = G.randint(generator, 0, num_rows, b, dev)
        state, ctx, _, door_color, _ = rg.add_door(
            generator, state, ctx, 2, row, door_idx=2, locked=True
        )
        state, ctx, _, kind, _ = rg.add_object(
            generator, state, ctx, room_size, 2, row, kind=obj_type
        )
        key_row = G.randint(generator, 0, num_rows, b, dev)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 0, key_row, OBJ_KEY, door_color
        )
        state = rg.place_agent(
            generator, state, room_size, i=1, j=num_rows // 2, rows=num_rows, cols=3
        )
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        return state, B.single_codes(state, B.KIND_PICKUP, kind, B.COLOR_ANY), accept_all(state)

    return make_level(
        env_id, gen, room_size, num_rows, 3, max_steps=30 * room_size**2,
        instr_profile=B.single_profile("pickup"),
    )


def make_one_room(env_id: str, room_size: int = 8) -> Environment:
    """other.py OneRoomS8: pick up the ball of a single room."""

    def gen(generator, p, state, ctx):
        state, ctx, _, _, _ = rg.add_object(generator, state, ctx, room_size, 0, 0, kind=OBJ_BALL)
        state = rg.place_agent(generator, state, room_size)
        return state, B.single_codes(state, B.KIND_PICKUP, OBJ_BALL, B.COLOR_ANY), accept_all(state)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("pickup"))


def make_move_two_across(env_id: str, room_size: int, objs_per_room: int) -> Environment:
    """other.py MoveTwoAcross: two PutNext instructions in sequence across
    the two joined rooms."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size, i=0, j=0, rows=1, cols=2)
        state, ctx, kl, cl, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 2, 0, 0,
            num_distractors=objs_per_room, all_unique=True,
        )
        state, ctx, kr, cr, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 2, 1, 0,
            num_distractors=objs_per_room, all_unique=True,
        )
        state, ctx = rg.remove_wall(state, ctx, room_size, 0, 0, 0)
        two_l = G.permutation(generator, b, objs_per_room, dev)[:, :2]
        two_r = G.permutation(generator, b, objs_per_room, dev)[:, :2]
        a, d = two_l[:, 0], two_l[:, 1]
        c0, c1 = two_r[:, 0], two_r[:, 1]
        codes = B.instr_codes(
            b, dev, B.COMB_BEFORE,
            B.clause(B.KIND_PUTNEXT, d1=(pick(kl, a), pick(cl, a), 0),
                     d2=(pick(kr, c0), pick(cr, c0), 0)),
            B.clause(B.KIND_PUTNEXT, d1=(pick(kr, c1), pick(cr, c1), 0),
                     d2=(pick(kl, d), pick(cl, d), 0)),
        )
        return state, codes, accept_all(state)

    return make_level(
        env_id, gen, room_size, 1, 2, max_steps=16 * room_size**2,
        instr_profile=(("before",), ("putnext",), (), ("putnext",), ()),
    )
