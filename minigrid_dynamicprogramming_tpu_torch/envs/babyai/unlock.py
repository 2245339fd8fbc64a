"""BabyAI Unlock levels (the reference's ``envs/babyai/unlock.py``).

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/unlock.py``.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.goto import (
    distractors_per_room,
    other_room,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import (
    accept_all,
    batch_of,
    make_level,
    objs_reachable,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.open import rand_color_subset
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg


def make_unlock(
    env_id: str, room_size: int = 8, num_rows: int = 3, num_cols: int = 3
) -> Environment:
    """unlock.py Unlock: open a locked door whose key lies in another room;
    half the time no other door shares its color."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        id_ = G.randint(generator, 0, num_cols, b, dev)
        jd = G.randint(generator, 0, num_rows, b, dev)
        state, ctx, _, door_color, _ = rg.add_door(generator, state, ctx, id_, jd, locked=True)
        ki, kj = other_room(generator, b, num_rows, num_cols, id_, jd, dev)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, ki, kj, OBJ_KEY, door_color
        )
        # Half the time connect_all avoids the door's color (unlock.py:31-36).
        unique = G.randint(generator, 0, 2, b, dev) == 0
        exclude = torch.where(unique, door_color, -1)
        state, ctx = rg.connect_all(generator, state, ctx, room_size, exclude_color=exclude)
        # Three distractors in every room but the locked one (unlock.py:38-45).
        state, ctx = distractors_per_room(
            generator, state, ctx, room_size, num_rows, num_cols, 3, id_, jd
        )
        ai, aj = other_room(generator, b, num_rows, num_cols, id_, jd, dev)
        state = rg.place_agent(
            generator, state, room_size, i=ai, j=aj, rows=num_rows, cols=num_cols
        )
        codes = B.single_codes(state, B.KIND_OPEN, OBJ_DOOR, door_color)
        return state, codes, objs_reachable(state)

    return make_level(
        env_id, gen, room_size, num_rows, num_cols, instr_profile=B.single_profile("open")
    )


def make_unlock_local(env_id: str, distractors: bool = False) -> Environment:
    """unlock.py UnlockLocal: the key and the locked door in one room."""
    room_size = 8

    def gen(generator, p, state, ctx):
        state, ctx, _, door_color, _ = rg.add_door(generator, state, ctx, 1, 1, locked=True)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 1, 1, OBJ_KEY, door_color
        )
        if distractors:
            state, ctx, _, _, _ = rg.add_distractors(
                generator, state, ctx, room_size, 3, 3, 1, 1, num_distractors=3, all_unique=True
            )
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        return state, B.single_codes(state, B.KIND_OPEN, OBJ_DOOR, B.COLOR_ANY), accept_all(state)

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=B.single_profile("open"))


def make_key_in_box(env_id: str) -> Environment:
    """unlock.py KeyInBox: the door's key hidden in a box."""
    room_size = 8

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state, ctx, _, door_color, _ = rg.add_door(generator, state, ctx, 1, 1, locked=True)
        box_color = G.randint(generator, 0, 6, b, dev)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 1, 1, OBJ_BOX, box_color,
            contains_obj=OBJ_KEY, contains_color=door_color,
        )
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        return state, B.single_codes(state, B.KIND_OPEN, OBJ_DOOR, B.COLOR_ANY), accept_all(state)

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=B.single_profile("open"))


def make_unlock_pickup(env_id: str, distractors: bool = False) -> Environment:
    """unlock.py UnlockPickup: a box behind a locked door (JAX pins
    max_steps to 8 * room_size**2)."""
    room_size = 6

    def gen(generator, p, state, ctx):
        state, ctx, _, _, box_color = rg.add_object(
            generator, state, ctx, room_size, 1, 0, kind=OBJ_BOX
        )
        state, ctx, _, door_color, _ = rg.add_door(
            generator, state, ctx, 0, 0, door_idx=0, locked=True
        )
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 0, 0, OBJ_KEY, door_color
        )
        if distractors:
            state, ctx, _, _, _ = rg.add_distractors(
                generator, state, ctx, room_size, 1, 2, num_distractors=4, all_unique=True
            )
        state = rg.place_agent(generator, state, room_size, i=0, j=0, rows=1, cols=2)
        return state, B.single_codes(state, B.KIND_PICKUP, OBJ_BOX, box_color), accept_all(state)

    return make_level(
        env_id, gen, room_size, 1, 2, max_steps=8 * room_size**2,
        instr_profile=B.single_profile("pickup"),
    )


def make_blocked_unlock_pickup(env_id: str) -> Environment:
    """unlock.py BlockedUnlockPickup: a ball blocks the locked door."""
    room_size = 6

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state, ctx, _, _, _ = rg.add_object(generator, state, ctx, room_size, 1, 0, kind=OBJ_BOX)
        state, ctx, (dx, dy), door_color, _ = rg.add_door(
            generator, state, ctx, 0, 0, door_idx=0, locked=True
        )
        ball_color = G.randint(generator, 0, 6, b, dev)
        state = G.put_obj(state, dx - 1, dy, OBJ_BALL, ball_color)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 0, 0, OBJ_KEY, door_color
        )
        state = rg.place_agent(generator, state, room_size, i=0, j=0, rows=1, cols=2)
        return state, B.single_codes(state, B.KIND_PICKUP, OBJ_BOX, B.COLOR_ANY), accept_all(state)

    return make_level(
        env_id, gen, room_size, 1, 2, max_steps=16 * room_size**2,
        instr_profile=B.single_profile("pickup"),
    )


def make_unlock_to_unlock(env_id: str) -> Environment:
    """unlock.py UnlockToUnlock: key B behind door A, the ball behind
    door B."""
    room_size = 6

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        colors = rand_color_subset(generator, b, 2, dev)
        state, ctx, _, _, _ = rg.add_door(
            generator, state, ctx, 0, 0, door_idx=0, color=colors[:, 0], locked=True
        )
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 2, 0, OBJ_KEY, colors[:, 0]
        )
        state, ctx, _, _, _ = rg.add_door(
            generator, state, ctx, 1, 0, door_idx=0, color=colors[:, 1], locked=True
        )
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 1, 0, OBJ_KEY, colors[:, 1]
        )
        ball_color = G.randint(generator, 0, 6, b, dev)
        state, ctx, _, _ = rg.place_in_room(
            generator, state, ctx, room_size, 0, 0, OBJ_BALL, ball_color
        )
        state = rg.place_agent(generator, state, room_size, i=1, j=0, rows=1, cols=3)
        return state, B.single_codes(state, B.KIND_PICKUP, OBJ_BALL, B.COLOR_ANY), accept_all(state)

    return make_level(
        env_id, gen, room_size, 1, 3, max_steps=30 * room_size**2,
        instr_profile=B.single_profile("pickup"),
    )
