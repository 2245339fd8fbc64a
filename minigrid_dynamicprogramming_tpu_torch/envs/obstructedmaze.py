"""ObstructedMaze: mazes of 6x6 rooms behind locked doors whose keys may
hide in grey boxes, with green balls that may block the doors; the target
is a blue ball.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/obstructedmaze.py``.
The v0 variants keep the reference's generation order, flaw included: a
later blocking ball may overwrite an earlier key's box, burying that key.
The v1 variants place every door and blocker of a side room before its
keys (the upstream fix).  Aux slots 0-1 hold the target's (type, color),
mission slot 0 its color.
"""

from __future__ import annotations

from typing import Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_TO_IDX,
    DIR_TO_VEC,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_KEY,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.envs.keycorridor import (
    pickup_target_post_step,
    set_target,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as RG

ROOM_SIZE = 6
# The reference's color names sorted: blue, green, grey, purple, red, yellow.
SORTED_COLOR_IDS = [COLOR_TO_IDX[c] for c in sorted(COLOR_TO_IDX)]
BALL_TO_FIND = SORTED_COLOR_IDS[0]  # blue
BLOCKING_BALL = SORTED_COLOR_IDS[1]  # green
BOX_COLOR = SORTED_COLOR_IDS[2]  # grey


def _door_colors(generator: torch.Generator, b: int, device) -> torch.Tensor:
    """(B, 6) int32: a uniform permutation of the sorted color list."""
    ids = G.const(SORTED_COLOR_IDS, torch.int32, device)
    return G.lookup(ids, G.permutation(generator, b, 6, device))


def _add_key(generator, state, ctx, i, j, color, key_in_box: bool):
    """The key of ``color`` in room (i, j), bare or inside a grey box."""
    if key_in_box:
        state, ctx, _, _ = RG.place_in_room(
            generator, state, ctx, ROOM_SIZE, i, j, OBJ_BOX, BOX_COLOR,
            contains_obj=OBJ_KEY, contains_color=color,
        )
    else:
        state, ctx, _, _ = RG.place_in_room(
            generator, state, ctx, ROOM_SIZE, i, j, OBJ_KEY, color
        )
    return state, ctx


def _add_obstructed_door(
    generator, state, ctx, i, j, door_idx: int, color, key_in_box: bool,
    blocked: bool, place_key: bool = True,
):
    """A locked door on edge ``door_idx`` of room (i, j); a blocking ball
    on the room's side of it; the door's key in the room."""
    state, ctx, (dx, dy), color, _ = RG.add_door(
        generator, state, ctx, i, j, door_idx=door_idx, color=color, locked=True
    )
    if blocked:
        vx, vy = (int(v) for v in DIR_TO_VEC[door_idx])
        state = G.put_obj(state, dx - vx, dy - vy, OBJ_BALL, BLOCKING_BALL)
    if place_key:
        state, ctx = _add_key(generator, state, ctx, i, j, color, key_in_box)
    return state, ctx


def _make(env_id: str, params: EnvParams, generate) -> Environment:
    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=pickup_target_post_step,
        hook_rng=False,
        mission_text=lambda c: "pick up the blue ball",
    )


def make_obstructedmaze_1d(env_id: str, key_in_box: bool, blocked: bool) -> Environment:
    """1Dl, 1Dlh and 1Dlhb: two rooms, one locked door."""
    params = EnvParams(
        width=(ROOM_SIZE - 1) * 2 + 1,
        height=ROOM_SIZE,
        max_steps=4 * 2 * ROOM_SIZE * ROOM_SIZE,
        see_through_walls=False,
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state, ctx = RG.init(generator, state, ROOM_SIZE, 1, 2)
        colors = _door_colors(generator, b, dev)
        state, ctx = _add_obstructed_door(
            generator, state, ctx, 0, 0, 0, colors[:, 0], key_in_box, blocked
        )
        state, ctx, _, _, _ = RG.add_object(
            generator, state, ctx, ROOM_SIZE, 1, 0, kind=OBJ_BALL, color=BALL_TO_FIND
        )
        state = RG.place_agent(generator, state, ROOM_SIZE, 0, 0)
        return set_target(state, OBJ_BALL, BALL_TO_FIND, mission_kind=False)

    return _make(env_id, params, generate)


def make_obstructedmaze_full(
    env_id: str,
    agent_room: Tuple[int, int] = (1, 1),
    key_in_box: bool = True,
    blocked: bool = True,
    num_quarters: int = 4,
    num_rooms_visited: int = 25,
    v1: bool = False,
) -> Environment:
    """2Dl, 2Dlh, 2Dlhb, 1Q, 2Q and Full on a 3x3 lattice, v0 and v1."""
    rows = cols = 3
    params = EnvParams(
        width=(ROOM_SIZE - 1) * cols + 1,
        height=(ROOM_SIZE - 1) * rows + 1,
        max_steps=4 * num_rooms_visited * ROOM_SIZE * ROOM_SIZE,
        see_through_walls=False,
    )
    middle = (1, 1)
    side_rooms = [(2, 1), (1, 2), (0, 1), (1, 0)][:num_quarters]
    corners = [(2, 0), (2, 2), (0, 2), (0, 0)][:num_quarters]

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state, ctx = RG.init(generator, state, ROOM_SIZE, rows, cols)
        colors = _door_colors(generator, b, dev)
        for i, side in enumerate(side_rooms):
            state, ctx, _, _, _ = RG.add_door(
                generator, state, ctx, middle[0], middle[1],
                door_idx=i, color=colors[:, i], locked=False,
            )
            for k in (-1, 1):  # v0: door, blocker and key; then the next door
                state, ctx = _add_obstructed_door(
                    generator, state, ctx, side[0], side[1], (i + k) % 4,
                    colors[:, (i + k) % 6], key_in_box, blocked, place_key=not v1,
                )
            if v1:  # v1: both keys after both doors and blockers
                for k in (-1, 1):
                    state, ctx = _add_key(
                        generator, state, ctx, side[0], side[1],
                        colors[:, (i + k) % 6], key_in_box,
                    )
        room = G.lookup(
            G.const(corners, torch.int32, dev), G.randint(generator, 0, len(corners), b, dev)
        )
        state, ctx, _, _, _ = RG.add_object(
            generator, state, ctx, ROOM_SIZE, room[:, 0], room[:, 1],
            kind=OBJ_BALL, color=BALL_TO_FIND,
        )
        state = RG.place_agent(generator, state, ROOM_SIZE, agent_room[0], agent_room[1])
        return set_target(state, OBJ_BALL, BALL_TO_FIND, mission_kind=False)

    return _make(env_id, params, generate)
