"""LockedRoom: 19x19, a central hallway between two columns of three
rooms.  One room is locked and holds the goal; the key, of the locked
door's color, lies in another room; the six doors have distinct colors.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/lockedroom.py``.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    IDX_TO_COLOR,
    OBJ_DOOR,
    OBJ_GOAL,
    OBJ_KEY,
    STATE_CLOSED,
    STATE_LOCKED,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G


def make_lockedroom(env_id: str, size: int = 19) -> Environment:
    params = EnvParams(
        width=size, height=size, max_steps=10 * size, see_through_walls=False
    )
    lwall = size // 2 - 2
    rwall = size // 2 + 2
    room_w = lwall + 1
    room_h = size // 3 + 1
    # Six rooms: (top-left corner, door); the left column's doors are on the
    # lwall column, the right column's on the rwall column.
    tops, doors = [], []
    for n in range(3):
        j = n * (size // 3)
        tops += [(0, j), (rwall, j)]
        doors += [(lwall, j + 3), (rwall, j + 3)]

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, size, size, dev)
        state = G.wall_rect(state, 0, 0, size, size)
        state = G.vert_wall(state, lwall, 0)
        state = G.vert_wall(state, rwall, 0)
        for n in range(3):
            j = n * (size // 3)
            state = G.horz_wall(state, 0, j, lwall)
            state = G.horz_wall(state, rwall, j, size - rwall)

        top = G.const(tops, torch.int32, dev)  # (6, 2)
        locked_idx = G.randint(generator, 0, 6, b, dev).long()
        # The goal on a random interior cell of the locked room.
        gx = G.randint(generator, 1, room_w - 1, b, dev)
        gy = G.randint(generator, 1, room_h - 1, b, dev)
        locked_top = G.lookup(top, locked_idx)
        state = G.put_obj(
            state, locked_top[:, 0] + gx, locked_top[:, 1] + gy, OBJ_GOAL, COLOR_GREEN
        )

        # Distinct door colors: a permutation of the six.
        colors = G.permutation(generator, b, 6, dev)
        for i, (dx, dy) in enumerate(doors):
            door_state = torch.where(locked_idx == i, STATE_LOCKED, STATE_CLOSED)
            state = G.put_obj(state, dx, dy, OBJ_DOOR, colors[:, i], door_state)

        # The key in another room, colored like the locked door.
        key_idx = (locked_idx + G.randint(generator, 1, 6, b, dev)) % 6
        kx = G.randint(generator, 1, room_w - 1, b, dev)
        ky = G.randint(generator, 1, room_h - 1, b, dev)
        locked_color = colors.gather(1, locked_idx[:, None])[:, 0]
        key_top = G.lookup(top, key_idx)
        state = G.put_obj(state, key_top[:, 0] + kx, key_top[:, 1] + ky, OBJ_KEY, locked_color)

        # The agent in the hallway band.
        _, xs = G.coord_grids(size, size, dev)
        hallway = (xs >= lwall) & (xs < rwall)
        state, _ = G.place_agent(generator, state, reject_mask=~hallway)

        mission = state.mission.clone()
        mission[:, 0] = locked_color
        mission[:, 1] = colors.gather(1, key_idx[:, None])[:, 0]
        return state.replace(mission=mission)

    def mission_text(c) -> str:
        lc, kc = IDX_TO_COLOR[c[0]], IDX_TO_COLOR[c[1]]
        return f"get the {lc} key from the {kc} room, unlock the {lc} door and go to the goal"

    return Environment(env_id, params, generate, mission_text=mission_text)
