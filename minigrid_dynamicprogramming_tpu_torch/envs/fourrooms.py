"""FourRooms: a 19x19 grid split into 2x2 rooms with one random gap in
each of the four inner wall segments; agent and goal on uniform free cells.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/fourrooms.py`` (the
registered id's random agent and goal).
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    OBJ_GOAL,
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

MISSION = "reach the goal"


def make_fourrooms(env_id: str) -> Environment:
    size = 19
    params = EnvParams(width=size, height=size, max_steps=100, see_through_walls=False)

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b, h, w = batch_size, p.height, p.width
        state = new_state(b, h, w, dev)
        state = G.wall_rect(state, 0, 0, w, h)
        room_w, room_h = w // 2, h // 2
        # The reference's loop over rooms (j = row, i = column), in order.
        for j in range(2):
            for i in range(2):
                x_l, y_t = i * room_w, j * room_h
                x_r, y_b = x_l + room_w, y_t + room_h
                if i + 1 < 2:
                    wall = G.vert_wall_mask(h, w, x_r, y_t, room_h, dev)
                    state = G.paint(state, wall, OBJ_WALL, COLOR_GREY)
                    gap_y = G.randint(generator, y_t + 1, y_b, b, dev)
                    state = G.clear_cell(state, x_r, gap_y)
                if j + 1 < 2:
                    wall = G.horz_wall_mask(h, w, x_l, y_b, room_w, dev)
                    state = G.paint(state, wall, OBJ_WALL, COLOR_GREY)
                    gap_x = G.randint(generator, x_l + 1, x_r, b, dev)
                    state = G.clear_cell(state, gap_x, y_b)
        state, _ = G.place_agent(generator, state)
        state, _, _ = G.place_obj(generator, state, OBJ_GOAL, COLOR_GREEN)
        return state

    return Environment(env_id, params, generate, mission_text=lambda c: MISSION)
