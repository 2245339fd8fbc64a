"""Playground: 19x19, a 3x3 grid of rooms joined by closed doors of random
colors, twelve objects of random kind and color; no goal and no reward.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/playground.py``.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
    STATE_CLOSED,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G

TYPES = (OBJ_KEY, OBJ_BALL, OBJ_BOX)


def make_playground(env_id: str, max_steps: int = 100) -> Environment:
    size = 19
    params = EnvParams(width=size, height=size, max_steps=max_steps, see_through_walls=False)
    room_w = room_h = size // 3

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state = G.wall_rect(state, 0, 0, size, size)
        for j in range(3):
            for i in range(3):
                x_l, y_t = i * room_w, j * room_h
                x_r, y_b = x_l + room_w, y_t + room_h
                if i + 1 < 3:
                    state = G.vert_wall(state, x_r, y_t, room_h)
                    dy = G.randint(generator, y_t + 1, y_b - 1, b, dev)
                    color = G.randint(generator, 0, 6, b, dev)
                    state = G.put_obj(state, x_r, dy, OBJ_DOOR, color, STATE_CLOSED)
                if j + 1 < 3:
                    state = G.horz_wall(state, x_l, y_b, room_w)
                    dx = G.randint(generator, x_l + 1, x_r - 1, b, dev)
                    color = G.randint(generator, 0, 6, b, dev)
                    state = G.put_obj(state, dx, y_b, OBJ_DOOR, color, STATE_CLOSED)
        state, _ = G.place_agent(generator, state)
        types = G.const(TYPES, torch.int32, dev)
        for _ in range(12):
            kind = G.lookup(types, G.randint(generator, 0, 3, b, dev))
            color = G.randint(generator, 0, 6, b, dev)
            state, _, _ = G.place_obj(generator, state, kind, color)
        return state

    return Environment(env_id, params, generate, mission_text=lambda c: "")
