"""LavaGap: one vertical lava column spanning the interior rows, with one
random gap; the agent starts at (1, 1) facing right, the goal sits
bottom-right.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/lavagap.py`` (the
registered ids' lava obstacle).
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_RED,
    OBJ_GOAL,
    OBJ_LAVA,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G

MISSION = "avoid the lava and get to the green goal square"


def make_lavagap(env_id: str, size: int) -> Environment:
    params = EnvParams(
        width=size, height=size, max_steps=4 * size * size, see_through_walls=False
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b, h, w = batch_size, p.height, p.width
        state = new_state(b, h, w, dev)
        state = G.wall_rect(state, 0, 0, w, h)
        state = G.set_agent(state, 1, 1, 0)
        state = G.put_obj(state, w - 2, h - 2, OBJ_GOAL, COLOR_GREEN)
        # The gap: x in [2, W-2), y in [1, H-1).
        gap_x = G.randint(generator, 2, w - 2, b, dev)
        gap_y = G.randint(generator, 1, h - 1, b, dev)
        column = G.vert_wall_mask(h, w, gap_x, 1, h - 2, dev)
        state = G.paint(state, column, OBJ_LAVA, COLOR_RED)
        return G.clear_cell(state, gap_x, gap_y)

    return Environment(env_id, params, generate, mission_text=lambda c: MISSION)
