"""DistShift: a fixed 9x7 room with two lava strips; the second strip's
row tells the two ids apart.  The layout draws nothing.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/distshift.py``.
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

MISSION = "get to the green goal square"


def make_distshift(env_id: str, strip2_row: int = 2) -> Environment:
    width, height = 9, 7
    params = EnvParams(
        width=width, height=height, max_steps=4 * width * height, see_through_walls=True
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        h, w = p.height, p.width
        state = new_state(batch_size, h, w, dev)
        state = G.wall_rect(state, 0, 0, w, h)
        state = G.put_obj(state, w - 2, 1, OBJ_GOAL, COLOR_GREEN)
        # Two lava strips of length W-6 from x=3: rows 1 and strip2_row.
        for row in (1, strip2_row):
            strip = G.horz_wall_mask(h, w, 3, row, w - 6, dev)
            state = G.paint(state, strip, OBJ_LAVA, COLOR_RED)
        return G.set_agent(state, 1, 1, 0)

    return Environment(env_id, params, generate, mission_text=lambda c: MISSION)
