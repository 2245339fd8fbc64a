"""DoorKey: a random vertical wall with a locked yellow door; the yellow key
and the agent start left of the wall, the goal sits bottom-right.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/doorkey.py`` with the
same draw ranges, generated for a whole batch at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_YELLOW,
    OBJ_DOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_WALL,
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

MISSION = "use the key to open the door and then get to the goal"


def make_doorkey(
    env_id: str, size: int = 8, max_steps: Optional[int] = None
) -> Environment:
    params = EnvParams(
        width=size,
        height=size,
        max_steps=10 * size * size if max_steps is None else max_steps,
        see_through_walls=False,
    )

    def generate(
        generator: torch.Generator,
        p: EnvParams,
        batch_size: int,
        device="cuda",
    ) -> EnvState:
        dev = resolve_device(device)
        b, w, h = batch_size, p.width, p.height
        state = new_state(b, h, w, dev)
        state = G.wall_rect(state, 0, 0, w, h)
        state = G.put_obj(state, w - 2, h - 2, OBJ_GOAL, COLOR_GREEN)

        # Vertical splitting wall at split_idx in [2, width-2).
        split_idx = torch.randint(
            2, w - 2, (b,), generator=generator, device=dev, dtype=torch.int32
        )
        state = G.paint(
            state,
            G.vert_wall_mask(h, w, split_idx, 0, h, dev),
            OBJ_WALL,
            COLOR_GREY,
        )

        # Agent uniform left of the wall, direction in [0, 4).
        _, xs = G.coord_grids(h, w, dev)
        left_of_wall = xs < split_idx.reshape(-1, 1, 1)
        state, _ = G.place_agent(generator, state, reject_mask=~left_of_wall)

        # Locked yellow door at (split_idx, door_idx), door_idx in [1, W-2):
        # the reference draws the row bound from the width.
        door_idx = torch.randint(
            1, w - 2, (b,), generator=generator, device=dev, dtype=torch.int32
        )
        state = G.put_obj(
            state, split_idx, door_idx, OBJ_DOOR, COLOR_YELLOW, STATE_LOCKED
        )

        # Yellow key left of the wall, on a free cell.
        state, _, _ = G.place_obj(
            generator, state, OBJ_KEY, COLOR_YELLOW, reject_mask=~left_of_wall
        )
        return state

    return Environment(env_id, params, generate, mission_text=lambda codes: MISSION)
