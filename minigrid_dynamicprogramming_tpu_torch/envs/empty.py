"""Empty: a walled room with the goal in the bottom-right corner; the
agent starts at a fixed pose or on a uniform free cell.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/empty.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import COLOR_GREEN, OBJ_GOAL
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G

MISSION = "get to the green goal square"


def make_empty(
    env_id: str,
    size: int = 8,
    agent_start_pos: Optional[Tuple[int, int]] = (1, 1),
    agent_start_dir: int = 0,
) -> Environment:
    params = EnvParams(
        width=size, height=size, max_steps=4 * size * size, see_through_walls=True
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        state = new_state(batch_size, p.height, p.width, dev)
        state = G.wall_rect(state, 0, 0, p.width, p.height)
        state = G.put_obj(state, p.width - 2, p.height - 2, OBJ_GOAL, COLOR_GREEN)
        if agent_start_pos is not None:
            return G.set_agent(state, *agent_start_pos, agent_start_dir)
        state, _ = G.place_agent(generator, state)
        return state

    return Environment(env_id, params, generate, mission_text=lambda c: MISSION)
