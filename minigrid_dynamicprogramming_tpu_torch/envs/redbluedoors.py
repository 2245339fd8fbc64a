"""RedBlueDoors: a size x size room inside a 2*size x size grid, a red
door on its left wall and a blue one on its right; the agent must open the
red door first, then the blue one.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/redbluedoors.py``.
Aux slots 0-3 hold the red and the blue door's cells.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_BLUE,
    COLOR_RED,
    OBJ_DOOR,
    STATE_CLOSED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops import agnostic as AG
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

MISSION = "open the red door then the blue door"


def post_step(p, generator, prev, ls, action, reward, terminated):
    def door_open(s, i):
        state = AG.read_cell(p, s, "grid_state", s.aux[2 * i], s.aux[2 * i + 1])
        return state == STATE_OPEN

    red_before, blue_before = door_open(prev, 0), door_open(prev, 1)
    red_after, blue_after = door_open(ls, 0), door_open(ls, 1)
    win = blue_after & red_before
    lose = (blue_after & ~red_before) | (red_after & ~blue_after & blue_before)
    reward = torch.where(win, success_reward(ls.step_count, p.max_steps), reward)
    reward = torch.where(lose, 0.0, reward)
    return ls, reward, terminated | win | lose


def make_redbluedoors(env_id: str, size: int = 8) -> Environment:
    params = EnvParams(
        width=2 * size, height=size, max_steps=20 * size * size, see_through_walls=False
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state = G.wall_rect(state, 0, 0, 2 * size, size)
        state = G.wall_rect(state, size // 2, 0, size, size)
        state, _ = G.place_agent(generator, state, top=(size // 2, 0), size=(size, size))
        red_x, blue_x = size // 2, size // 2 + size - 1
        red_y = G.randint(generator, 1, size - 1, b, dev)
        blue_y = G.randint(generator, 1, size - 1, b, dev)
        state = G.put_obj(state, red_x, red_y, OBJ_DOOR, COLOR_RED, STATE_CLOSED)
        state = G.put_obj(state, blue_x, blue_y, OBJ_DOOR, COLOR_BLUE, STATE_CLOSED)
        aux = state.aux.clone()
        for slot, v in enumerate((red_x, red_y, blue_x, blue_y)):
            G.assign(aux[:, slot], v)
        return state.replace(aux=aux)

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=post_step,
        hook_rng=False,
        mission_text=lambda c: MISSION,
    )
