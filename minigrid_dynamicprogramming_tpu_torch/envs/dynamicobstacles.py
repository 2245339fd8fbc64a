"""DynamicObstacles: blue balls random-walk in their 3x3 neighbourhoods
before the agent acts; walking forward into anything but an empty cell or
the goal ends the episode with reward -1.  Actions are left, right and
forward; larger ones act as left.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/dynamicobstacles.py``.
Ball i's cell is in aux slots 2i and 2i+1; aux slot 22 carries the
"front not clear" flag, read from the grid before the balls move, from
``pre_step`` to ``post_step``.  The moves draw from the rollout's
``torch.Generator`` (JAX draws them from per-env threefry keys), so they
agree with JAX's in distribution, not draw for draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    COLOR_BLUE,
    COLOR_GREEN,
    OBJ_BALL,
    OBJ_EMPTY,
    OBJ_GOAL,
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

MISSION = "get to the green goal square"
NOT_CLEAR_SLOT = 22


def action_map(p, action):
    return torch.where(action >= ACT_PICKUP, ACT_LEFT, action)


def post_step(p, generator, prev, ls, action, reward, terminated):
    """Forward into a cell that was occupied before the balls moved."""
    collided = (action == ACT_FORWARD) & (ls.aux[NOT_CLEAR_SLOT] != 0)
    return ls, torch.where(collided, -1.0, reward), terminated | collided


def make_dynamicobstacles(
    env_id: str,
    size: int = 8,
    agent_start_pos: Optional[Tuple[int, int]] = (1, 1),
    agent_start_dir: int = 0,
    n_obstacles: int = 4,
) -> Environment:
    # The reference caps the ball count.
    n_obs = int(n_obstacles) if n_obstacles <= size / 2 + 1 else int(size / 2)
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
            state = G.set_agent(state, *agent_start_pos, agent_start_dir)
        else:
            state, _ = G.place_agent(generator, state)
        aux = state.aux.clone()
        for i in range(n_obs):
            state, (x, y), _ = G.place_obj(generator, state, OBJ_BALL, COLOR_BLUE)
            aux[:, 2 * i], aux[:, 2 * i + 1] = x, y
        return state.replace(aux=aux)

    def pre_step(p, generator, ls, action):
        # "Front not clear" from the grid before any ball moves.
        dx, dy = AG.dir_vec(ls.agent_dir)
        ax, ay = AG.agent_xy(ls)
        fx = (ax + dx).clamp(0, p.width - 1)
        fy = (ay + dy).clamp(0, p.height - 1)
        front = AG.read_cell(p, ls, "grid_obj", fx, fy)
        aux = ls.aux.clone()
        aux[NOT_CLEAR_SLOT] = ((front != OBJ_EMPTY) & (front != OBJ_GOAL)).to(aux.dtype)
        ls = ls.replace(aux=aux)
        # One ball at a time, each seeing the moves before it; a ball whose
        # neighbourhood has no free cell stays.
        for i in range(n_obs):
            ox, oy = ls.aux[2 * i], ls.aux[2 * i + 1]
            valid = AG.free_cell_mask(p, ls) & AG.rect_mask(p, ls, (ox - 1, oy - 1), (3, 3))
            x, y, ok = AG.sample_mask_pos(p, generator, valid)
            moved = AG.put_obj(p, ls, x, y, OBJ_BALL, COLOR_BLUE)
            moved = AG.clear_cell(p, moved, ox, oy)
            aux = moved.aux.clone()
            aux[2 * i], aux[2 * i + 1] = x, y
            ls = AG.select_state(ok, moved.replace(aux=aux), ls)
        return ls

    return Environment(
        env_id,
        params,
        generate,
        pre_step_lanes=pre_step,
        post_step_lanes=post_step,
        action_map=action_map,
        action_dim=3,
        reward_range=(-1.0, 1.0),
        mission_text=lambda c: MISSION,
    )
