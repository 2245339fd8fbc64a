"""Memory: a small start room shows a green key or ball; at the end of a
hallway the agent must step next to the matching object.  ``pickup`` acts
as ``toggle``.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/memory.py``.  Aux
slots 0-1 hold the success square, 2-3 the failure square.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_PICKUP,
    ACT_TOGGLE,
    COLOR_GREEN,
    COLOR_GREY,
    OBJ_BALL,
    OBJ_KEY,
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
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

MISSION = "go to the matching object at the end of the hallway"


def action_map(p, action):
    return torch.where(action == ACT_PICKUP, ACT_TOGGLE, action)


def post_step(p, generator, prev, ls, action, reward, terminated):
    at_success = (ls.agent_x == ls.aux[0]) & (ls.agent_y == ls.aux[1])
    at_failure = (ls.agent_x == ls.aux[2]) & (ls.agent_y == ls.aux[3])
    reward = torch.where(at_success, success_reward(ls.step_count, p.max_steps), reward)
    reward = torch.where(at_failure, 0.0, reward)
    return ls, reward, terminated | at_success | at_failure


def make_memory(env_id: str, size: int = 8, random_length: bool = False) -> Environment:
    assert size % 2 == 1
    params = EnvParams(
        width=size, height=size, max_steps=5 * size * size, see_through_walls=False
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b, h, w = batch_size, p.height, p.width
        mid = h // 2
        state = new_state(b, h, w, dev)
        state = G.wall_rect(state, 0, 0, w, h)
        upper, lower = mid - 2, mid + 2
        if random_length:
            hallway_end = G.randint(generator, 4, w - 2, b, dev)
        else:
            hallway_end = torch.full((b,), w - 3, dtype=torch.int32, device=dev)
        end = hallway_end.reshape(-1, 1, 1)
        ys, xs = G.coord_grids(h, w, dev)
        # The start room's walls, the hallway's from x=5 to its end, and the
        # end walls.
        m = (ys == upper) & (xs >= 1) & (xs <= 4)
        m = m | ((ys == lower) & (xs >= 1) & (xs <= 4))
        m = m | ((xs == 4) & (ys == upper + 1))
        m = m | ((xs == 4) & (ys == lower - 1))
        m = m | ((ys == upper + 1) & (xs >= 5) & (xs < end))
        m = m | ((ys == lower - 1) & (xs >= 5) & (xs < end))
        m = m | ((xs == end) & (ys != mid))
        m = m | (xs == end + 2)
        state = G.paint(state, m, OBJ_WALL, COLOR_GREY)
        state = G.set_agent(state, G.randint(generator, 1, hallway_end + 1, b, dev), mid, 0)

        # The object shown in the start room and the two at the hallway's end.
        start_obj = torch.where(G.randint(generator, 0, 2, b, dev) == 0, OBJ_KEY, OBJ_BALL)
        state = G.put_obj(state, 1, mid - 1, start_obj, COLOR_GREEN)
        first_is_ball = G.randint(generator, 0, 2, b, dev) == 0
        obj0 = torch.where(first_is_ball, OBJ_BALL, OBJ_KEY)
        obj1 = torch.where(first_is_ball, OBJ_KEY, OBJ_BALL)
        state = G.put_obj(state, hallway_end + 1, mid - 2, obj0, COLOR_GREEN)
        state = G.put_obj(state, hallway_end + 1, mid + 2, obj1, COLOR_GREEN)

        # The success and failure squares, each next to one of the two.
        match0 = start_obj == obj0
        aux = state.aux.clone()
        aux[:, 0] = aux[:, 2] = hallway_end + 1
        aux[:, 1] = torch.where(match0, mid - 1, mid + 1)
        aux[:, 3] = torch.where(match0, mid + 1, mid - 1)
        return state.replace(aux=aux)

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=post_step,
        hook_rng=False,
        action_map=action_map,
        mission_text=lambda c: MISSION,
    )
