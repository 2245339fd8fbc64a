"""PutNear: ``num_objs`` objects of distinct (type, color), pairwise more
than one cell apart; the agent must pick up the move object and drop it
next to the target.  Picking up another object ends the episode, and so
does any drop while carrying.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/putnear.py``.  Aux
slots 0-1 hold the move object's (type, color), 2-3 the target's cell;
the mission slots hold (color, type) of the move object, then the
target's.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_DROP,
    ACT_PICKUP,
    IDX_TO_COLOR,
    OBJ_EMPTY,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.envs.gotoobject import (
    TYPE_NAMES,
    distinct_type_color_prefix,
    place_objects,
)
from minigrid_dynamicprogramming_tpu_torch.ops import agnostic as AG
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward


def post_step(p, generator, prev, ls, action, reward, terminated):
    is_pickup = action == ACT_PICKUP
    is_drop = action == ACT_DROP
    carrying_after = ls.carrying_obj != OBJ_EMPTY
    pre_carrying = prev.carrying_obj != OBJ_EMPTY
    wrong = (ls.carrying_obj.to(torch.int32) != ls.aux[0]) | (
        ls.carrying_color.to(torch.int32) != ls.aux[1]
    )
    terminated = terminated | (is_pickup & carrying_after & wrong)
    # A drop pays when it landed (the front was empty) next to the target.
    dx, dy = AG.dir_vec(ls.agent_dir)
    ax, ay = AG.agent_xy(ls)
    dropped = is_drop & pre_carrying & ~carrying_after
    near_target = ((ax + dx - ls.aux[2]).abs() <= 1) & ((ay + dy - ls.aux[3]).abs() <= 1)
    reward = torch.where(
        dropped & near_target, success_reward(ls.step_count, p.max_steps), reward
    )
    return ls, reward, terminated | (is_drop & pre_carrying)


def make_putnear(env_id: str, size: int = 6, num_objs: int = 2) -> Environment:
    params = EnvParams(
        width=size, height=size, max_steps=5 * size, see_through_walls=True
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state = G.wall_rect(state, 0, 0, p.width, p.height)
        types, colors = distinct_type_color_prefix(generator, b, num_objs, dev)
        state, pos_x, pos_y = place_objects(generator, state, types, colors, near_reject=True)
        state, _ = G.place_agent(generator, state)
        move = G.randint(generator, 0, num_objs, b, dev).long()
        # The target: uniform over the other objects.
        target = (move + G.randint(generator, 1, num_objs, b, dev)) % num_objs
        move, target = move[:, None], target[:, None]
        aux, mission = state.aux.clone(), state.mission.clone()
        aux[:, 0] = mission[:, 1] = types.gather(1, move)[:, 0]
        aux[:, 1] = mission[:, 0] = colors.gather(1, move)[:, 0]
        aux[:, 2] = pos_x.gather(1, target)[:, 0]
        aux[:, 3] = pos_y.gather(1, target)[:, 0]
        mission[:, 2] = colors.gather(1, target)[:, 0]
        mission[:, 3] = types.gather(1, target)[:, 0]
        return state.replace(aux=aux, mission=mission)

    def mission_text(c) -> str:
        return (
            f"put the {IDX_TO_COLOR[c[0]]} {TYPE_NAMES[c[1]]} near "
            f"the {IDX_TO_COLOR[c[2]]} {TYPE_NAMES[c[3]]}"
        )

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=post_step,
        hook_rng=False,
        mission_text=mission_text,
    )
