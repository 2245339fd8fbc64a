"""Fetch: ``num_objs`` random keys and balls (repeats allowed); picking up
the target (type, color) pays and ends the episode, picking up anything
else ends it with 0.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/fetch.py``.  The
target's (type, color) is in aux slots 0-1; the mission slots hold the
syntax template, the color and the type.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    IDX_TO_COLOR,
    OBJ_BALL,
    OBJ_EMPTY,
    OBJ_KEY,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.envs.gotoobject import place_objects
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

SYNTAX = ("get a", "go get a", "fetch a", "go fetch a", "you must fetch a")
OBJ_TYPES = (OBJ_KEY, OBJ_BALL)
TYPE_NAMES = {OBJ_KEY: "key", OBJ_BALL: "ball"}


def post_step(p, generator, prev, ls, action, reward, terminated):
    """A step that ends with something in hand resolves the episode."""
    carrying = ls.carrying_obj != OBJ_EMPTY
    match = (ls.carrying_obj.to(torch.int32) == ls.aux[0]) & (
        ls.carrying_color.to(torch.int32) == ls.aux[1]
    )
    reward = torch.where(
        carrying & match,
        success_reward(ls.step_count, p.max_steps),
        torch.where(carrying, 0.0, reward),
    )
    return ls, reward, terminated | carrying


def make_fetch(env_id: str, size: int = 8, num_objs: int = 3) -> Environment:
    params = EnvParams(
        width=size, height=size, max_steps=5 * size * size, see_through_walls=True
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state = G.wall_rect(state, 0, 0, p.width, p.height)
        kinds = G.const(OBJ_TYPES, torch.int32, dev)
        types = G.lookup(kinds, G.randint(generator, 0, 2, b * num_objs, dev)).reshape(b, num_objs)
        colors = G.randint(generator, 0, 6, b * num_objs, dev).reshape(b, num_objs)
        state, _, _ = place_objects(generator, state, types, colors)
        state, _ = G.place_agent(generator, state)
        tgt = G.randint(generator, 0, num_objs, b, dev).long()[:, None]
        syntax = G.randint(generator, 0, len(SYNTAX), b, dev)
        aux, mission = state.aux.clone(), state.mission.clone()
        aux[:, 0] = mission[:, 2] = types.gather(1, tgt)[:, 0]
        aux[:, 1] = mission[:, 1] = colors.gather(1, tgt)[:, 0]
        mission[:, 0] = syntax
        return state.replace(aux=aux, mission=mission)

    def mission_text(c) -> str:
        return f"{SYNTAX[c[0]]} {IDX_TO_COLOR[c[1]]} {TYPE_NAMES[c[2]]}"

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=post_step,
        hook_rng=False,
        mission_text=mission_text,
    )
