"""KeyCorridor: a three-column RoomGrid whose middle column is merged into a
corridor; the target sits behind a locked door in a right room, the
door's key in a left room.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/keycorridor.py``.
Aux slots 0-1 hold the target's (type, color); the mission slots hold
(color, type).
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_PICKUP,
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
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as RG
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

TYPE_NAMES = {5: "key", 6: "ball", 7: "box"}


def pickup_target_post_step(p, generator, prev, ls, action, reward, terminated):
    """A pickup that leaves the agent carrying the target named by aux
    slots 0-1 pays and ends the episode.  Shared by KeyCorridor, the
    Unlock pickup variants and ObstructedMaze; it draws nothing."""
    got = (
        (action == ACT_PICKUP)
        & (ls.carrying_obj.to(torch.int32) == ls.aux[0])
        & (ls.carrying_color.to(torch.int32) == ls.aux[1])
        & (ls.carrying_obj != OBJ_EMPTY)
    )
    reward = torch.where(got, success_reward(ls.step_count, p.max_steps), reward)
    return ls, reward, terminated | got


def set_target(state: EnvState, kind, color, mission_kind: bool = True) -> EnvState:
    """Aux slots 0-1 to the target's (kind, color); mission slot 0 to its
    color and, where the mission names it, slot 1 to its kind."""
    aux, mission = state.aux.clone(), state.mission.clone()
    G.assign(aux[:, 0], kind)
    G.assign(aux[:, 1], color)
    G.assign(mission[:, 0], color)
    if mission_kind:
        G.assign(mission[:, 1], kind)
    return state.replace(aux=aux, mission=mission)


def make_keycorridor(
    env_id: str, room_size: int = 6, num_rows: int = 3, obj_type: int = OBJ_BALL
) -> Environment:
    num_cols = 3
    params = EnvParams(
        width=(room_size - 1) * num_cols + 1,
        height=(room_size - 1) * num_rows + 1,
        max_steps=30 * room_size * room_size,
        see_through_walls=False,
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state, ctx = RG.init(generator, state, room_size, num_rows, num_cols)
        for j in range(1, num_rows):  # the middle column becomes a corridor
            state, ctx = RG.remove_wall(state, ctx, room_size, 1, j, 3)
        room_idx = G.randint(generator, 0, num_rows, b, dev)
        state, ctx, _, door_color, _ = RG.add_door(
            generator, state, ctx, 2, room_idx, door_idx=2, locked=True
        )
        state, ctx, _, kind, color = RG.add_object(
            generator, state, ctx, room_size, 2, room_idx, kind=obj_type
        )
        key_row = G.randint(generator, 0, num_rows, b, dev)
        state, ctx, _, _, _ = RG.add_object(
            generator, state, ctx, room_size, 0, key_row, kind=OBJ_KEY, color=door_color
        )
        state = RG.place_agent(generator, state, room_size, 1, num_rows // 2)
        state, ctx = RG.connect_all(generator, state, ctx, room_size)
        return set_target(state, kind, color)

    def mission_text(c) -> str:
        return f"pick up the {IDX_TO_COLOR[c[0]]} {TYPE_NAMES[c[1]]}"

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=pickup_target_post_step,
        hook_rng=False,
        mission_text=mission_text,
    )
