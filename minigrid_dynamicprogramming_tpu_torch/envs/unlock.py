"""Unlock, UnlockPickup and BlockedUnlockPickup: a 1x2 RoomGrid with a
locked door between the rooms and its key in the left room.  Unlock pays
for opening the door; UnlockPickup adds a target box in the right room,
and BlockedUnlockPickup also blocks the door with a ball.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/unlock.py``.
Unlock's aux slots 0-1 hold the door's cell; the pickup variants' hold
the target box's (type, color), and mission slot 0 its color.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_TOGGLE,
    IDX_TO_COLOR,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_KEY,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.envs.keycorridor import (
    pickup_target_post_step,
    set_target,
)
from minigrid_dynamicprogramming_tpu_torch.ops import agnostic as AG
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as RG
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

ROOM_SIZE = 6


def _params(max_steps_mult: int) -> EnvParams:
    return EnvParams(
        width=(ROOM_SIZE - 1) * 2 + 1,
        height=ROOM_SIZE,
        max_steps=max_steps_mult * ROOM_SIZE * ROOM_SIZE,
        see_through_walls=False,
    )


def _unlock_post_step(p, generator, prev, ls, action, reward, terminated):
    """A toggle that leaves the door (at aux slots 0-1) open pays and ends
    the episode."""
    door_open = AG.read_cell(p, ls, "grid_state", ls.aux[0], ls.aux[1]) == STATE_OPEN
    won = (action == ACT_TOGGLE) & door_open
    reward = torch.where(won, success_reward(ls.step_count, p.max_steps), reward)
    return ls, reward, terminated | won


def make_unlock(env_id: str) -> Environment:
    params = _params(8)

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        state = new_state(batch_size, p.height, p.width, dev)
        state, ctx = RG.init(generator, state, ROOM_SIZE, 1, 2)
        state, ctx, (dx, dy), door_color, _ = RG.add_door(
            generator, state, ctx, 0, 0, door_idx=0, locked=True
        )
        state, ctx, _, _, _ = RG.add_object(
            generator, state, ctx, ROOM_SIZE, 0, 0, kind=OBJ_KEY, color=door_color
        )
        state = RG.place_agent(generator, state, ROOM_SIZE, 0, 0)
        aux = state.aux.clone()
        aux[:, 0], aux[:, 1] = dx, dy
        return state.replace(aux=aux)

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=_unlock_post_step,
        hook_rng=False,
        mission_text=lambda c: "open the door",
    )


def _make_pickup_variant(env_id: str, blocked: bool) -> Environment:
    params = _params(16 if blocked else 8)

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b = batch_size
        state = new_state(b, p.height, p.width, dev)
        state, ctx = RG.init(generator, state, ROOM_SIZE, 1, 2)
        state, ctx, _, kind, box_color = RG.add_object(
            generator, state, ctx, ROOM_SIZE, 1, 0, kind=OBJ_BOX
        )
        state, ctx, (dx, dy), door_color, _ = RG.add_door(
            generator, state, ctx, 0, 0, door_idx=0, locked=True
        )
        if blocked:  # a ball right in front of the door, on the key's side
            ball_color = G.randint(generator, 0, 6, b, dev)
            state = G.put_obj(state, dx - 1, dy, OBJ_BALL, ball_color)
        state, ctx, _, _, _ = RG.add_object(
            generator, state, ctx, ROOM_SIZE, 0, 0, kind=OBJ_KEY, color=door_color
        )
        state = RG.place_agent(generator, state, ROOM_SIZE, 0, 0)
        return set_target(state, kind, box_color, mission_kind=False)

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=pickup_target_post_step,
        hook_rng=False,
        mission_text=lambda c: f"pick up the {IDX_TO_COLOR[c[0]]} box",
    )


def make_unlockpickup(env_id: str) -> Environment:
    return _make_pickup_variant(env_id, blocked=False)


def make_blockedunlockpickup(env_id: str) -> Environment:
    return _make_pickup_variant(env_id, blocked=True)
