"""GoToDoor: a room of random size (at least 5) in the grid's top-left
corner, four doors of distinct colors, one on each wall; ``done`` next to
the target door pays, ``toggle`` and ``done`` end the episode.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/gotodoor.py``.  The
target's cell is in aux slots 0-1, its color in mission slot 0.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_DONE,
    ACT_TOGGLE,
    COLOR_GREY,
    IDX_TO_COLOR,
    OBJ_DOOR,
    OBJ_WALL,
    STATE_CLOSED,
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


def done_next_to_target(p, generator, prev, ls, action, reward, terminated):
    """Post-step hook of GoToDoor and GoToObject: ``done`` while 4-adjacent
    to the target in aux slots 0-1 pays the success reward; ``toggle`` and
    ``done`` end the episode."""
    dx = (ls.agent_x - ls.aux[0]).abs()
    dy = (ls.agent_y - ls.aux[1]).abs()
    adjacent = ((dx == 0) & (dy == 1)) | ((dy == 0) & (dx == 1))
    is_done = action == ACT_DONE
    reward = torch.where(
        is_done & adjacent, success_reward(ls.step_count, p.max_steps), reward
    )
    return ls, reward, terminated | (action == ACT_TOGGLE) | is_done


def make_gotodoor(env_id: str, size: int = 5) -> Environment:
    assert size >= 5
    params = EnvParams(
        width=size, height=size, max_steps=4 * size * size, see_through_walls=True
    )

    def generate(
        generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"
    ) -> EnvState:
        dev = resolve_device(device)
        b, h, w = batch_size, p.height, p.width
        state = new_state(b, h, w, dev)
        # The room's size: width and height in [5, size].
        rw = G.randint(generator, 5, w + 1, b, dev)
        rh = G.randint(generator, 5, h + 1, b, dev)
        ys, xs = G.coord_grids(h, w, dev)
        rw3, rh3 = rw.reshape(-1, 1, 1), rh.reshape(-1, 1, 1)
        border = ((xs == 0) | (xs == rw3 - 1) | (ys == 0) | (ys == rh3 - 1)) & (
            (xs < rw3) & (ys < rh3)
        )
        state = G.paint(state, border, OBJ_WALL, COLOR_GREY)

        # A door on each wall: top, bottom, left, right.
        zero = torch.zeros(b, dtype=torch.int32, device=dev)
        door_x = torch.stack([
            G.randint(generator, 2, rw - 2, b, dev),
            G.randint(generator, 2, rw - 2, b, dev),
            zero,
            rw - 1,
        ], dim=1)
        door_y = torch.stack([
            zero,
            rh - 1,
            G.randint(generator, 2, rh - 2, b, dev),
            G.randint(generator, 2, rh - 2, b, dev),
        ], dim=1)
        colors = G.permutation(generator, b, 6, dev)[:, :4]
        for i in range(4):
            state = G.put_obj(
                state, door_x[:, i], door_y[:, i], OBJ_DOOR, colors[:, i], STATE_CLOSED
            )

        inside = (xs < rw3) & (ys < rh3)
        state, _ = G.place_agent(generator, state, reject_mask=~inside)

        tgt = G.randint(generator, 0, 4, b, dev).long()[:, None]
        aux, mission = state.aux.clone(), state.mission.clone()
        aux[:, 0] = door_x.gather(1, tgt)[:, 0]
        aux[:, 1] = door_y.gather(1, tgt)[:, 0]
        mission[:, 0] = colors.gather(1, tgt)[:, 0]
        return state.replace(aux=aux, mission=mission)

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=done_next_to_target,
        hook_rng=False,
        mission_text=lambda c: f"go to the {IDX_TO_COLOR[c[0]]} door",
    )
