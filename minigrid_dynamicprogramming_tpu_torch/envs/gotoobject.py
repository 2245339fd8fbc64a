"""GoToObject: ``num_objs`` objects of distinct (type, color); ``done``
next to the target pays, ``toggle`` and ``done`` end the episode.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/gotoobject.py``.
The target's cell is in aux slots 0-1, its (color, type) in mission slots
0-1.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    IDX_TO_COLOR,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_KEY,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.envs.gotodoor import done_next_to_target
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G

TYPES = (OBJ_KEY, OBJ_BALL, OBJ_BOX)
TYPE_NAMES = {OBJ_KEY: "key", OBJ_BALL: "ball", OBJ_BOX: "box"}


def distinct_type_color_prefix(generator, batch: int, k: int, device):
    """(types, colors), each (B, k) int32: a uniform ordered draw of k
    distinct (type, color) pairs, the prefix of a permutation of the 18."""
    perm = G.permutation(generator, batch, len(TYPES) * 6, device)[:, :k]
    types = G.lookup(G.const(TYPES, torch.int32, device), perm // 6)
    return types, (perm % 6).to(torch.int32)


def place_objects(generator, state: EnvState, types, colors, near_reject: bool = False):
    """Place object i of (types, colors) on a uniform free cell, in order;
    with ``near_reject`` no cell within Chebyshev distance 1 of an earlier
    object.  Returns (state, xs, ys), each of the last two (B, k) int32."""
    b, h, w = state.grid_obj.shape
    ys_g, xs_g = G.coord_grids(h, w, state.grid_obj.device)
    near = torch.zeros((b, h, w), dtype=torch.bool, device=state.grid_obj.device)
    pos_x, pos_y = [], []
    for i in range(types.shape[1]):
        state, (x, y), _ = G.place_obj(
            generator, state, types[:, i], colors[:, i],
            reject_mask=near if near_reject else None,
        )
        pos_x.append(x)
        pos_y.append(y)
        if near_reject:
            near = near | (
                ((xs_g - x.reshape(-1, 1, 1)).abs() <= 1)
                & ((ys_g - y.reshape(-1, 1, 1)).abs() <= 1)
            )
    return state, torch.stack(pos_x, dim=1), torch.stack(pos_y, dim=1)


def make_gotoobject(env_id: str, size: int = 6, num_objs: int = 2) -> Environment:
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
        types, colors = distinct_type_color_prefix(generator, b, num_objs, dev)
        state, pos_x, pos_y = place_objects(generator, state, types, colors)
        state, _ = G.place_agent(generator, state)
        tgt = G.randint(generator, 0, num_objs, b, dev).long()[:, None]
        aux, mission = state.aux.clone(), state.mission.clone()
        aux[:, 0] = pos_x.gather(1, tgt)[:, 0]
        aux[:, 1] = pos_y.gather(1, tgt)[:, 0]
        mission[:, 0] = colors.gather(1, tgt)[:, 0]
        mission[:, 1] = types.gather(1, tgt)[:, 0]
        return state.replace(aux=aux, mission=mission)

    def mission_text(c) -> str:
        return f"go to the {IDX_TO_COLOR[c[0]]} {TYPE_NAMES[c[1]]}"

    return Environment(
        env_id,
        params,
        generate,
        post_step_lanes=done_next_to_target,
        hook_rng=False,
        mission_text=mission_text,
    )
