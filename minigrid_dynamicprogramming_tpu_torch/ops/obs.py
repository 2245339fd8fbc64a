"""The egocentric view of batch-first states.

Counterpart of ``minigrid_dynamicprogramming_tpu/ops/obs.py:91-203``, the
view helpers that the environment record, the wrappers and the renderer
call on batch-first states.  The port keeps one engine, so each helper
turns the ``(B, ...)`` state lane-major (``parallel/lanes.py:to_lanes``),
runs the lane encoder (``obs_lanes``) and transposes back.  ``x`` and
``y`` of the coordinate helpers are Python ints, 0-d tensors or ``(B,)``
tensors.

Layouts, as in JAX: the planes of :func:`gen_obs_planes` are ``[vy, vx]``
with the agent at ``vy = view - 1, vx = view // 2`` facing up; the image
and the visibility mask are ``[vx, vy]`` (the reference's ``[x, y]`` wire
layout).
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_EMPTY, OBJ_UNSEEN
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L


def gen_obs_planes(params: EnvParams, state: EnvState):
    """``(obj, color, obj_state, vis)``, each ``(B, view, view)`` indexed
    ``[vy, vx]``; the planes hold what lies under unseen cells too."""
    v = params.agent_view_size
    planes = L.obs_lanes(params, L.to_lanes(state))
    return tuple(p.T.reshape(-1, v, v) for p in planes)


def gen_obs_image(params: EnvParams, state: EnvState) -> torch.Tensor:
    """``(B, view, view, 3)`` uint8 in the ``[x, y]`` layout; unseen cells
    encode as zeros."""
    return L.obs_image_lanes(params, L.to_lanes(state))


def agent_view_visible_mask(params: EnvParams, state: EnvState) -> torch.Tensor:
    """``(B, view, view)`` bool visibility mask in the ``[vx, vy]`` layout."""
    return gen_obs_planes(params, state)[3].transpose(1, 2)


def get_view_coords(params: EnvParams, state: EnvState, x, y):
    """World cell ``(x, y)`` -> agent-view coordinates ``(vx, vy)``, each
    ``(B,)``; either may be negative or past the view
    (``MiniGridEnv.get_view_coords``)."""
    sz = params.agent_view_size
    hs = sz // 2
    dx, dy = L._dir_vec(state.agent_dir)
    rx, ry = -dy, dx
    tx = state.agent_pos[:, 0] + dx * (sz - 1) - rx * hs
    ty = state.agent_pos[:, 1] + dy * (sz - 1) - ry * hs
    lx = x - tx
    ly = y - ty
    return rx * lx + ry * ly, -(dx * lx + dy * ly)


def in_view(params: EnvParams, state: EnvState, x, y) -> torch.Tensor:
    """``(B,)`` bool: world cell ``(x, y)`` lies inside the view rectangle
    (``MiniGridEnv.in_view``); occlusion is :func:`agent_sees`."""
    vx, vy = get_view_coords(params, state, x, y)
    sz = params.agent_view_size
    return (vx >= 0) & (vy >= 0) & (vx < sz) & (vy < sz)


def agent_sees(params: EnvParams, state: EnvState, x, y) -> torch.Tensor:
    """``(B,)`` bool: the non-empty world cell ``(x, y)`` shows in the
    encoded observation with its own type (``MiniGridEnv.agent_sees``);
    an empty world cell gives False."""
    b = state.agent_dir.shape[0]
    sz = params.agent_view_size
    vx, vy = get_view_coords(params, state, x, y)
    inb = (vx >= 0) & (vy >= 0) & (vx < sz) & (vy < sz)
    img = gen_obs_image(params, state)
    rows = torch.arange(b, device=img.device)
    obs_type = img[rows, vx.clamp(0, sz - 1).long(), vy.clamp(0, sz - 1).long(), 0]
    dev = state.grid_obj.device
    cx = torch.as_tensor(x, device=dev).clamp(0, params.width - 1).long().expand(b)
    cy = torch.as_tensor(y, device=dev).clamp(0, params.height - 1).long().expand(b)
    world_type = state.grid_obj[rows, cy, cx]
    obs_nonempty = (obs_type != OBJ_UNSEEN) & (obs_type != OBJ_EMPTY)
    return inb & obs_nonempty & (obs_type == world_type)
