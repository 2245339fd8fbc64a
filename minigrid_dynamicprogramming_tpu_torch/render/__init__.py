"""RGB frames of batch-first states, rendered on the states' device.

Counterpart of ``minigrid_dynamicprogramming_tpu/render/__init__.py``.  The
reference composes frames tile by tile in Python with an LRU tile cache
(minigrid ``core/grid.py:200-242``, ``get_frame`` ``minigrid_env.py:711-734``).
Here each cell's (obj, color, state, agent, highlight) tuple indexes the
pre-rasterized tile table (:mod:`.tiles`), and the frame is one row gather
from that table (a tile's pixel row per index) straight into the
``(B, H*ts, W*ts, 3)`` pixel layout.

Batch-first, where JAX's functions are one env's that ``vmap`` batches:

    render_frame(params, state, tile_size, highlight) -> (B, H*ts, W*ts, 3) u8
    render_pov(params, state, tile_size)              -> (B, v*ts, v*ts, 3) u8
    view_highlight_mask(params, state)                -> (B, H, W) bool

The table lives on the state's device (``tiles.tile_lut_tensor``), so a
frame of a state on the card is made on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu_torch.ops.obs import gen_obs_planes
from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import _dir_vec
from minigrid_dynamicprogramming_tpu_torch.render.tiles import (
    N_AGENT,
    N_COLOR,
    N_HL,
    N_STATE,
    TILE_PIXELS,
    tile_lut_tensor,
)

__all__ = ["render_frame", "render_pov", "view_highlight_mask", "render_frame_np", "TILE_PIXELS"]


def _compose(obj, color, st, agent_code, hl, tile_size: int) -> torch.Tensor:
    """Gather each cell's tile by key into the frame: ``(B, h, w)`` keys
    give ``(B, h*ts, w*ts, 3)`` pixels."""
    lut = tile_lut_tensor(tile_size, obj.device)
    key = (
        ((obj.to(torch.int64) * N_COLOR + color) * N_STATE + st) * N_AGENT + agent_code
    ) * N_HL + hl
    b, h, w = obj.shape
    # One pixel row of one tile (ts * 3 bytes) per index, ordered
    # (B, h, tile row, w): the frame's row-major pixel order.
    py = torch.arange(tile_size, device=obj.device)[:, None]
    rows = key[:, :, None, :] * tile_size + py
    frame = lut.reshape(-1, tile_size * 3).index_select(0, rows.reshape(-1))
    return frame.reshape(b, h * tile_size, w * tile_size, 3)


def view_highlight_mask(params: EnvParams, state: EnvState) -> torch.Tensor:
    """``(B, H, W)`` bool: the world cells inside each agent's visible view
    cone, the vis-mask projection of ``get_full_render``
    (``minigrid_env.py:663-699``)."""
    view = params.agent_view_size
    hs = view // 2
    h, w = params.height, params.width
    vis = gen_obs_planes(params, state)[3]  # [vy, vx]
    b = vis.shape[0]
    dev = vis.device

    dx, dy = (d.view(b, 1, 1) for d in _dir_vec(state.agent_dir))
    rx, ry = -dy, dx
    vy = torch.arange(view, dtype=torch.int32, device=dev)[:, None]
    vx = torch.arange(view, dtype=torch.int32, device=dev)[None, :]
    ax = state.agent_pos[:, 0].view(b, 1, 1)
    ay = state.agent_pos[:, 1].view(b, 1, 1)
    wx = ax + dx * (view - 1 - vy) + rx * (vx - hs)
    wy = ay + dy * (view - 1 - vy) + ry * (vx - hs)
    ok = vis & (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    # Visible view cells scatter into the world; the others go to a spare
    # cell past the grid, dropped below (a -1 index would wrap).
    cell = torch.where(ok, wy * w + wx, h * w).to(torch.int64).reshape(b, -1)
    hit = torch.zeros(b, h * w + 1, dtype=torch.bool, device=dev)
    hit.scatter_(1, cell, True)
    return hit[:, : h * w].reshape(b, h, w)


def render_frame(
    params: EnvParams,
    state: EnvState,
    tile_size: int = TILE_PIXELS,
    highlight: bool = True,
) -> torch.Tensor:
    """Full-grid RGB frames, ``get_full_render`` (``minigrid_env.py:663-709``)
    of each env: ``(B, H*ts, W*ts, 3)`` uint8."""
    h, w = params.height, params.width
    dev = state.grid_obj.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ax = state.agent_pos[:, 0].view(-1, 1, 1)
    ay = state.agent_pos[:, 1].view(-1, 1, 1)
    agent_here = (xs == ax) & (ys == ay)
    agent_code = torch.where(agent_here, state.agent_dir.view(-1, 1, 1) + 1, 0)
    if highlight:
        hl = view_highlight_mask(params, state).to(torch.int64)
    else:
        hl = torch.zeros_like(agent_code)
    return _compose(
        state.grid_obj, state.grid_color, state.grid_state, agent_code, hl, tile_size
    )


def render_pov(
    params: EnvParams,
    state: EnvState,
    tile_size: int = TILE_PIXELS,
) -> torch.Tensor:
    """Each agent's POV RGB frame, ``get_pov_render``
    (``minigrid_env.py:647-661``): the egocentric view drawn with the agent
    at (view//2, view-1) facing up (dir 3) and the visibility mask as the
    highlight.  ``(B, v*ts, v*ts, 3)`` uint8."""
    view = params.agent_view_size
    obj, color, st, vis = gen_obs_planes(params, state)  # [vy, vx]
    if not params.see_through_walls:
        # process_vis blanks invisible cells to None in the sliced grid
        # (grid.py:323-326), so they render as empty tiles.
        obj = torch.where(vis, obj, 1)
        color = torch.where(vis, color, 0)
        st = torch.where(vis, st, 0)
    dev = obj.device
    vy = torch.arange(view, device=dev)[:, None]
    vx = torch.arange(view, device=dev)[None, :]
    # The carried object already overlays the agent cell in the planes
    # (gen_obs_grid, minigrid_env.py:618-625).
    agent_code = torch.where((vx == view // 2) & (vy == view - 1), 3 + 1, 0)
    agent_code = agent_code.expand(obj.shape[0], view, view)
    return _compose(obj, color, st, agent_code, vis.to(torch.int64), tile_size)


def render_frame_np(env, state: EnvState, tile_size: int = TILE_PIXELS, highlight: bool = True) -> np.ndarray:
    """Host convenience: the frames of ``state`` as a numpy array
    ``(B, H*ts, W*ts, 3)``."""
    return render_frame(env.params, state, tile_size, highlight).cpu().numpy()
