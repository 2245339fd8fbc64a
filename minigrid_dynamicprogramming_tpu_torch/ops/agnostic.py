"""Lane-major hook toolkit.

Counterpart of the lane-major half of
``minigrid_dynamicprogramming_tpu/ops/agnostic.py``.  The per-family hooks
(``core/env.py``) are written against these helpers over a
:class:`~..parallel.lanes.LaneState`: grid planes ``(H*W, B)``, per-env
scalars ``(B,)``.  The JAX module also serves the batch-first layout under
``vmap``; the port keeps one batch-last engine, so only the lane half is
here.

Cell indices follow the JAX one-hot semantics exactly: a cell is the flat
index ``y * W + x``; a read whose index is outside ``[0, H*W)`` gives 0
and such a write writes nothing.  Random draws (``sample_mask_pos``) take
one uniform number per env from a ``torch.Generator``: the port's draws
differ from JAX's per-env threefry keys, and agree in distribution.
"""

from __future__ import annotations

from typing import Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_EMPTY
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams
from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import (
    LaneState,
    _dir_vec,
    _read,
    _write,
    select_lanes,
)

# Planes a registry gate declares constant for the family: writes to them
# are dropped (they would write back what is there).
_GATED_PLANES = {
    "no_boxes": ("contains_obj", "contains_color"),
    "no_marks": ("marks", "vmarks"),
}


def dir_vec(agent_dir: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DIR_TO_VEC`` per env: (dx, dy) int32."""
    return _dir_vec(agent_dir)


def agent_xy(ls: LaneState) -> Tuple[torch.Tensor, torch.Tensor]:
    return ls.agent_x, ls.agent_y


def _cell(params: EnvParams, x, y, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in-range (B,) bool, clamped flat index (B,) int64) of cell (x, y)."""
    hw = params.height * params.width
    idx = torch.as_tensor(y, device=device) * params.width + torch.as_tensor(x, device=device)
    inside = (idx >= 0) & (idx < hw)
    return inside, idx.clamp(0, hw - 1).to(torch.int64)


def read_cell(params: EnvParams, ls: LaneState, field: str, x, y) -> torch.Tensor:
    """``plane[y * W + x]`` of one named plane, per env."""
    plane = getattr(ls, field)
    inside, idx = _cell(params, x, y, plane.device)
    return torch.where(inside, _read(plane, idx), 0).to(plane.dtype)


def write_cell(params: EnvParams, ls: LaneState, x, y, do, **values) -> LaneState:
    """Write named planes at per-env (x, y) where ``do`` holds.

    ``values`` maps a plane's field name to its new value (an int or a
    (B,) tensor).  Planes gated off for the family are left out."""
    for flag, fields in _GATED_PLANES.items():
        if params.opt(flag, False):
            values = {k: v for k, v in values.items() if k not in fields}
    inside, idx = _cell(params, x, y, ls.grid_obj.device)
    hit = inside & do
    upd = {}
    for name, val in values.items():
        plane = getattr(ls, name)
        new = torch.where(hit, val, _read(plane, idx))
        upd[name] = _write(plane, idx, new)
    return ls.replace(**upd)


def put_obj(params, ls, x, y, obj, color, obj_state=0, do=True) -> LaneState:
    return write_cell(
        params, ls, x, y, do,
        grid_obj=obj, grid_color=color, grid_state=obj_state,
        contains_obj=OBJ_EMPTY, contains_color=0,
    )


def clear_cell(params, ls, x, y, do=True) -> LaneState:
    return put_obj(params, ls, x, y, OBJ_EMPTY, 0, 0, do=do)


def cell_coords(params: EnvParams, ls: LaneState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys) int32 of shape (HW, 1): they broadcast over the lanes."""
    flat = torch.arange(
        params.height * params.width, dtype=torch.int32, device=ls.grid_obj.device
    )[:, None]
    return flat % params.width, flat // params.width


def free_cell_mask(params: EnvParams, ls: LaneState) -> torch.Tensor:
    """(HW, B): empty cells other than the agent's."""
    xs, ys = cell_coords(params, ls)
    not_agent = ~((xs == ls.agent_x) & (ys == ls.agent_y))
    return (ls.grid_obj == OBJ_EMPTY) & not_agent


def rect_mask(params: EnvParams, ls: LaneState, top, size) -> torch.Tensor:
    """(HW, B): cells in the half-open rectangle [top, top + size), its
    corner clipped at 0; ``top`` entries may be (B,) tensors."""
    xs, ys = cell_coords(params, ls)
    tx = torch.as_tensor(top[0], device=xs.device).clamp(min=0)
    ty = torch.as_tensor(top[1], device=xs.device).clamp(min=0)
    return (xs >= tx) & (xs < tx + size[0]) & (ys >= ty) & (ys < ty + size[1])


def sample_mask_pos(
    params: EnvParams, generator: torch.Generator, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform draw over the True cells of each lane of ``mask`` (HW, B).

    Returns int32 (x, y, ok), each (B,); a lane with no True cell gets
    ok False and (x, y) = (0, 0)."""
    count = mask.sum(dim=0)
    u = torch.rand(mask.shape[1], generator=generator, device=mask.device)
    rank = torch.minimum(
        (u * count.to(torch.float32)).to(torch.int64), (count - 1).clamp(min=0)
    )
    # The (rank+1)-th True cell: the cells whose running count is <= rank.
    idx = (mask.cumsum(dim=0) <= rank[None, :]).sum(dim=0)
    ok = count > 0
    idx = torch.where(ok, idx, 0).to(torch.int32)
    return idx % params.width, idx // params.width, ok


def select_state(cond: torch.Tensor, a: LaneState, b: LaneState) -> LaneState:
    """Per-env ``where(cond, a, b)``."""
    return select_lanes(cond, a, b)


def reduce_any_cells(params: EnvParams, ls: LaneState, mask: torch.Tensor) -> torch.Tensor:
    """``any`` over the cell axis of an (HW, B) mask: (B,) bool."""
    return mask.any(dim=0)


def reduce_sum_cells(params: EnvParams, ls: LaneState, x: torch.Tensor) -> torch.Tensor:
    """Sum over the cell axis of an (HW, B) plane: (B,)."""
    return x.sum(dim=0)


def shift_cells(params: EnvParams, ls: LaneState, mask: torch.Tensor, dx: int, dy: int):
    """An (HW, B) plane shifted by a static (dx, dy), zero-filled:
    ``out[y, x] = mask[y - dy, x - dx]``, and 0 where (x - dx, y - dy) is
    off the grid.  Cells shifted past an edge are dropped, never wrapped
    onto the opposite edge or the next row."""
    h, w = params.height, params.width
    m = mask.reshape(h, w, -1)
    out = torch.zeros_like(m)
    ys, yd = slice(max(-dy, 0), h - max(dy, 0)), slice(max(dy, 0), h - max(-dy, 0))
    xs, xd = slice(max(-dx, 0), w - max(dx, 0)), slice(max(dx, 0), w - max(-dx, 0))
    out[yd, xd] = m[ys, xs]
    return out.reshape(h * w, -1)
