"""Batched grid-construction ops.

Counterparts of ``minigrid_dynamicprogramming_tpu/ops/grid.py`` over a
batch-first :class:`EnvState`.  Coordinates may be Python ints or ``(B,)``
tensors (one value per env).  Random draws take an explicit
``torch.Generator`` that lives on the state's device.

``place_obj``/``place_agent`` keep the reference's semantics — rejection
sampling of a uniform proposal, which is a uniform draw over the valid
cells — as one uniform rank pick over a validity mask, exactly like the JAX
version's categorical draw (the two draw different numbers; the layouts
agree in distribution).  The proposal-rectangle arguments (``top``/``size``)
of the JAX builders wait for the env families that use them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREY,
    OBJ_EMPTY,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState

_PLANES = ("grid_obj", "grid_color", "grid_state", "contains_obj", "contains_color")


def _per_env(v, device):
    """An int stays an int; a (B,) tensor becomes (B, 1, 1) int32, so either
    broadcasts against (H, W) index planes."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(-1, 1, 1)
    return int(v)


def coord_grids(height: int, width: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys, xs) int32 index planes of shape (H, W)."""
    ys = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    xs = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    return ys.expand(height, width), xs.expand(height, width)


def paint(
    state: EnvState,
    mask: torch.Tensor,
    obj: int,
    color: int,
    obj_state: int = 0,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
) -> EnvState:
    """Set every cell where ``mask`` ((H, W) or (B, H, W)) is True."""
    values = (obj, color, obj_state, contains_obj, contains_color)
    return state.replace(
        **{
            name: torch.where(mask, val, getattr(state, name))
            for name, val in zip(_PLANES, values)
        }
    )


def cell_mask(height: int, width: int, x, y, device) -> torch.Tensor:
    """Mask of the one cell (x, y) per env; out-of-bounds writes nothing."""
    ys, xs = coord_grids(height, width, device)
    return (ys == _per_env(y, device)) & (xs == _per_env(x, device))


def put_obj(
    state: EnvState,
    x,
    y,
    obj: int,
    color: int,
    obj_state: int = 0,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
) -> EnvState:
    """Write one cell per env."""
    _, h, w = state.grid_obj.shape
    mask = cell_mask(h, w, x, y, state.grid_obj.device)
    return paint(state, mask, obj, color, obj_state, contains_obj, contains_color)


def vert_wall_mask(height: int, width: int, x, y, length, device) -> torch.Tensor:
    ys, xs = coord_grids(height, width, device)
    x, y, length = (_per_env(v, device) for v in (x, y, length))
    return (xs == x) & (ys >= y) & (ys < y + length)


def wall_rect(state: EnvState, x: int, y: int, w: int, h: int) -> EnvState:
    """Perimeter walls of the (w, h) rectangle at (x, y)."""
    _, hh, ww = state.grid_obj.shape
    ys, xs = coord_grids(hh, ww, state.grid_obj.device)
    inside = (xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h)
    border = inside & (
        (xs == x) | (xs == x + w - 1) | (ys == y) | (ys == y + h - 1)
    )
    return paint(state, border, OBJ_WALL, COLOR_GREY)


def sample_mask_pos(
    generator: torch.Generator, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform draw over the True cells of each env's (H, W) mask.

    ``mask`` is (B, H, W).  Returns int32 (x, y, ok), each (B,); where an
    env's mask has no True cell, ok is False and (x, y) = (0, 0)."""
    b, h, w = mask.shape
    flat = mask.reshape(b, h * w)
    count = flat.sum(dim=1)
    u = torch.rand(b, generator=generator, device=mask.device)
    rank = torch.minimum(
        (u * count.to(torch.float32)).to(torch.int64), (count - 1).clamp(min=0)
    )
    # Index of the (rank+1)-th True cell: the number of cells whose running
    # count of True cells is still <= rank.
    idx = (flat.cumsum(dim=1) <= rank[:, None]).sum(dim=1)
    ok = count > 0
    idx = torch.where(ok, idx, 0).to(torch.int32)
    return idx % w, idx // w, ok


def free_cell_mask(state: EnvState) -> torch.Tensor:
    """Cells where place_obj may land: empty and not the agent's cell."""
    _, h, w = state.grid_obj.shape
    ys, xs = coord_grids(h, w, state.grid_obj.device)
    ax = state.agent_pos[:, 0].reshape(-1, 1, 1)
    ay = state.agent_pos[:, 1].reshape(-1, 1, 1)
    not_agent = ~((xs == ax) & (ys == ay))
    return (state.grid_obj == OBJ_EMPTY) & not_agent


def place_obj(
    generator: torch.Generator,
    state: EnvState,
    obj: int,
    color: int,
    obj_state: int = 0,
    reject_mask: Optional[torch.Tensor] = None,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
):
    """Place ``obj`` uniformly over valid cells.  Returns (state, (x, y), ok).

    ``reject_mask`` marks disallowed cells.  Envs with no valid cell keep
    their grid unchanged (ok False)."""
    valid = free_cell_mask(state)
    if reject_mask is not None:
        valid = valid & ~reject_mask
    x, y, ok = sample_mask_pos(generator, valid)
    _, h, w = state.grid_obj.shape
    mask = cell_mask(h, w, x, y, valid.device) & ok.reshape(-1, 1, 1)
    state = paint(state, mask, obj, color, obj_state, contains_obj, contains_color)
    return state, (x, y), ok


def place_agent(
    generator: torch.Generator,
    state: EnvState,
    rand_dir: bool = True,
    reject_mask: Optional[torch.Tensor] = None,
):
    """Sample an empty cell (and a direction) for the agent.
    Returns (state, ok)."""
    valid = free_cell_mask(state)
    if reject_mask is not None:
        valid = valid & ~reject_mask
    x, y, ok = sample_mask_pos(generator, valid)
    b = valid.shape[0]
    if rand_dir:
        new_dir = torch.randint(
            0, 4, (b,), generator=generator, device=valid.device,
            dtype=torch.int32,
        )
    else:
        new_dir = state.agent_dir
    pos = torch.stack([x, y], dim=1)
    return (
        state.replace(
            agent_pos=torch.where(ok[:, None], pos, state.agent_pos),
            agent_dir=torch.where(ok, new_dir, state.agent_dir),
        ),
        ok,
    )
