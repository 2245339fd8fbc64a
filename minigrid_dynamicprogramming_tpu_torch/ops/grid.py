"""Batched grid-construction ops.

Counterparts of ``minigrid_dynamicprogramming_tpu/ops/grid.py`` over a
batch-first :class:`EnvState`.  Coordinates may be Python ints or ``(B,)``
tensors (one value per env).  Random draws take an explicit
``torch.Generator`` that lives on the state's device.

``place_obj``/``place_agent`` keep the reference's semantics — rejection
sampling of a uniform proposal (the ``top``/``size`` rectangle), which is a
uniform draw over the valid cells — as one uniform rank pick over a
validity mask, exactly like the JAX version's categorical draw (the two
draw different numbers; the layouts agree in distribution).  Object codes
and colors may also be ``(B,)`` tensors.  ``randint`` and ``permutation``
stand for ``jax.random.randint`` with per-env bounds and
``jax.random.permutation``, drawn for the whole batch from the generator.

Every generator is a fixed-shape program with no host step, so that a
CUDA graph can capture it: no tensor is made from Python data inside it
(a table comes from :func:`const`, a number fills a tensor with
:func:`vec` or :func:`assign`), nothing is read back to the host, and a
lookup is an ``index_select`` (:func:`lookup`), never an advanced index.
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

_CONSTS: dict = {}


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared after that: a generator's constant
    table.  The first call copies host data to the device, so it comes
    before a CUDA graph capture (the capture's warm-up call makes it); the
    later calls launch nothing.  The table is read, never written."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (_frozen(values), dtype, dev)
    table = _CONSTS.get(key)
    if table is None:
        table = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=dev)
    return table


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer ``idx`` of any shape: rows of
    ``table`` along its first axis, as one ``index_select``."""
    rows = table.index_select(0, idx.reshape(-1).long())
    return rows.reshape(*idx.shape, *table.shape[1:])


def vec(v, batch: int, device, dtype=torch.int32) -> torch.Tensor:
    """An int, a bool or a tensor as a fresh (B,) tensor of ``dtype``; a
    number fills it on the device."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).expand(batch).clone()
    return torch.full((batch,), v, dtype=dtype, device=device)


def assign(view: torch.Tensor, v) -> None:
    """``view[...] = v`` in place, a number written by ``fill_`` (a
    setitem of a Python number copies it from the host)."""
    if isinstance(v, torch.Tensor):
        view.copy_(v)
    else:
        view.fill_(v)


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


def _cell_value(v, plane: torch.Tensor):
    """An int stays an int; a (B,) tensor becomes (B, 1, 1) of the plane's
    dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(device=plane.device, dtype=plane.dtype).reshape(-1, 1, 1)
    return v


def paint(
    state: EnvState,
    mask: torch.Tensor,
    obj,
    color,
    obj_state=0,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
) -> EnvState:
    """Set every cell where ``mask`` ((H, W) or (B, H, W)) is True; each
    value is an int or a (B,) tensor."""
    values = (obj, color, obj_state, contains_obj, contains_color)
    out = {}
    for name, val in zip(_PLANES, values):
        plane = getattr(state, name)
        out[name] = torch.where(mask, _cell_value(val, plane), plane)
    return state.replace(**out)


def cell_mask(height: int, width: int, x, y, device) -> torch.Tensor:
    """Mask of the one cell (x, y) per env; out-of-bounds writes nothing."""
    ys, xs = coord_grids(height, width, device)
    return (ys == _per_env(y, device)) & (xs == _per_env(x, device))


def put_obj(
    state: EnvState,
    x,
    y,
    obj,
    color,
    obj_state=0,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
) -> EnvState:
    """Write one cell per env."""
    _, h, w = state.grid_obj.shape
    mask = cell_mask(h, w, x, y, state.grid_obj.device)
    return paint(state, mask, obj, color, obj_state, contains_obj, contains_color)


def set_agent(state: EnvState, x, y, agent_dir) -> EnvState:
    """Put every env's agent at (x, y) facing ``agent_dir``; each is an int
    or a (B,) tensor."""
    b, dev = state.agent_pos.shape[0], state.agent_pos.device
    return state.replace(
        agent_pos=torch.stack([vec(x, b, dev), vec(y, b, dev)], dim=1),
        agent_dir=vec(agent_dir, b, dev),
    )


def clear_cell(state: EnvState, x, y) -> EnvState:
    return put_obj(state, x, y, OBJ_EMPTY, 0, 0)


def index_hit(n: int, i, device) -> torch.Tensor:
    """(1, n) or (B, n) bool: position i of a length-n axis, per env.  An
    index outside [0, n) hits nothing (never a wrapped negative index)."""
    pos = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    if isinstance(i, torch.Tensor):
        return pos == i.to(device=device, dtype=torch.int32).reshape(-1, 1)
    return pos == int(i)


def cell_set(plane: torch.Tensor, y, x, val) -> torch.Tensor:
    """``plane[b, y, x] = val`` per env as a masked write (B, H, W); y, x
    and val are ints or (B,) tensors.  A cell outside the grid writes
    nothing, as JAX's one-hot ``cell_set`` does."""
    _, h, w = plane.shape
    mask = cell_mask(h, w, x, y, plane.device)
    return torch.where(mask, _cell_value(val, plane), plane)


def elem_set(arr: torch.Tensor, i, val) -> torch.Tensor:
    """``arr[b, i] = val`` per env on a (B, N) tensor; an index outside
    [0, N) writes nothing."""
    if isinstance(val, torch.Tensor):
        val = val.to(device=arr.device, dtype=arr.dtype).reshape(-1, 1)
    return torch.where(index_hit(arr.shape[1], i, arr.device), val, arr)


def horz_wall_mask(height: int, width: int, x, y, length, device) -> torch.Tensor:
    ys, xs = coord_grids(height, width, device)
    x, y, length = (_per_env(v, device) for v in (x, y, length))
    return (ys == y) & (xs >= x) & (xs < x + length)


def vert_wall_mask(height: int, width: int, x, y, length, device) -> torch.Tensor:
    ys, xs = coord_grids(height, width, device)
    x, y, length = (_per_env(v, device) for v in (x, y, length))
    return (xs == x) & (ys >= y) & (ys < y + length)


def horz_wall(
    state: EnvState, x: int, y: int, length: Optional[int] = None,
    obj: int = OBJ_WALL, color: int = COLOR_GREY,
) -> EnvState:
    _, h, w = state.grid_obj.shape
    length = w - x if length is None else length
    return paint(state, horz_wall_mask(h, w, x, y, length, state.grid_obj.device), obj, color)


def vert_wall(
    state: EnvState, x: int, y: int, length: Optional[int] = None,
    obj: int = OBJ_WALL, color: int = COLOR_GREY,
) -> EnvState:
    _, h, w = state.grid_obj.shape
    length = h - y if length is None else length
    return paint(state, vert_wall_mask(h, w, x, y, length, state.grid_obj.device), obj, color)


def wall_rect(state: EnvState, x: int, y: int, w: int, h: int) -> EnvState:
    """Perimeter walls of the (w, h) rectangle at (x, y)."""
    _, hh, ww = state.grid_obj.shape
    ys, xs = coord_grids(hh, ww, state.grid_obj.device)
    inside = (xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h)
    border = inside & (
        (xs == x) | (xs == x + w - 1) | (ys == y) | (ys == y + h - 1)
    )
    return paint(state, border, OBJ_WALL, COLOR_GREY)


def rect_mask(height: int, width: int, top, size, device) -> torch.Tensor:
    """Cells in the half-open rectangle [top, top + size), clipped to the
    grid: the proposal region of ``place_obj``.  ``top`` entries may be
    (B,) tensors."""
    ys, xs = coord_grids(height, width, device)
    tx, ty = (_per_env(t, device) for t in top)
    tx = tx.clamp(min=0) if isinstance(tx, torch.Tensor) else max(tx, 0)
    ty = ty.clamp(min=0) if isinstance(ty, torch.Tensor) else max(ty, 0)
    return (xs >= tx) & (xs < tx + size[0]) & (ys >= ty) & (ys < ty + size[1])


def randint(generator: torch.Generator, low, high, batch: int, device) -> torch.Tensor:
    """(B,) int32 uniform draws from [low, high); each bound is an int or a
    (B,) tensor.  Per-env bounds draw a uniform rank, as
    :func:`sample_mask_pos` does."""
    if not isinstance(low, torch.Tensor) and not isinstance(high, torch.Tensor):
        return torch.randint(
            low, high, (batch,), generator=generator, device=device, dtype=torch.int32
        )
    n = torch.as_tensor(high - low, device=device).to(torch.int64)
    u = torch.rand(batch, generator=generator, device=device)
    rank = torch.minimum((u * n.to(torch.float32)).to(torch.int64), n - 1)
    return (low + rank).to(torch.int32)


def permutation(generator: torch.Generator, batch: int, n: int, device) -> torch.Tensor:
    """(B, n) int64: a uniform permutation of range(n) per env."""
    u = torch.rand((batch, n), generator=generator, device=device)
    return u.argsort(dim=1)


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


def _valid_cells(state: EnvState, top, size, reject_mask) -> torch.Tensor:
    """Free cells inside the proposal rectangle (the whole grid unless
    ``top`` or ``size`` is given) that ``reject_mask`` does not mark."""
    valid = free_cell_mask(state)
    if top is not None or size is not None:
        _, h, w = state.grid_obj.shape
        top = (0, 0) if top is None else top
        size = (w, h) if size is None else size
        valid = valid & rect_mask(h, w, top, size, valid.device)
    if reject_mask is not None:
        valid = valid & ~reject_mask
    return valid


def place_obj(
    generator: torch.Generator,
    state: EnvState,
    obj,
    color,
    obj_state=0,
    top=None,
    size=None,
    reject_mask: Optional[torch.Tensor] = None,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
):
    """Place ``obj`` uniformly over valid cells.  Returns (state, (x, y), ok).

    ``top``/``size`` bound the proposal rectangle; ``reject_mask`` marks
    disallowed cells.  Envs with no valid cell keep their grid unchanged
    (ok False)."""
    valid = _valid_cells(state, top, size, reject_mask)
    x, y, ok = sample_mask_pos(generator, valid)
    _, h, w = state.grid_obj.shape
    mask = cell_mask(h, w, x, y, valid.device) & ok.reshape(-1, 1, 1)
    state = paint(state, mask, obj, color, obj_state, contains_obj, contains_color)
    return state, (x, y), ok


def place_agent(
    generator: torch.Generator,
    state: EnvState,
    top=None,
    size=None,
    rand_dir: bool = True,
    reject_mask: Optional[torch.Tensor] = None,
):
    """Sample an empty cell (and a direction) for the agent, inside the
    ``top``/``size`` rectangle.  Returns (state, ok)."""
    valid = _valid_cells(state, top, size, reject_mask)
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
