"""The RoomGrid scaffold, batched.

Counterpart of ``minigrid_dynamicprogramming_tpu/ops/roomgrid.py`` over a
batch-first :class:`EnvState`: a lattice of rooms at pitch ``room_size - 1``
with one door slot drawn per room edge, and the verbs the RoomGrid
families build their levels from (``add_door``, ``remove_wall``,
``add_object``/``place_in_room``, ``place_agent``, ``connect_all``,
``add_distractors``).

The per-episode room topology is a :class:`RoomCtx` of ``(B, rows, cols,
4)`` tensors carried through generation; room, row and column counts are
Python ints.  A room index ``i`` (column) or ``j`` (row) and a door slot
``k`` may be an int or a ``(B,)`` tensor.  Every write is a masked select,
so a rejected write is masked out, never aimed at index -1 (which torch
would wrap to the last cell).  Door-slot directions follow the reference:
0 = right, 1 = down, 2 = left, 3 = up.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREY,
    DIR_TO_VEC,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
    STATE_CLOSED,
    STATE_LOCKED,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G

# Edge states (the reference's Room.doors: None / Door / True).
EDGE_NONE = 0
EDGE_DOOR = 1
EDGE_OPEN = 2  # wall removed

OBJ_KINDS = (OBJ_KEY, OBJ_BALL, OBJ_BOX)
_DI = (1, 0, -1, 0)  # column step of edge k
_DJ = (0, 1, 0, -1)  # row step of edge k


@dataclass
class RoomCtx:
    """Per-episode room topology, batch-first."""

    door_x: torch.Tensor  # (B, rows, cols, 4) i32 — door-slot x per room edge
    door_y: torch.Tensor  # (B, rows, cols, 4) i32
    has_edge: torch.Tensor  # (B, rows, cols, 4) bool — a neighbour exists
    edge: torch.Tensor  # (B, rows, cols, 4) i32 — EDGE_NONE / DOOR / OPEN
    locked: torch.Tensor  # (B, rows, cols) bool
    used: torch.Tensor  # (B, 3, 6) bool — (kind, color) combos placed

    def replace(self, **changes) -> "RoomCtx":
        return dataclasses.replace(self, **changes)


def _room_mask(rows: int, cols: int, i, j, device) -> torch.Tensor:
    """(B or 1, rows, cols) bool: room (i, j) per env."""
    hit_j = G.index_hit(rows, j, device)[:, :, None]
    hit_i = G.index_hit(cols, i, device)[:, None, :]
    return hit_j & hit_i


def _at_room(table: torch.Tensor, i, j) -> torch.Tensor:
    """``table[b, j, i]`` per env for a (B, rows, cols, ...) table."""
    b, rows, cols = table.shape[:3]
    rest = table.shape[3:]
    j, i = (G.vec(v, b, table.device, torch.int64) for v in (j, i))
    r = j * cols + i
    idx = r.reshape(b, 1, *([1] * len(rest))).expand(b, 1, *rest)
    return table.reshape(b, rows * cols, *rest).gather(1, idx)[:, 0]


def room_top(room_size: int, i, j):
    pitch = room_size - 1
    return i * pitch, j * pitch


def init(
    generator: torch.Generator, state: EnvState, room_size: int, rows: int, cols: int
) -> Tuple[EnvState, RoomCtx]:
    """The wall lattice and one door slot drawn per edge; the agent starts
    in the middle room's centre, facing right."""
    b, h, w = state.grid_obj.shape
    dev = state.grid_obj.device
    pitch = room_size - 1
    ys, xs = G.coord_grids(h, w, dev)
    state = G.paint(state, (xs % pitch == 0) | (ys % pitch == 0), OBJ_WALL, COLOR_GREY)

    shape = (b, rows, cols, 4)
    door_x = torch.zeros(shape, dtype=torch.int32, device=dev)
    door_y = torch.zeros(shape, dtype=torch.int32, device=dev)
    for j in range(rows):
        for i in range(cols):
            tx, ty = room_top(room_size, i, j)
            if i < cols - 1:  # right edge: y in [top + 1, top + room_size - 1)
                door_x[:, j, i, 0].fill_(tx + room_size - 1)
                door_y[:, j, i, 0] = G.randint(generator, ty + 1, ty + room_size - 1, b, dev)
            if j < rows - 1:  # down edge
                door_x[:, j, i, 1] = G.randint(generator, tx + 1, tx + room_size - 1, b, dev)
                door_y[:, j, i, 1].fill_(ty + room_size - 1)
    # Left and up mirror the neighbour's right and down slots.
    door_x[:, :, 1:, 2] = door_x[:, :, :-1, 0]
    door_y[:, :, 1:, 2] = door_y[:, :, :-1, 0]
    door_x[:, 1:, :, 3] = door_x[:, :-1, :, 1]
    door_y[:, 1:, :, 3] = door_y[:, :-1, :, 1]
    # Edges 0-3 (right, down, left, up) have a neighbour inside the lattice.
    has_edge = G.const(
        [[[i < cols - 1, j < rows - 1, i > 0, j > 0] for i in range(cols)] for j in range(rows)],
        torch.bool,
        dev,
    )

    state = G.set_agent(
        state, (cols // 2) * pitch + room_size // 2, (rows // 2) * pitch + room_size // 2, 0
    )
    ctx = RoomCtx(
        door_x=door_x,
        door_y=door_y,
        has_edge=has_edge.expand(shape),
        edge=torch.zeros(shape, dtype=torch.int32, device=dev),
        locked=torch.zeros((b, rows, cols), dtype=torch.bool, device=dev),
        used=torch.zeros((b, 3, 6), dtype=torch.bool, device=dev),
    )
    return state, ctx


def _neighbor(rows: int, cols: int, i, j, k):
    """The room across edge k, clipped to the lattice (callers guard
    ``has_edge``); each argument an int or a tensor."""
    if isinstance(k, torch.Tensor):
        di = G.lookup(G.const(_DI, torch.int64, k.device), k)
        dj = G.lookup(G.const(_DJ, torch.int64, k.device), k)
    else:
        di, dj = _DI[int(k)], _DJ[int(k)]

    def clip(v, n):
        return v.clamp(0, n - 1) if isinstance(v, torch.Tensor) else min(max(v, 0), n - 1)

    return clip(i + di, cols), clip(j + dj, rows)


def set_edge(ctx: RoomCtx, i, j, k, value: int) -> RoomCtx:
    """Edge k of room (i, j), and the neighbour's edge facing it, to
    ``value``."""
    b, rows, cols, _ = ctx.edge.shape
    dev = ctx.edge.device
    ni, nj = _neighbor(rows, cols, i, j, k)
    k_hit = G.index_hit(4, k, dev)[:, None, None, :]
    back = (k + 2) % 4
    back_hit = G.index_hit(4, back, dev)[:, None, None, :]
    mask = (_room_mask(rows, cols, i, j, dev)[..., None] & k_hit) | (
        _room_mask(rows, cols, ni, nj, dev)[..., None] & back_hit
    )
    return ctx.replace(edge=torch.where(mask, value, ctx.edge).to(torch.int32))


def _kind_index(kind, device):
    """Position of ``kind`` in OBJ_KINDS (0 for other kinds, as JAX's
    argmax gives)."""
    if isinstance(kind, torch.Tensor):
        kind = kind.to(device)
        return torch.where(kind == OBJ_BALL, 1, torch.where(kind == OBJ_BOX, 2, 0))
    return OBJ_KINDS.index(kind) if kind in OBJ_KINDS else 0


def mark_used(ctx: RoomCtx, kind, color) -> RoomCtx:
    """Record a placed (kind, color) combo for the distractors' dedup."""
    kind_idx = _kind_index(kind, ctx.used.device)
    return ctx.replace(used=G.cell_set(ctx.used, kind_idx, color, True))


def add_door(
    generator: torch.Generator,
    state: EnvState,
    ctx: RoomCtx,
    i,
    j,
    door_idx=None,
    color=None,
    locked=None,
):
    """A door on edge ``door_idx`` of room (i, j): a uniform free edge, a
    uniform color and a fair coin for ``locked`` where not given.  Returns
    (state, ctx, (x, y), color, door_idx), each per env a (B,) tensor."""
    b = state.grid_obj.shape[0]
    dev = state.grid_obj.device
    if door_idx is None:
        avail = _at_room(ctx.has_edge, i, j) & (_at_room(ctx.edge, i, j) == EDGE_NONE)
        door_idx, _, _ = G.sample_mask_pos(generator, avail[:, None, :])
    if color is None:
        color = G.randint(generator, 0, 6, b, dev)
    if locked is None:
        locked = G.randint(generator, 0, 2, b, dev) == 0
    color = G.vec(color, b, dev)
    locked = G.vec(locked, b, dev, torch.bool)
    k = G.vec(door_idx, b, dev, torch.int64)
    x = _at_room(ctx.door_x, i, j).gather(1, k[:, None])[:, 0]
    y = _at_room(ctx.door_y, i, j).gather(1, k[:, None])[:, 0]
    state = G.put_obj(
        state, x, y, OBJ_DOOR, color, torch.where(locked, STATE_LOCKED, STATE_CLOSED)
    )
    ctx = set_edge(ctx, i, j, door_idx, EDGE_DOOR)
    rows, cols = ctx.locked.shape[1:]
    room = _room_mask(rows, cols, i, j, dev)
    ctx = ctx.replace(locked=torch.where(room, locked[:, None, None], ctx.locked))
    return state, ctx, (x, y), color, door_idx


def remove_wall(
    state: EnvState, ctx: RoomCtx, room_size: int, i: int, j: int, wall_idx: int
) -> Tuple[EnvState, RoomCtx]:
    """Clear the inside of one wall of room (i, j) (ints here, as every
    caller passes)."""
    _, h, w = state.grid_obj.shape
    tx, ty = room_top(room_size, i, j)
    ys, xs = G.coord_grids(h, w, state.grid_obj.device)
    if wall_idx == 0:
        m = (xs == tx + room_size - 1) & (ys > ty) & (ys < ty + room_size - 1)
    elif wall_idx == 1:
        m = (ys == ty + room_size - 1) & (xs > tx) & (xs < tx + room_size - 1)
    elif wall_idx == 2:
        m = (xs == tx) & (ys > ty) & (ys < ty + room_size - 1)
    else:
        m = (ys == ty) & (xs > tx) & (xs < tx + room_size - 1)
    state = G.paint(state, m, OBJ_EMPTY, 0)
    return state, set_edge(ctx, i, j, wall_idx, EDGE_OPEN)


def room_rect_mask(state: EnvState, room_size: int, i, j) -> torch.Tensor:
    """(H, W) or (B, H, W): the cells of room (i, j), its walls included."""
    _, h, w = state.grid_obj.shape
    top = room_top(room_size, i, j)
    return G.rect_mask(h, w, top, (room_size, room_size), state.grid_obj.device)


def reject_next_to_mask(state: EnvState) -> torch.Tensor:
    """(B, H, W): cells at Manhattan distance below 2 from the agent."""
    _, h, w = state.grid_obj.shape
    ys, xs = G.coord_grids(h, w, state.grid_obj.device)
    ax = state.agent_pos[:, 0].reshape(-1, 1, 1)
    ay = state.agent_pos[:, 1].reshape(-1, 1, 1)
    return (xs - ax).abs() + (ys - ay).abs() < 2


def place_in_room(
    generator: torch.Generator,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    i,
    j,
    kind,
    color,
    contains_obj=OBJ_EMPTY,
    contains_color=0,
):
    """A uniform free cell of room (i, j), not next to the agent.  Returns
    (state, ctx, (x, y), ok)."""
    mask = room_rect_mask(state, room_size, i, j)
    state, pos, ok = G.place_obj(
        generator,
        state,
        kind,
        color,
        reject_mask=(~mask) | reject_next_to_mask(state),
        contains_obj=contains_obj,
        contains_color=contains_color,
    )
    return state, mark_used(ctx, kind, color), pos, ok


def add_object(
    generator: torch.Generator,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    i,
    j,
    kind=None,
    color=None,
):
    """An object of a uniform kind and color (where not given) in room (i,
    j).  Returns (state, ctx, (x, y), kind, color), kind and color (B,)
    int32."""
    b = state.grid_obj.shape[0]
    dev = state.grid_obj.device
    if kind is None:
        kinds = G.const(OBJ_KINDS, torch.int32, dev)
        kind = G.lookup(kinds, G.randint(generator, 0, 3, b, dev))
    if color is None:
        color = G.randint(generator, 0, 6, b, dev)
    kind, color = G.vec(kind, b, dev), G.vec(color, b, dev)
    state, ctx, pos, _ = place_in_room(generator, state, ctx, room_size, i, j, kind, color)
    return state, ctx, pos, kind, color


def place_agent(
    generator: torch.Generator,
    state: EnvState,
    room_size: int,
    i=None,
    j=None,
    rows: int = 1,
    cols: int = 1,
) -> EnvState:
    """Uniform over the (cell, direction) pairs of room (i, j) whose cell is
    empty and whose front cell is empty or wall: the joint form of the
    reference's resample-until loop.  A room not given is drawn."""
    b, h, w = state.grid_obj.shape
    dev = state.grid_obj.device
    if i is None:
        i = G.randint(generator, 0, cols, b, dev)
    if j is None:
        j = G.randint(generator, 0, rows, b, dev)
    in_room = room_rect_mask(state, room_size, i, j)
    obj = state.grid_obj
    empty = obj == OBJ_EMPTY
    valid = []
    for d in range(4):
        dx, dy = int(DIR_TO_VEC[d][0]), int(DIR_TO_VEC[d][1])
        front = torch.roll(obj, shifts=(-dy, -dx), dims=(1, 2))
        valid.append(in_room & empty & ((front == OBJ_EMPTY) | (front == OBJ_WALL)))
    valid = torch.stack(valid, dim=1).reshape(b, 4 * h, w)
    x, dy_, _ = G.sample_mask_pos(generator, valid)
    return state.replace(
        agent_pos=torch.stack([x, dy_ % h], dim=1), agent_dir=dy_ // h
    )


def _edges(rows: int, cols: int):
    """Each physical edge once, as (row, col, 0 = right | 1 = down)."""
    return [
        (j, i, k)
        for j in range(rows)
        for i in range(cols)
        for k in range(2)
        if (k == 0 and i < cols - 1) or (k == 1 and j < rows - 1)
    ]


def connect_all(
    generator: torch.Generator,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    max_itrs: int = 256,
    exclude_color=None,
) -> Tuple[EnvState, RoomCtx]:
    """Add unlocked doors at random until every room is reachable from the
    agent's room: ``max_itrs`` iid draws of (room, edge, color) per env,
    with the color uniform over the other five where ``exclude_color``
    (an int or (B,) tensor) is given, and over all six where an entry of
    it is negative.  See :func:`connect_all_draws`."""
    b = state.grid_obj.shape[0]
    dev = state.grid_obj.device
    rows, cols = ctx.locked.shape[1:]

    def draw(n: int) -> torch.Tensor:
        return torch.randint(0, n, (b, max_itrs), generator=generator, device=dev)

    di, dj, dk = draw(cols), draw(rows), draw(4)
    if exclude_color is None:
        dcolor = draw(6)
    else:
        r = draw(5)
        ex = G.vec(exclude_color, b, dev, torch.int64).reshape(-1, 1)
        dcolor = torch.where(ex < 0, draw(6), r + (r >= ex).to(torch.int64))
    return connect_all_draws(state, ctx, room_size, di, dj, dk, dcolor)


def connect_all_draws(
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    di: torch.Tensor,
    dj: torch.Tensor,
    dk: torch.Tensor,
    dcolor: torch.Tensor,
) -> Tuple[EnvState, RoomCtx]:
    """``connect_all`` given its draws, each (B, T) int64, in closed form.

    The reference's loop takes draw t = (room (di, dj), edge dk, color) if
    the edge has a neighbour and no door yet and neither room is locked,
    and stops before the first draw at which every room is reachable from
    the start room.  The draws do not depend on the loop's state, so an
    edge joins the room graph at its first valid draw, and the loop stops
    after step t*, the largest over rooms of the minimax join time from
    the start room (a Bellman sweep over at most nine rooms).  The doors
    added are the first valid draws at steps <= min(t*, T - 1): the loop's
    result draw for draw, with no loop."""
    b = state.grid_obj.shape[0]
    dev = state.grid_obj.device
    rows, cols = ctx.locked.shape[1:]
    T = di.shape[1]
    INF = T + 1
    pitch = room_size - 1
    start_i = state.agent_pos[:, 0] // pitch
    start_j = state.agent_pos[:, 1] // pitch

    ni, nj = _neighbor(rows, cols, di, dj, dk)
    avail = (ctx.has_edge & (ctx.edge == EDGE_NONE)).reshape(b, -1)
    locked = ctx.locked.reshape(b, -1)
    valid = (
        avail.gather(1, (dj * cols + di) * 4 + dk)
        & ~locked.gather(1, dj * cols + di)
        & ~locked.gather(1, nj * cols + ni)
    )
    # The physical edge of each draw, named from the room left of or above it.
    ci = torch.where(dk == 2, di - 1, di)
    cj = torch.where(dk == 3, dj - 1, dj)
    ck = torch.where(dk < 2, dk, dk - 2)
    steps = torch.arange(T, device=dev).expand(b, T)

    edges = _edges(rows, cols)
    time_e, color_e, init_e = [], [], []
    for j, i, k in edges:
        hit = valid & (ci == i) & (cj == j) & (ck == k)
        t_first, first = torch.where(hit, steps, INF).min(dim=1)
        time_e.append(t_first)
        color_e.append(dcolor.gather(1, first[:, None])[:, 0])
        init_e.append(ctx.edge[:, j, i, k] != EDGE_NONE)

    # d[room]: the earliest step at which the room joins the start room.
    join = [torch.where(init_e[e], -1, time_e[e]) for e in range(len(edges))]
    d = {
        (j, i): torch.where((start_j == j) & (start_i == i), -1, INF).to(torch.int64)
        for j in range(rows)
        for i in range(cols)
    }
    for _ in range(rows * cols):
        for e, (j, i, k) in enumerate(edges):
            a, o = (j, i), ((j, i + 1) if k == 0 else (j + 1, i))
            d[a] = torch.minimum(d[a], torch.maximum(d[o], join[e]))
            d[o] = torch.minimum(d[o], torch.maximum(d[a], join[e]))
    t_star = torch.stack(list(d.values())).amax(dim=0)
    t_eff = t_star.clamp(max=T - 1)  # never connected: every draw ran

    go, gc, gs = state.grid_obj, state.grid_color, state.grid_state
    edge = ctx.edge.clone()
    for e, (j, i, k) in enumerate(edges):
        accept = ~init_e[e] & (time_e[e] <= t_eff)
        # A rejected door goes to x = y = -1, which writes nowhere.
        x = torch.where(accept, ctx.door_x[:, j, i, k], -1)
        y = torch.where(accept, ctx.door_y[:, j, i, k], -1)
        go = G.cell_set(go, y, x, OBJ_DOOR)
        gc = G.cell_set(gc, y, x, color_e[e])
        gs = G.cell_set(gs, y, x, STATE_CLOSED)
        oj, oi = (j, i + 1) if k == 0 else (j + 1, i)
        edge[:, j, i, k] = torch.where(accept, EDGE_DOOR, edge[:, j, i, k])
        edge[:, oj, oi, k + 2] = torch.where(accept, EDGE_DOOR, edge[:, oj, oi, k + 2])
    state = state.replace(grid_obj=go, grid_color=gc, grid_state=gs)
    return state, ctx.replace(edge=edge)


def add_distractors(
    generator: torch.Generator,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    rows: int,
    cols: int,
    i=None,
    j=None,
    num_distractors: int = 10,
    all_unique: bool = True,
):
    """``num_distractors`` objects of uniform kind and color, each in a
    uniform room (unless i and j are given) on a uniform free cell not
    next to the agent; with ``all_unique``, no (kind, color) combo already
    placed.  Returns (state, ctx, kinds, colors, poss): (B, n) int32 each,
    positions (B, n, 2).

    In a fixed room, placing one object after another on uniform free cells
    is drawing cells without replacement, and drawing unused combos one
    after another is drawing combos without replacement: both are one
    top-k over uniform keys, as the JAX version's Gumbel top-k.  Where the
    room has fewer free cells than objects, the slots without a cell write
    nothing."""
    b, h, w = state.grid_obj.shape
    dev = state.grid_obj.device
    n = num_distractors
    kinds_t = G.const(OBJ_KINDS, torch.int32, dev)
    if (i is not None and j is not None) or (rows == 1 and cols == 1):
        ri = 0 if i is None else i
        rj = 0 if j is None else j
        valid = (
            room_rect_mask(state, room_size, ri, rj)
            & ~reject_next_to_mask(state)
            & G.free_cell_mask(state)
        ).reshape(b, h * w)
        u = torch.rand((b, h * w), generator=generator, device=dev)
        top, idx = torch.where(valid, u, -1.0).topk(n, dim=1)
        xs, ys = (idx % w).to(torch.int32), (idx // w).to(torch.int32)
        # A slot without a free cell writes at x = y = -1, that is nowhere.
        wx, wy = torch.where(top >= 0, xs, -1), torch.where(top >= 0, ys, -1)
        if all_unique:
            uc = torch.rand((b, 18), generator=generator, device=dev)
            _, combos = torch.where(ctx.used.reshape(b, 18), -1.0, uc).topk(n, dim=1)
        else:
            kind_idx = torch.randint(0, 3, (b, n), generator=generator, device=dev)
            combos = kind_idx * 6 + torch.randint(0, 6, (b, n), generator=generator, device=dev)
        kinds, colors = G.lookup(kinds_t, combos // 6), (combos % 6).to(torch.int32)
        used = ctx.used.reshape(b, 18)
        grid_obj, grid_color = state.grid_obj, state.grid_color
        for t in range(n):
            used = G.elem_set(used, combos[:, t], True)
            grid_obj = G.cell_set(grid_obj, wy[:, t], wx[:, t], kinds[:, t])
            grid_color = G.cell_set(grid_color, wy[:, t], wx[:, t], colors[:, t])
        state = state.replace(grid_obj=grid_obj, grid_color=grid_color)
        ctx = ctx.replace(used=used.reshape(b, 3, 6))
        return state, ctx, kinds, colors, torch.stack([xs, ys], dim=2)

    kinds, colors, poss = [], [], []
    for _ in range(n):
        if all_unique:
            combo, _, _ = G.sample_mask_pos(generator, ~ctx.used.reshape(b, 1, 18))
            kind, color = G.lookup(kinds_t, combo.long() // 6), combo % 6
        else:
            kind = G.lookup(kinds_t, G.randint(generator, 0, 3, b, dev))
            color = G.randint(generator, 0, 6, b, dev)
        ri = G.randint(generator, 0, cols, b, dev) if i is None else i
        rj = G.randint(generator, 0, rows, b, dev) if j is None else j
        state, ctx, (x, y), _ = place_in_room(
            generator, state, ctx, room_size, ri, rj, kind, color
        )
        kinds.append(kind)
        colors.append(color.to(torch.int32))
        poss.append(torch.stack([x, y], dim=1))
    return state, ctx, torch.stack(kinds, 1), torch.stack(colors, 1), torch.stack(poss, 1)
