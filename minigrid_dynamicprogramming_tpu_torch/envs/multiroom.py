"""MultiRoom: a chain of rooms of random sizes on a 25x25 grid, each joined
to the next by a closed door of another color than the previous door; the
agent starts in the first room, the goal lies in the last.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/multiroom.py``'s
pooled generator (``generate_batch``), which is this port's ``generate``:
the reference rebuilds a whole chain until it reaches the drawn number of
rooms, and each room retries up to eight placements.  Here a batch of
independent chain attempts is drawn at once, batch last, each room
taking the first of its eight candidate placements that fits; the
attempts that chained every room are kept in draw order (a stable sort),
and the first ``batch_size`` of them are painted.  Every registered id
draws a fixed number of rooms (min == max), so every attempt succeeds
with the same chance and keeping the successes keeps the reference's law.
Where too few attempts succeed, the successes repeat (``idx % accepted``),
as in JAX; the margins make that vanishingly rare.  ``generate_stats``
reports, for each layout, whether it came from a successful attempt and
the attempts spent on it (``utils/telemetry.py:pooled_stats``).
"""

from __future__ import annotations

import math

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_TO_IDX,
    OBJ_DOOR,
    OBJ_GOAL,
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
from minigrid_dynamicprogramming_tpu_torch.utils.telemetry import pooled_stats

MISSION = "traverse the rooms to get to the goal"
SIZE = 25
TRIES_PER_ROOM = 8
SORTED_COLOR_IDS = [COLOR_TO_IDX[c] for c in sorted(COLOR_TO_IDX)]
# Attempts drawn per layout, by room count: each id's single-attempt
# success (about 0.85 at 2 rooms, 0.55 at 4, 0.3 at 6) times its margin is
# at least 1.3, so the successes lie tens of sigmas above n at n >= 4096.
MARGIN = {2: 2.0, 4: 3.0, 6: 5.0}


def _uniform_int(generator, low, high, shape, device) -> torch.Tensor:
    """int64 uniform draws from [low, high) of ``shape``; the bounds are
    ints or tensors that broadcast to it."""
    n = high - low
    n = n.to(torch.int64) if isinstance(n, torch.Tensor) else torch.full((), n, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    rank = torch.minimum((u * n).to(torch.int64), n - 1)
    return low + rank


def _select(cases, values):
    """The value of the first true case, elementwise (``jnp.select`` over
    cases that cover every element)."""
    out = values[-1]
    for case, value in zip(reversed(cases[:-1]), reversed(values[:-1])):
        out = torch.where(case, value, out)
    return out


def attempt_chains(generator, m: int, n_max: int, min_sz: int, max_sz: int,
                   num_rooms: torch.Tensor):
    """``m`` chain attempts at once, batch last: (tops, sizes, entries),
    each (n_max, 2, m) int64, and the rooms chained, (m,)."""
    dev = num_rooms.device
    T = TRIES_PER_ROOM
    ex = _uniform_int(generator, 0, SIZE - 2, (2, m), dev)
    s0 = _uniform_int(generator, min_sz, max_sz + 1, (2, m), dev)
    ok0 = (ex[0] + s0[0] <= SIZE) & (ex[1] + s0[1] < SIZE)
    tops = torch.zeros((n_max, 2, m), dtype=torch.int64, device=dev)
    sizes = torch.zeros_like(tops)
    entries = torch.zeros_like(tops)
    tops[0], sizes[0], entries[0] = ex, s0, ex
    count = ok0.to(torch.int64)
    entry_wall = torch.full((m,), 2, dtype=torch.int64, device=dev)
    alive = ok0
    for idx in range(1, n_max):
        in_chain = alive & (idx < num_rooms)
        px, py = tops[idx - 1]
        psx, psy = sizes[idx - 1]
        # The exit: a wall of the previous room other than its entry wall,
        # and a cell inside it.
        exit_wall = (entry_wall + 1 + _uniform_int(generator, 0, 3, (T, m), dev)) % 4
        rx = _uniform_int(generator, 1, (psx - 1).clamp(min=2), (T, m), dev)
        ry = _uniform_int(generator, 1, (psy - 1).clamp(min=2), (T, m), dev)
        walls = [exit_wall == w for w in range(4)]
        exit_x = _select(walls, [(px + psx - 1).expand(T, m), px + rx, px.expand(T, m), px + rx])
        exit_y = _select(walls, [py + ry, (py + psy - 1).expand(T, m), py + ry, py.expand(T, m)])
        entry = (exit_wall + 2) % 4
        # The next room: its size, and its corner along the shared wall.
        szx = _uniform_int(generator, min_sz, max_sz + 1, (T, m), dev)
        szy = _uniform_int(generator, min_sz, max_sz + 1, (T, m), dev)
        ox = _uniform_int(generator, exit_x - szx + 2, exit_x, (T, m), dev)
        oy = _uniform_int(generator, exit_y - szy + 2, exit_y, (T, m), dev)
        sides = [entry == w for w in range(4)]
        top_x = _select(sides, [exit_x - szx + 1, ox, exit_x, ox])
        top_y = _select(sides, [oy, exit_y - szy + 1, oy, exit_y])

        ok = (top_x >= 0) & (top_y >= 0) & (top_x + szx <= SIZE) & (top_y + szy < SIZE)
        # Apart from every accepted room but the previous one.
        for prev in range(n_max):
            placed = prev < count - 1
            qx, qy = tops[prev]
            qsx, qsy = sizes[prev]
            apart = (
                (top_x + szx < qx) | (qx + qsx <= top_x)
                | (top_y + szy < qy) | (qy + qsy <= top_y)
            )
            ok &= ~placed | apart
        first = ok.to(torch.int8).argmax(dim=0, keepdim=True)  # the first that fits

        def pick(a):
            return a.gather(0, first)[0]

        accept = in_chain & ok.any(dim=0)
        tops[idx] = torch.where(accept, torch.stack([pick(top_x), pick(top_y)]), tops[idx])
        sizes[idx] = torch.where(accept, torch.stack([pick(szx), pick(szy)]), sizes[idx])
        entries[idx] = torch.where(accept, torch.stack([pick(exit_x), pick(exit_y)]), entries[idx])
        entry_wall = torch.where(accept, pick(entry), entry_wall)
        count = count + accept.to(torch.int64)
        alive = accept | (~in_chain & alive)
    return tops, sizes, entries, count


def _rect(xs, ys, top, size):
    """(B, H, W) cells of per-env rectangles; ``top``, ``size`` (B, 2)."""
    tx, ty = (t.reshape(-1, 1, 1) for t in top.unbind(1))
    sx, sy = (s.reshape(-1, 1, 1) for s in size.unbind(1))
    return (xs >= tx) & (xs < tx + sx) & (ys >= ty) & (ys < ty + sy), (tx, ty, sx, sy)


def _paint(generator, p: EnvParams, tops, sizes, entries, count, device) -> EnvState:
    """Walls and entry doors of each env's chain in room order (a later
    room may overwrite an earlier one's cells, as upstream), then the
    agent in the first room and the goal in the last.  ``tops``, ``sizes``
    and ``entries`` are (B, n_max, 2)."""
    b, n_max, _ = tops.shape
    state = new_state(b, p.height, p.width, device)
    ys, xs = G.coord_grids(p.height, p.width, device)
    prev_color = torch.full((b,), -1, dtype=torch.int64, device=device)
    for idx in range(n_max):
        active = idx < count
        inside, (tx, ty, sx, sy) = _rect(xs, ys, tops[:, idx], sizes[:, idx])
        border = inside & ((xs == tx) | (xs == tx + sx - 1) | (ys == ty) | (ys == ty + sy - 1))
        state = G.paint(state, border & active[:, None, None], OBJ_WALL, COLOR_GREY)
        if idx > 0:
            # Uniform over the sorted colors other than the previous door's.
            r = G.randint(generator, 0, torch.where(prev_color >= 0, 5, 6), b, device)
            color = torch.zeros_like(prev_color)
            seen = torch.zeros_like(prev_color)
            for cand in SORTED_COLOR_IDS:
                is_opt = cand != prev_color
                color = torch.where(is_opt & (seen == r), cand, color)
                seen = seen + is_opt.to(torch.int64)
            door = G.cell_mask(p.height, p.width, entries[:, idx, 0], entries[:, idx, 1], device)
            state = G.paint(state, door & active[:, None, None], OBJ_DOOR, color, STATE_CLOSED)
            prev_color = torch.where(active, color, prev_color)
    first, _ = _rect(xs, ys, tops[:, 0], sizes[:, 0])
    state, _ = G.place_agent(generator, state, reject_mask=~first)
    last = (count - 1).clamp(min=0).reshape(b, 1, 1).expand(b, 1, 2)
    last_room, _ = _rect(xs, ys, tops.gather(1, last)[:, 0], sizes.gather(1, last)[:, 0])
    state, _, _ = G.place_obj(generator, state, OBJ_GOAL, COLOR_GREEN, reject_mask=~last_room)
    return state


def make_multiroom(
    env_id: str,
    min_num_rooms: int,
    max_num_rooms: int,
    max_room_size: int = 10,
) -> Environment:
    params = EnvParams(
        width=SIZE, height=SIZE, max_steps=max_num_rooms * 20, see_through_walls=False
    )
    n_max = max_num_rooms
    margin = MARGIN.get(max_num_rooms, 9.0)

    def attempts_and_layouts(generator: torch.Generator, p: EnvParams, batch_size: int, device):
        """(``batch_size`` layouts, each attempt's success in draw order)."""
        dev = resolve_device(device)
        n = batch_size
        m = max(n + 8, int(math.ceil(n * margin)))
        num_rooms = _uniform_int(generator, min_num_rooms, max_num_rooms + 1, (m,), dev)
        tops, sizes, entries, count = attempt_chains(
            generator, m, n_max, 4, max_room_size, num_rooms
        )
        ok = count >= num_rooms
        order = torch.argsort((~ok).to(torch.int8), stable=True)  # successes first
        accepted = ok.sum()
        idx = torch.arange(n, device=dev)
        sel = order.index_select(0, torch.where(idx < accepted, idx, idx % accepted.clamp(min=1)))

        def take(a):  # (n_max, 2, m) -> (n, n_max, 2)
            return a.index_select(2, sel).permute(2, 0, 1)

        state = _paint(
            generator, p, take(tops), take(sizes), take(entries), count.index_select(0, sel), dev
        )
        return state, ok

    def generate(
        generator: torch.Generator,
        p: EnvParams,
        batch_size: int,
        device="cuda",
        return_accepted: bool = False,
    ):
        """``batch_size`` layouts; with ``return_accepted`` also the number
        of attempts that chained every room (a (), int64 tensor), which
        must be at least ``batch_size`` for the layouts to be distinct
        draws."""
        state, ok = attempts_and_layouts(generator, p, batch_size, device)
        return (state, ok.sum()) if return_accepted else state

    def generate_stats(generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"):
        """``generate`` and the acceptance telemetry of its layouts: ``ok``
        where the chain reached every room."""
        state, ok = attempts_and_layouts(generator, p, batch_size, device)
        return state, pooled_stats(ok, batch_size)

    return Environment(
        env_id, params, generate, mission_text=lambda c: MISSION, generate_stats=generate_stats
    )
