"""The port's RoomGrid scaffold (``ops/roomgrid.py``) and grid write
helpers, without JAX.

``connect_all`` is held to the reference's retry loop draw for draw: the
same iid draws of (room, edge, color) per env go through the port's closed
form and through a sequential numpy loop written after the reference
(``RoomGrid.connect_all``: stop once every room is reachable from the
start room; skip a draw whose edge has no neighbour or a door already, or
that touches a locked room).  The doors added, their edges and colors, must
be equal on several room shapes, and when the draws run out first.  No
randomness enters the comparison.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    DIR_TO_VEC,
    OBJ_BALL,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
    STATE_CLOSED,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import new_state
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as RG

torch.set_num_threads(1)

B = 64


def _layout(shape: str, seed: int, room_size: int = 5):
    """B layouts before connect_all: a bare 1x2 or 3x3 lattice, a 3x3 one
    with a locked room, or KeyCorridor's merged corridor; the agent in a
    room drawn per env."""
    rows, cols = (1, 2) if shape == "1x2" else (3, 3)
    pitch = room_size - 1
    g = torch.Generator().manual_seed(seed)
    state = new_state(B, rows * pitch + 1, cols * pitch + 1, "cpu")
    state, ctx = RG.init(g, state, room_size, rows, cols)
    if shape == "corridor":
        for j in range(1, rows):
            state, ctx = RG.remove_wall(state, ctx, room_size, 1, j, 3)
        row = G.randint(g, 0, rows, B, "cpu")
        state, ctx, _, _, _ = RG.add_door(g, state, ctx, 2, row, door_idx=2, locked=True)
    elif shape == "locked":
        i, j = G.randint(g, 0, cols, B, "cpu"), G.randint(g, 0, rows, B, "cpu")
        state, ctx, _, _, _ = RG.add_door(g, state, ctx, i, j, locked=True)
    ri, rj = G.randint(g, 0, cols, B, "cpu"), G.randint(g, 0, rows, B, "cpu")
    state = G.set_agent(state, ri * pitch + room_size // 2, rj * pitch + room_size // 2, 0)
    return state, ctx


def _reached(edge, start) -> int:
    """Rooms reachable from room ``start`` = (j, i) through doors and
    removed walls."""
    seen, stack = set(), [start]
    while stack:
        j, i = stack.pop()
        if (j, i) in seen:
            continue
        seen.add((j, i))
        for k in range(4):
            if edge[j, i, k] != RG.EDGE_NONE:
                stack.append((j + DIR_TO_VEC[k][1], i + DIR_TO_VEC[k][0]))
    return len(seen)


def _loop(edge, locked, has_edge, start, di, dj, dk, dcolor):
    """The reference's loop on one env: (edges after it, {(j, i, k): color}
    of the doors it added, under the room that drew them)."""
    rows, cols, _ = edge.shape
    edge = edge.copy()
    added = {}
    for t in range(len(di)):
        if _reached(edge, start) == rows * cols:
            break
        i, j, k = di[t], dj[t], dk[t]
        if not has_edge[j, i, k] or edge[j, i, k] != RG.EDGE_NONE:
            continue
        ni, nj = i + DIR_TO_VEC[k][0], j + DIR_TO_VEC[k][1]
        if locked[j, i] or locked[nj, ni]:
            continue
        edge[j, i, k] = edge[nj, ni, (k + 2) % 4] = RG.EDGE_DOOR
        added[(j, i, k)] = dcolor[t]
    return edge, added


@pytest.mark.parametrize("shape", ["1x2", "3x3", "locked", "corridor"])
@pytest.mark.parametrize("T", [256, 3])
def test_connect_all_equals_the_retry_loop(shape, T):
    state, ctx = _layout(shape, seed=T)
    rows, cols = ctx.locked.shape[1:]
    rng = np.random.default_rng(len(shape) + T)
    draws = [rng.integers(0, n, (B, T)) for n in (cols, rows, 4, 6)]
    out, out_ctx = RG.connect_all_draws(state, ctx, 5, *(torch.from_numpy(d) for d in draws))

    edge0, locked = ctx.edge.numpy(), ctx.locked.numpy()
    has_edge, start = ctx.has_edge.numpy(), state.agent_pos.numpy() // 4
    dx, dy = ctx.door_x.numpy(), ctx.door_y.numpy()
    changed = (out.grid_obj != state.grid_obj).numpy()
    n_added = 0
    for b in range(B):
        want_edge, added = _loop(
            edge0[b], locked[b], has_edge[b], (start[b, 1], start[b, 0]),
            *(d[b] for d in draws),
        )
        np.testing.assert_array_equal(out_ctx.edge[b].numpy(), want_edge, err_msg=str(b))
        cells = set()
        for (j, i, k), color in added.items():
            x, y = dx[b, j, i, k], dy[b, j, i, k]
            cells.add((y, x))
            assert out.grid_obj[b, y, x] == OBJ_DOOR and out.grid_color[b, y, x] == color
            assert out.grid_state[b, y, x] == STATE_CLOSED
        assert set(map(tuple, np.argwhere(changed[b]))) == cells
        n_added += len(added)
    assert n_added > 0


def test_connect_all_excludes_a_color():
    """Each env's doors avoid its excluded color; a negative entry (BabyAI
    Unlock's half of the envs) excludes none, so all six occur."""
    state, ctx = _layout("3x3", seed=5)
    exclude = torch.arange(B) % 7 - 1
    out, out_ctx = RG.connect_all(torch.Generator().manual_seed(1), state, ctx, 5, exclude_color=exclude)
    added = (out.grid_obj == OBJ_DOOR) & (state.grid_obj != OBJ_DOOR)
    colors = out.grid_color[added].long()
    owners = exclude[:, None, None].expand_as(added)[added]
    assert len(colors) > 100 and (colors != owners).all()
    assert set(colors[owners < 0].tolist()) == set(range(6))
    # Every room joined (no room is locked here).
    for b in range(B):
        assert _reached(out_ctx.edge[b].numpy(), (0, 0)) == 9


def test_write_helpers_mask_out_of_range_indices():
    """-1 writes nowhere (torch would wrap it to the last cell)."""
    plane = torch.zeros((3, 4, 5), dtype=torch.uint8)
    got = G.cell_set(plane, torch.tensor([-1, 1, 3]), torch.tensor([-1, 2, 4]), 7)
    want = plane.clone()
    want[1, 1, 2] = want[2, 3, 4] = 7
    assert torch.equal(got, want)
    arr = torch.zeros((3, 4), dtype=torch.int32)
    got = G.elem_set(arr, torch.tensor([-1, 0, 4]), torch.tensor([5, 6, 7]))
    assert got.tolist() == [[0] * 4, [6, 0, 0, 0], [0] * 4]


@pytest.mark.parametrize("fixed_room", [True, False])
def test_add_distractors(fixed_room):
    """Objects in their room, on distinct cells, never next to the agent;
    with all_unique, no (kind, color) twice nor one placed before."""
    g = torch.Generator().manual_seed(4)
    state = new_state(B, 13, 13, "cpu")
    state, ctx = RG.init(g, state, 7, 2, 2)
    state, ctx, _, kind0, color0 = RG.add_object(g, state, ctx, 7, 0, 0, kind=OBJ_KEY)
    n = 6
    ij = dict(i=1, j=1) if fixed_room else {}
    out, ctx, kinds, colors, poss = RG.add_distractors(g, state, ctx, 7, 2, 2, num_distractors=n, **ij)
    assert kinds.shape == (B, n) and poss.shape == (B, n, 2)
    for b in range(B):
        cells = {tuple(p) for p in poss[b].tolist()}
        assert len(cells) == n
        for (x, y), k, c in zip(poss[b].tolist(), kinds[b].tolist(), colors[b].tolist()):
            assert out.grid_obj[b, y, x] == k and out.grid_color[b, y, x] == c
            ax, ay = state.agent_pos[b].tolist()
            assert abs(x - ax) + abs(y - ay) >= 2
            if fixed_room:
                assert 6 <= x <= 12 and 6 <= y <= 12
        combos = set(zip(kinds[b].tolist(), colors[b].tolist()))
        assert len(combos) == n and (OBJ_KEY, int(color0[b])) not in combos
        assert int(ctx.used[b].sum()) == n + 1


def test_place_agent_faces_empty_or_wall():
    g = torch.Generator().manual_seed(2)
    state = new_state(256, 7, 13, "cpu")
    state, ctx = RG.init(g, state, 7, 1, 2)
    state, ctx, _, _, _ = RG.add_object(g, state, ctx, 7, 0, 0, kind=OBJ_BALL)
    state = RG.place_agent(g, state, 7, 0, 0)
    x, y, d = state.agent_pos[:, 0], state.agent_pos[:, 1], state.agent_dir.long()
    vec = torch.from_numpy(DIR_TO_VEC)[d]
    rows = torch.arange(256)
    assert (state.grid_obj[rows, y, x] == OBJ_EMPTY).all() and (x <= 6).all()
    front = state.grid_obj[rows, y + vec[:, 1], x + vec[:, 0]]
    assert ((front == OBJ_EMPTY) | (front == OBJ_WALL)).all()
    assert len(set(d.tolist())) == 4
