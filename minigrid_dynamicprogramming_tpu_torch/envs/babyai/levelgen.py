"""The generic BabyAI level sampler (the reference's
``envs/babyai/core/levelgen.py``).

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/levelgen.py``.
``LevelGen.gen_mission`` composes an optional locked room, a connected
maze, distractors, the agent and a random instruction of the grammar
``{action, and, seq} x {goto, pickup, open, putnext}``:

* ``add_locked_room``'s retry loops are uniform draws over validity masks
  (levelgen.py:85-112);
* ``connect_all`` makes a fixed number of draws (``ops/roomgrid.py``); an
  attempt whose rooms those leave unconnected is rejected, where the
  reference's loop raises ``RecursionError`` and draws the level again;
* ``rand_obj`` redraws (color, type, loc) until the descriptor matches an
  object (levelgen.py:114-155), at most 100 times after the first draw.
  Here all 101 draws are made at once and the first valid one is kept (the
  last draw where none is valid, with ``ok`` False), as the JAX loop keeps
  it.  A draw is valid when some cell matches it: a table of match counts
  per (loc, type, color), built once per attempt from the grid, answers
  every draw with one gather;
* the instruction's shape (levelgen.py:157-210) is assembled from coins;
  the kinds it may take are static per id.

As in JAX, a color-only descriptor also matches walls of that color
(verifier.py:104-141 filters no type when the type is None).
"""

from __future__ import annotations

from typing import Sequence

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    NUM_OBJECTS,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_KEY,
    STATE_LOCKED,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.goto import other_room
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import (
    make_level,
    objs_reachable,
    select_state,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

OBJ_TYPES = (OBJ_BOX, OBJ_BALL, OBJ_KEY, OBJ_DOOR)  # verifier.py:15
OBJ_TYPES_NOT_DOOR = (OBJ_BOX, OBJ_BALL, OBJ_KEY)
ACTION_IDS = {"goto": B.KIND_GOTO, "pickup": B.KIND_PICKUP,
              "open": B.KIND_OPEN, "putnext": B.KIND_PUTNEXT}
# Draws of one descriptor: the first and up to 100 redraws.
RAND_OBJ_DRAWS = 101
# Descriptor types in the match table: any, then door, key, ball, box.
_TABLE_TYPES = (B.TYPE_ANY, OBJ_DOOR, OBJ_KEY, OBJ_BALL, OBJ_BOX)


def _match_table(params, state, region=None) -> torch.Tensor:
    """(B, 5 locs, 5 types, 7 colors) int: for each descriptor (loc, type
    in _TABLE_TYPES, color 0..5 or any), how many cells match it in the
    sense of ``core.desc_match_mask``, counted where ``region`` ((B, H, W)
    bool) holds."""
    b, h, w = state.grid_obj.shape
    dev = state.grid_obj.device
    key = (state.grid_obj.long() * 6 + state.grid_color.long()).reshape(b, -1)
    per_loc = []
    for loc in range(5):
        cells = B.desc_match_mask(params, state, B.TYPE_ANY, B.COLOR_ANY, loc)  # non-empty cells
        if region is not None:
            cells = cells & region
        counts = torch.zeros((b, NUM_OBJECTS * 6), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, key, cells.reshape(b, -1).to(torch.int32))
        counts = counts.reshape(b, NUM_OBJECTS, 6)
        by_type = torch.stack(
            [counts.sum(dim=1)] + [counts[:, t] for t in _TABLE_TYPES[1:]], dim=1
        )  # (B, 5 types, 6 colors); empty cells were never counted
        per_loc.append(torch.cat([by_type, by_type.sum(dim=2, keepdim=True)], dim=2))
    return torch.stack(per_loc, dim=1)


def _table_index(dtype, color, loc) -> torch.Tensor:
    """The flat index into a (5, 5, 7) match table of each draw."""
    t_idx = torch.zeros_like(dtype)
    for i, t in enumerate(_TABLE_TYPES[1:], start=1):
        t_idx = torch.where(dtype == t, i, t_idx)
    return ((loc * 5 + t_idx) * 7 + color).long()


def _rand_obj(
    generator, kind, table, table_out, has_locked, locations: bool, implicit_unlock: bool,
):
    """One ObjDesc per env with rejection (levelgen.py:114-155):
    (type, color, loc, ok), each (B,).  ``kind`` (B,) is the leaf's kind;
    ``table_out`` counts only the cells outside the locked room."""
    b, dev = kind.shape[0], kind.device
    T = RAND_OBJ_DRAWS

    def draw(n):
        return torch.randint(0, n, (b, T), generator=generator, device=dev)

    ci = draw(7)  # color: None or one of six (levelgen.py:127)
    color = torch.where(ci == 0, B.COLOR_ANY, ci - 1)
    t_any = G.lookup(G.const(OBJ_TYPES, torch.int64, dev), draw(4))
    t_nd = G.lookup(G.const(OBJ_TYPES_NOT_DOOR, torch.int64, dev), draw(3))
    # Pickup and putnext's moved object exclude doors (levelgen.py:169-176).
    k = kind[:, None]
    dtype = torch.where(
        k == B.KIND_OPEN, OBJ_DOOR,
        torch.where((k == B.KIND_PICKUP) | (k == B.KIND_PUTNEXT), t_nd, t_any),
    )
    if locations:
        use_loc = draw(2) == 0
        loc = torch.where(use_loc, draw(4) + 1, 0)
    else:
        loc = torch.zeros_like(dtype)
    idx = _table_index(dtype, color, loc)
    valid = table.reshape(b, -1).gather(1, idx) > 0
    if not implicit_unlock:
        # Some match outside the locked room (levelgen.py:143-152).
        outside = table_out.reshape(b, -1).gather(1, idx) > 0
        valid = valid & (outside | ~has_locked[:, None])
    steps = torch.arange(T, device=dev).expand(b, T)
    first = torch.where(valid, steps, T).min(dim=1).values
    ok = first < T
    at = torch.where(ok, first, T - 1)[:, None]
    return (dtype.gather(1, at)[:, 0], color.gather(1, at)[:, 0], loc.gather(1, at)[:, 0], ok)


def make_levelgen(
    env_id: str,
    room_size: int = 8,
    num_rows: int = 3,
    num_cols: int = 3,
    num_dists: int = 18,
    locked_room_prob: float = 0.5,
    locations: bool = True,
    unblocking: bool = True,
    implicit_unlock: bool = True,
    action_kinds: Sequence[str] = ("goto", "pickup", "open", "putnext"),
    instr_kinds: Sequence[str] = ("action", "and", "seq"),
) -> Environment:
    action_ids = [ACTION_IDS[a] for a in action_kinds]

    def sample_leaf(generator, tables, active, has_locked):
        """A random leaf, (B, 10) codes, zero where not ``active``, and its
        ok (True where not active)."""
        table, table_out = tables
        b, dev = active.shape[0], active.device
        draw = G.randint(generator, 0, len(action_ids), b, dev).long()
        kind = G.lookup(G.const(action_ids, torch.int64, dev), draw)
        t1, c1, l1, ok1 = _rand_obj(generator, kind, table, table_out, has_locked,
                                    locations, implicit_unlock)
        # PutNext's fixed object draws over every type (levelgen.py:173-176).
        t2, c2, l2, ok2 = _rand_obj(generator, torch.full_like(kind, B.KIND_GOTO), table,
                                    table_out, has_locked, locations, implicit_unlock)
        is_put = kind == B.KIND_PUTNEXT
        zero = torch.zeros_like(kind)
        leaf = torch.stack([
            kind, zero, t1, c1, l1, zero,
            torch.where(is_put, t2, 0), torch.where(is_put, c2, B.COLOR_ANY),
            torch.where(is_put, l2, 0), zero,
        ], dim=1).to(torch.int32)
        leaf = torch.where(active[:, None], leaf, 0)
        return leaf, (ok1 & (ok2 | ~is_put)) | ~active

    def gen(generator, p, state, ctx):
        """LevelGen.gen_mission over the attempts: the span
        ``babyai.generate.rooms`` (``rg.init``, the locked room and its
        key, ``connect_all``, the distractors, the agent), then
        ``babyai.generate.instr`` (the match tables, the leaves, the
        unblocking check)."""
        b, dev = state.grid_obj.shape[0], state.grid_obj.device
        with profiling.graph_span("babyai.generate.rooms"):
            state, ctx = rg.init(generator, state, room_size, num_rows, num_cols)
            # An optional locked room (levelgen.py:59-60, :85-112): a door on a
            # uniform edge that has a neighbour, its key in another room.
            has_locked = torch.rand(b, generator=generator, device=dev) < locked_room_prob
            valid_edges = ctx.has_edge.reshape(b, 1, -1)
            pick, _, _ = G.sample_mask_pos(generator, valid_edges)
            li, lj, lk = (pick // 4) % num_cols, pick // (4 * num_cols), pick % 4
            sub, sub_ctx, _, door_color, _ = rg.add_door(
                generator, state, ctx, li, lj, door_idx=lk, locked=True
            )
            ki, kj = other_room(generator, b, num_rows, num_cols, li, lj, dev)
            sub, sub_ctx, _, _ = rg.place_in_room(
                generator, sub, sub_ctx, room_size, ki, kj, OBJ_KEY, door_color
            )
            state, ctx = select_state(has_locked, sub, state), select_state(has_locked, sub_ctx, ctx)

            state, ctx = rg.connect_all(generator, state, ctx, room_size)
            connected = rg.rooms_connected(ctx)
            state, ctx, _, _, _ = rg.add_distractors(
                generator, state, ctx, room_size, num_rows, num_cols,
                num_distractors=num_dists, all_unique=False,
            )
            # The agent outside the locked room (levelgen.py:66-73).
            rooms = torch.arange(num_rows * num_cols, device=dev)
            in_locked = (rooms % num_cols == li[:, None]) & (rooms // num_cols == lj[:, None])
            apick, _, _ = G.sample_mask_pos(generator, (~(in_locked & has_locked[:, None]))[:, None, :])
            state = rg.place_agent(
                generator, state, room_size, i=apick % num_cols, j=apick // num_cols,
                rows=num_rows, cols=num_cols,
            )
            ok = connected
            if not unblocking:
                ok = ok & objs_reachable(state)

        with profiling.graph_span("babyai.generate.instr"):
            # A random instruction (levelgen.py:157-210).
            top = G.randint(generator, 0, len(instr_kinds), b, dev)
            top_kind = G.lookup(  # 0 action, 1 and, 2 seq
                G.const([("action", "and", "seq").index(k) for k in instr_kinds], torch.int64, dev),
                top,
            )
            before = G.randint(generator, 0, 2, b, dev) == 0
            # Each seq sub-clause is drawn from {action, and} (levelgen.py:189-199).
            sub_and = G.randint(generator, 0, 2, b, dev)
            sub_and_b = G.randint(generator, 0, 2, b, dev)
            comb = torch.where(
                top_kind == 2, torch.where(before, B.COMB_BEFORE, B.COMB_AFTER), B.COMB_SINGLE
            )
            a_is_and = torch.where(top_kind == 1, 1, torch.where(top_kind == 2, sub_and, 0))
            b_active = top_kind == 2
            b_is_and = torch.where(b_active, sub_and_b, 0)

            # Descriptor match counts, all cells and outside the locked room.
            rs = room_size
            locked_rect = G.rect_mask(
                p.height, p.width, (li * (rs - 1), lj * (rs - 1)), (rs, rs), dev
            )
            tables = (
                _match_table(p, state),
                None if implicit_unlock else _match_table(p, state, ~locked_rect),
            )
            true = torch.ones_like(b_active)
            leaf_a0, ok0 = sample_leaf(generator, tables, true, has_locked)
            leaf_a1, ok1 = sample_leaf(generator, tables, a_is_and == 1, has_locked)
            leaf_b0, ok2 = sample_leaf(generator, tables, b_active, has_locked)
            leaf_b1, ok3 = sample_leaf(generator, tables, b_active & (b_is_and == 1), has_locked)
            ok = ok & ok0 & ok1 & ok2 & ok3

            zero = torch.zeros((b, 1), dtype=torch.int32, device=dev)
            codes = torch.cat([
                comb[:, None].to(torch.int32), zero,
                a_is_and[:, None].to(torch.int32), leaf_a0, zero, leaf_a1, zero,
                b_is_and[:, None].to(torch.int32), leaf_b0, zero, leaf_b1, zero,
            ], dim=1)

            # validate_instrs for unblocking levels (roomgrid_level.py:178-191):
            # no descriptor may name a key of a locked door's color.
            if unblocking:
                locked_door = (state.grid_obj == OBJ_DOOR) & (state.grid_state == STATE_LOCKED)
                rows = codes.T
                for c in range(2):
                    for l in range(2):
                        for d in range(2):
                            t, col, _ = B.desc_fields(rows, c, l, d)
                            same = locked_door & (
                                state.grid_color.to(torch.int32) == col.reshape(-1, 1, 1)
                            )
                            bad = (t == OBJ_KEY) & same.flatten(1).any(dim=1) & B.desc_active(
                                rows, c, l, d
                            )
                            ok = ok & ~bad
        return state, codes, ok

    # The instruction's static shape (levelgen.py:157-210): "and" fills a
    # clause's second leaf; "seq" adds clause B, whose sub-clauses may be
    # and-pairs.
    may_and = ("and" in instr_kinds) or ("seq" in instr_kinds)
    may_seq = "seq" in instr_kinds
    combs = (("single",) if ("action" in instr_kinds or "and" in instr_kinds) else ()) + (
        ("before", "after") if may_seq else ()
    )
    main = tuple(action_kinds)
    second = main if may_and else ()
    profile = (combs, main, second, main if may_seq else (), second if may_seq else ())
    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=profile,
                      init_rooms=False)
