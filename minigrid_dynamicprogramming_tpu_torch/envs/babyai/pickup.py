"""BabyAI Pickup and PutNext levels (the reference's
``envs/babyai/pickup.py`` and ``putnext.py``).

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/pickup.py``.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_EMPTY
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import (
    accept_all,
    batch_of,
    make_level,
    objs_reachable,
    pick,
)
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg

_PICKUP = B.single_profile("pickup")
# Aux slots holding the cell of PutNext's carried object until generation
# lifts it off the grid.
CARRY_X, CARRY_Y = 10, 11


def _pickup_codes(state, kind, color, strict=0):
    return B.single_codes(state, B.KIND_PICKUP, kind, color, strict=strict)


def _maze_pickup(num_dists: int, want_reachable: bool, room_size, num_rows, num_cols):
    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size, rows=num_rows, cols=num_cols)
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, num_rows, num_cols,
            num_distractors=num_dists, all_unique=False,
        )
        ok = objs_reachable(state) == want_reachable
        n = G.randint(generator, 0, num_dists, b, dev)
        return state, _pickup_codes(state, pick(kinds, n), pick(colors, n)), ok

    return gen


def make_pickup(
    env_id: str, room_size: int = 8, num_rows: int = 3, num_cols: int = 3
) -> Environment:
    """pickup.py Pickup: pick up a uniform distractor of a connected maze."""
    gen = _maze_pickup(18, True, room_size, num_rows, num_cols)
    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=_PICKUP)


def make_unblock_pickup(
    env_id: str, room_size: int = 8, num_rows: int = 3, num_cols: int = 3
) -> Environment:
    """pickup.py UnblockPickup: some object must be unreachable without
    moving another (pickup.py:31-35 rejects when all are reachable)."""
    gen = _maze_pickup(20, False, room_size, num_rows, num_cols)
    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=_PICKUP)


def make_pickup_dist(env_id: str, debug: bool = False) -> Environment:
    """pickup.py PickupDist: five distinct objects in a room of size 7, the
    target named by type, color or both."""
    room_size = 7

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0, num_distractors=5, all_unique=True
        )
        state = rg.place_agent(generator, state, room_size, i=0, j=0)
        n = G.randint(generator, 0, 5, b, dev)
        by = G.randint(generator, 0, 3, b, dev)  # 0 type, 1 color, 2 both
        kind = torch.where(by == 1, B.TYPE_ANY, pick(kinds, n))
        color = torch.where(by == 0, B.COLOR_ANY, pick(colors, n))
        return state, _pickup_codes(state, kind, color, strict=int(debug)), accept_all(state)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=_PICKUP)


def make_pickup_above(env_id: str) -> Environment:
    """pickup.py PickupAbove: the object in the room above, a door
    between."""
    room_size = 6

    def gen(generator, p, state, ctx):
        state, ctx, _, kind, color = rg.add_object(generator, state, ctx, room_size, 1, 0)
        state, ctx, _, _, _ = rg.add_door(generator, state, ctx, 1, 1, door_idx=3, locked=False)
        state = rg.place_agent(generator, state, room_size, i=1, j=1, rows=3, cols=3)
        state, ctx = rg.connect_all(generator, state, ctx, room_size)
        return state, _pickup_codes(state, kind, color), accept_all(state)

    return make_level(
        env_id, gen, room_size, 3, 3, max_steps=8 * room_size**2, instr_profile=_PICKUP
    )


# -- PutNext ------------------------------------------------------------------


def make_putnext_local(env_id: str, room_size: int = 8, num_objs: int = 8) -> Environment:
    """putnext.py PutNextLocal: move one of the distinct objects of a room
    next to another (make_level's validation rejects a pair that starts
    adjacent)."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            generator, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_objs, all_unique=True,
        )
        ok = objs_reachable(state)
        two = G.permutation(generator, b, num_objs, dev)[:, :2]
        a, c = two[:, 0], two[:, 1]
        codes = B.instr_codes(
            b, dev, B.COMB_SINGLE,
            B.clause(
                B.KIND_PUTNEXT,
                d1=(pick(kinds, a), pick(colors, a), 0),
                d2=(pick(kinds, c), pick(colors, c), 0),
            ),
        )
        return state, codes, ok

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("putnext"))


def lift_carried(state):
    """PutNext.reset's start_carrying (putnext.py:192-201): the agent
    starts carrying the object at aux (CARRY_X, CARRY_Y), lifted after
    the verifier resolved its sets, so vmarks keep its old cell."""
    b = state.grid_obj.shape[0]
    x, y = state.aux[:, CARRY_X], state.aux[:, CARRY_Y]
    flat = (y * state.grid_obj.shape[2] + x).long()[:, None]

    def at(plane):
        return plane.reshape(b, -1).gather(1, flat)[:, 0]

    return state.replace(
        grid_obj=G.cell_set(state.grid_obj, y, x, OBJ_EMPTY),
        grid_color=G.cell_set(state.grid_color, y, x, 0),
        marks=G.cell_set(state.marks, y, x, 0),
        carrying_obj=at(state.grid_obj),
        carrying_color=at(state.grid_color),
        carrying_marks=at(state.marks),
    )


def make_putnext(
    env_id: str, room_size: int, objs_per_room: int, start_carrying: bool = False
) -> Environment:
    """putnext.py PutNext: two rooms side by side with the wall between
    them removed; move an object from one side next to one from the
    other."""

    def gen(generator, p, state, ctx):
        b, dev = batch_of(state)
        state = rg.place_agent(generator, state, room_size, i=0, j=0, rows=1, cols=2)
        state, ctx, kl, cl, pl = rg.add_distractors(
            generator, state, ctx, room_size, 1, 2, 0, 0,
            num_distractors=objs_per_room, all_unique=True,
        )
        state, ctx, kr, cr, pr = rg.add_distractors(
            generator, state, ctx, room_size, 1, 2, 1, 0,
            num_distractors=objs_per_room, all_unique=True,
        )
        state, ctx = rg.remove_wall(state, ctx, room_size, 0, 0, 0)
        na = G.randint(generator, 0, objs_per_room, b, dev)
        nb = G.randint(generator, 0, objs_per_room, b, dev)
        flip = G.randint(generator, 0, 2, b, dev) == 0
        ka = torch.where(flip, pick(kr, nb), pick(kl, na))
        ca = torch.where(flip, pick(cr, nb), pick(cl, na))
        kb = torch.where(flip, pick(kl, na), pick(kr, nb))
        cb = torch.where(flip, pick(cl, na), pick(cr, nb))
        codes = B.instr_codes(
            b, dev, B.COMB_SINGLE, B.clause(B.KIND_PUTNEXT, d1=(ka, ca, 0), d2=(kb, cb, 0))
        )
        if start_carrying:
            pa = torch.where(
                flip[:, None], pr.gather(1, nb.long()[:, None, None].expand(b, 1, 2))[:, 0],
                pl.gather(1, na.long()[:, None, None].expand(b, 1, 2))[:, 0],
            )
            aux = state.aux.clone()
            aux[:, CARRY_X], aux[:, CARRY_Y] = pa[:, 0], pa[:, 1]
            state = state.replace(aux=aux)
        return state, codes, accept_all(state)

    return make_level(
        env_id, gen, room_size, 1, 2, max_steps=8 * room_size**2,
        instr_profile=B.single_profile("putnext"),
        after_init=lift_carried if start_carrying else None,
    )
