"""BabyAI language core: the flattened instruction and its verifier.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/core.py``.
The reference builds a tree of ``Instr`` objects whose ``verify(action)``
walks sets of Python objects every step; here the instruction is a flat
48-int code vector in ``mission`` and the verification is one branchless
post-step hook over the lane-major state.  The grammar of
``LevelGen.rand_instr`` (levelgen.py:157-210)::

    instr  ::= clause | Before(clause, clause) | After(clause, clause)
    clause ::= leaf | And(leaf, leaf)
    leaf   ::= GoTo(d) | Open(d) | Pickup(d) | PutNext(d, d)

so the code vector holds 2 clauses x 2 leaves x 2 descriptors::

    [0]  comb         0 = single clause, 1 = before, 2 = after
    [1]  comb_strict
    clause X at {A: 2, B: 25}, 23 slots:
      [+0]   nand     0 = single leaf, 1 = and-pair (AndInstr)
      leaf L at {0: +1, 1: +12}, 11 slots:
        [+0] kind     0 none, 1 goto, 2 open, 3 pickup, 4 putnext
        [+1] strict
        [+2..5]  d1:  type, color, loc, plural
        [+6..9]  d2:  type, color, loc, plural   (putnext only)
    type: object type (4 door, 5 key, 6 ball, 7 box), 0 = any
    color: 0..5, 6 = any;  loc: 0 none, 1 left, 2 right, 3 front, 4 behind

Object identity (``ObjDesc.obj_set``, verifier.py:104-169) is a set of bit
planes: descriptor slot k (of 8) owns bit k of ``marks``, set on the cells
of matching objects at reset and carried through pickup and drop by the
core step.  ``vmarks`` is the verifier's position snapshot (``obj_poss``),
refreshed from ``marks`` only at reset and on drop actions, which keeps
the reference's stale positions (roomgrid_level.py:89-91).  Bits 8..11
track each leaf's ``preCarrying`` object (verifier.py:336-359, :385-433).

Marks are int32 here and uint16 in JAX (``core/state.py``).  Only bits
0..11 are ever set, and every clear is ``x & ~bit`` with ``bit`` below
2**12, so the planes never leave [0, 2**16) and equal JAX's bit for bit.

Two layouts meet here: the generator's batch-first ``EnvState`` (planes
``(B, H, W)``, codes ``(B, 48)``) for ``desc_match_mask`` and
``init_instr``, and the step's lane-major ``LaneState`` (planes ``(HW,
B)``, codes ``(48, B)``) for ``verify_step``.  The code accessors take the
slot axis first, so a batch-first code tensor is passed transposed.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_DONE,
    ACT_DROP,
    ACT_PICKUP,
    ACT_TOGGLE,
    OBJ_DOOR,
    OBJ_EMPTY,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu_torch.ops import agnostic as AG
from minigrid_dynamicprogramming_tpu_torch.ops import grid as G
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

# -- instruction encodings ---------------------------------------------------

COMB_SINGLE, COMB_BEFORE, COMB_AFTER = 0, 1, 2
KIND_NONE, KIND_GOTO, KIND_OPEN, KIND_PICKUP, KIND_PUTNEXT = 0, 1, 2, 3, 4
LOC_NONE, LOC_LEFT, LOC_RIGHT, LOC_FRONT, LOC_BEHIND = 0, 1, 2, 3, 4
COLOR_ANY = 6
TYPE_ANY = 0

CLAUSE_OFF = (2, 25)  # mission offset of clause A / B
LEAF_OFF = (1, 12)  # offset of leaf 0 / 1 within a clause

# Verifier aux slots.
AUX_A_DONE = 12
AUX_B_DONE = 13
AUX_LEAF_DONE = 14  # .. 17 (clause*2 + leaf)
AUX_PC_NONE = 18  # .. 21
AUX_MAX_STEPS = 22
# BABYAI_DONE_ACTIONS mode (verifier.py:25, :230-243): bit i is leaf i's
# "lastStepMatch", so a `done` action now succeeds.
AUX_LAST_MATCH = 23

N_DESC = 8  # descriptor slot = (clause*2 + leaf)*2 + d; a remember bit per leaf


def desc_bit(clause: int, leaf: int, d: int) -> int:
    return 1 << ((clause * 2 + leaf) * 2 + d)


def remember_bit(clause: int, leaf: int) -> int:
    return 1 << (N_DESC + clause * 2 + leaf)


OBJ_TYPE_NAMES = {4: "door", 5: "key", 6: "ball", 7: "box"}
COLOR_NAMES6 = ["red", "green", "blue", "purple", "yellow", "grey"]
LOC_SUFFIX = {
    LOC_LEFT: " on your left",
    LOC_RIGHT: " on your right",
    LOC_FRONT: " in front of you",
    LOC_BEHIND: " behind you",
}


def clause(kind, strict=0, d1=(0, COLOR_ANY, 0), d2=(0, COLOR_ANY, 0)):
    """One leaf block (10 values, ints or (B,) tensors; the plural flags
    are filled by ``init_instr``)."""
    return [kind, strict, d1[0], d1[1], d1[2], 0, d2[0], d2[1], d2[2], 0]


def _clause_block(c):
    """A single-leaf clause (a leaf block, or None for no clause) as its
    23 values.  And-pairs come only from the generic sampler, which
    writes its codes itself (``levelgen.py``)."""
    if c is None:
        return [0] * 23
    return [0] + list(c) + [0] + [0] * 11


def instr_codes(b: int, device, comb, clause_a, clause_b=None, strict=0) -> torch.Tensor:
    """The full code vectors, (B, 48) int32; every value an int or a (B,)
    tensor."""
    vals = [comb, strict] + _clause_block(clause_a) + _clause_block(clause_b)
    ints = [0 if isinstance(v, torch.Tensor) else int(v) for v in vals]
    codes = G.const(ints, torch.int32, device).expand(b, len(vals)).clone()
    for k, v in enumerate(vals):
        if isinstance(v, torch.Tensor):
            codes[:, k] = v
    return codes


def single_codes(state: EnvState, kind, dtype, color, strict=0, loc=LOC_NONE) -> torch.Tensor:
    """(B, 48) codes of one single-leaf instruction per env of a
    batch-first state: a leaf of ``kind`` naming (dtype, color, loc), each
    an int or a (B,) tensor."""
    b, dev = state.grid_obj.shape[0], state.grid_obj.device
    return instr_codes(b, dev, COMB_SINGLE, clause(kind, strict=strict, d1=(dtype, color, loc)))


# -- code-vector field accessors (slot axis first) ----------------------------


def _leaf_base(c: int, l: int) -> int:
    return CLAUSE_OFF[c] + LEAF_OFF[l]


def _desc_base(c: int, l: int, d: int) -> int:
    return _leaf_base(c, l) + 2 + d * 4


def leaf_kind(codes, c: int, l: int):
    return codes[_leaf_base(c, l)]


def leaf_strict(codes, c: int, l: int):
    return codes[_leaf_base(c, l) + 1]


def clause_is_and(codes, c: int):
    return codes[CLAUSE_OFF[c]] == 1


def desc_fields(codes, c: int, l: int, d: int):
    b = _desc_base(c, l, d)
    return codes[b], codes[b + 1], codes[b + 2]


def desc_active(codes, c: int, l: int, d: int):
    kind = leaf_kind(codes, c, l)
    return (kind != KIND_NONE) & ((d == 0) | (kind == KIND_PUTNEXT))


def num_navs(codes) -> torch.Tensor:
    """roomgrid_level.py:215-235: a putnext leaf counts 2, any other leaf
    1, combinators sum."""
    total = torch.zeros_like(codes[0])
    for c in range(2):
        for l in range(2):
            kind = leaf_kind(codes, c, l)
            total = total + torch.where(
                kind == KIND_NONE, 0, torch.where(kind == KIND_PUTNEXT, 2, 1)
            ).to(total.dtype)
    return total


# -- descriptor matching (ObjDesc.find_matching_objs, verifier.py:104-169) ---


def room_inside_mask(params: EnvParams, ax, ay) -> torch.Tensor:
    """(B, H, W): the cells of the room holding (ax, ay), each (B,)
    (RoomGrid.room_from_pos and Room.pos_inside, roomgrid.py:43-49,
    :110-121)."""
    rs = params.opt("room_size", 8)
    top = ((ax // (rs - 1)) * (rs - 1), (ay // (rs - 1)) * (rs - 1))
    return G.rect_mask(params.height, params.width, top, (rs, rs), ax.device)


def desc_match_mask(params: EnvParams, state: EnvState, dtype, dcolor, dloc) -> torch.Tensor:
    """(B, H, W): cells whose object matches (type, color, loc), each an
    int or a (B,) tensor; loc is relative to the agent's pose and limited
    to the agent's room (verifier.py:141-163).  Type "any" matches every
    object, walls included (verifier.py:133)."""
    obj = state.grid_obj
    b, h, w = obj.shape
    dev = obj.device

    def per_env(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.int32).reshape(-1, 1, 1)
        return torch.full((1, 1, 1), v, dtype=torch.int32, device=dev)

    dtype, dcolor, dloc = per_env(dtype), per_env(dcolor), per_env(dloc)
    m = obj != OBJ_EMPTY
    m = m & ((dtype == TYPE_ANY) | (obj.to(torch.int32) == dtype))
    m = m & ((dcolor == COLOR_ANY) | (state.grid_color.to(torch.int32) == dcolor))

    ys, xs = G.coord_grids(h, w, dev)
    ax, ay = state.agent_pos[:, 0], state.agent_pos[:, 1]
    vx = xs - ax.reshape(-1, 1, 1)
    vy = ys - ay.reshape(-1, 1, 1)
    d1x, d1y = (v.reshape(-1, 1, 1) for v in AG.dir_vec(state.agent_dir))
    d2x, d2y = -d1y, d1x
    dot1 = vx * d1x + vy * d1y
    dot2 = vx * d2x + vy * d2y
    loc_ok = torch.where(
        dloc == LOC_LEFT,
        dot2 < 0,
        torch.where(
            dloc == LOC_RIGHT,
            dot2 > 0,
            torch.where(
                dloc == LOC_FRONT, dot1 > 0, torch.where(dloc == LOC_BEHIND, dot1 < 0, True)
            ),
        ),
    )
    in_room = room_inside_mask(params, ax, ay)
    return m & ((dloc == LOC_NONE) | (loc_ok & in_room))


# All leaf kinds a slot may take when no static profile narrows it.
_ALL_KINDS = ("goto", "open", "pickup", "putnext")

# Static instruction profile: (combs, leaf00, leaf01, leaf10, leaf11), combs
# a subset of ("single", "before", "after") and each leaf entry the kinds
# that slot can take for the id (empty: never active).  Kept in
# params.extra, so the hook branches in Python on what the id can emit.
GENERIC_PROFILE = (
    ("single", "before", "after"),
    _ALL_KINDS, _ALL_KINDS, _ALL_KINDS, _ALL_KINDS,
)


def single_profile(*kinds):
    """Profile of a mission that is always one ActionInstr."""
    return (("single",), tuple(kinds), (), (), ())


def active_desc_slots(params: EnvParams):
    """The (c, l, d) descriptor slots the id's profile can populate."""
    profile = params.opt("instr_profile") or GENERIC_PROFILE
    slots = []
    for c in range(2):
        for l in range(2):
            kinds = profile[1 + c * 2 + l]
            if not kinds:
                continue
            slots.append((c, l, 0))
            if "putnext" in kinds:
                slots.append((c, l, 1))
    return slots


def init_instr(params: EnvParams, state: EnvState, codes: torch.Tensor) -> EnvState:
    """Resolve the descriptors of ``codes`` ((B, 48) int32) into mark bits,
    set the codes with their plural flags, the verifier's aux slots and the
    per-episode step limit (roomgrid_level.py:76-83)."""
    codes = codes.to(torch.int32).clone()
    rows = codes.T  # slot axis first, a view: writes land in codes
    marks = torch.zeros_like(state.marks)
    for c, l, d in active_desc_slots(params):
        dtype, dcolor, dloc = desc_fields(rows, c, l, d)
        m = desc_match_mask(params, state, dtype, dcolor, dloc)
        m = m & desc_active(rows, c, l, d).reshape(-1, 1, 1)
        marks = marks | torch.where(m, desc_bit(c, l, d), 0).to(marks.dtype)
        rows[_desc_base(c, l, d) + 3] = (m.sum(dim=(1, 2)) > 1).to(torch.int32)

    rs = params.opt("room_size", 8)
    nav_time_maze = rs * rs * params.opt("num_rows", 3) * params.opt("num_cols", 3)
    if params.opt("fixed_max_steps", False):
        max_steps = torch.full_like(rows[0], params.max_steps)
    else:
        max_steps = num_navs(rows) * nav_time_maze

    aux = state.aux.clone()
    for slot in (AUX_A_DONE, AUX_B_DONE, AUX_LAST_MATCH):
        aux[:, slot].zero_()
    aux[:, AUX_LEAF_DONE:AUX_LEAF_DONE + 4].zero_()
    aux[:, AUX_PC_NONE:AUX_PC_NONE + 4].fill_(1)
    aux[:, AUX_MAX_STEPS] = max_steps.to(torch.int32)
    return state.replace(
        marks=marks,
        vmarks=marks,
        carrying_marks=torch.zeros_like(state.carrying_marks),
        mission=codes,
        aux=aux,
    )


# -- per-step verification (the post-step hook) ------------------------------


def _bit(x: torch.Tensor, bit: int) -> torch.Tensor:
    return (x.to(torch.int32) & bit) > 0


def _front_cell(params: EnvParams, new):
    """The front cell, shared by the leaves: (in_bounds, obj, state, marks,
    vmarks), each (B,)."""
    h, w = params.height, params.width
    ax, ay = AG.agent_xy(new)
    dx, dy = AG.dir_vec(new.agent_dir)
    fwx, fwy = ax + dx, ay + dy
    fin = (fwx >= 0) & (fwx < w) & (fwy >= 0) & (fwy < h)
    fx, fy = fwx.clamp(0, w - 1), fwy.clamp(0, h - 1)
    return (
        fin,
        AG.read_cell(params, new, "grid_obj", fx, fy),
        AG.read_cell(params, new, "grid_state", fx, fy),
        AG.read_cell(params, new, "marks", fx, fy),
        AG.read_cell(params, new, "vmarks", fx, fy),
    )


def _leaf_eval(params, new, action, codes, c, l, pc_none, front, kinds):
    """One leaf's evaluation, uncommitted: (result in {0 continue,
    1 success, 2 failure}, new pc_none, marks, carrying_marks) with the
    leaf's remember bit updated.  ``kinds``, the slot's static kind set,
    leaves out the branches of kinds it cannot take."""
    kind = leaf_kind(codes, c, l)
    strict = leaf_strict(codes, c, l)
    bit1, bit2 = desc_bit(c, l, 0), desc_bit(c, l, 1)
    rbit = remember_bit(c, l)
    fin, f_obj, f_state, f_marks, f_vmarks = front

    is_toggle = action == ACT_TOGGLE
    is_pickup = action == ACT_PICKUP
    is_drop = action == ACT_DROP
    carrying_now = new.carrying_obj != OBJ_EMPTY
    F = torch.zeros_like(carrying_now)

    # GoTo (verifier.py:307-314): the agent faces a tracked position.
    goto_succ = (fin & _bit(f_vmarks, bit1)) if "goto" in kinds else F

    # Open (verifier.py:268-285).
    if "open" in kinds:
        f_is_door = fin & (f_obj == OBJ_DOOR)
        open_succ = is_toggle & f_is_door & _bit(f_marks, bit1) & (f_state == STATE_OPEN)
        open_fail = (strict == 1) & is_toggle & f_is_door & ~open_succ
    else:
        open_succ = open_fail = F

    # Pickup (verifier.py:341-361).
    if "pickup" in kinds:
        pick_succ = is_pickup & (pc_none == 1) & _bit(new.carrying_marks, bit1)
        pick_fail = (strict == 1) & is_pickup & carrying_now & ~pick_succ
    else:
        pick_succ = pick_fail = F

    # PutNext (verifier.py:409-433): the remembered object, a tracked mover
    # now on the grid, with a tracked fixed object 4-adjacent.
    if "putnext" in kinds:
        rem_move = _bit(new.marks, rbit) & _bit(new.marks, bit1)
        fixed = _bit(new.vmarks, bit2)
        near = (
            AG.shift_cells(params, new, fixed, 0, -1)
            | AG.shift_cells(params, new, fixed, 0, 1)
            | AG.shift_cells(params, new, fixed, -1, 0)
            | AG.shift_cells(params, new, fixed, 1, 0)
        )
        put_succ = is_drop & AG.reduce_any_cells(params, new, rem_move & near)
        put_fail = (strict == 1) & is_pickup & carrying_now
    else:
        put_succ = put_fail = F

    succ_of = {"goto": goto_succ, "open": open_succ, "pickup": pick_succ, "putnext": put_succ}
    fail_of = {"goto": F, "open": open_fail, "pickup": pick_fail, "putnext": put_fail}
    if len(kinds) == 1:
        succ = succ_of[kinds[0]]
        fail = ~succ & fail_of[kinds[0]]
    else:
        succ = torch.where(
            kind == KIND_GOTO, goto_succ,
            torch.where(kind == KIND_OPEN, open_succ,
                        torch.where(kind == KIND_PICKUP, pick_succ,
                                    (kind == KIND_PUTNEXT) & put_succ)),
        )
        fail = ~succ & torch.where(
            kind == KIND_OPEN, open_fail,
            torch.where(kind == KIND_PICKUP, pick_fail, (kind == KIND_PUTNEXT) & put_fail),
        )
    res = torch.where(succ, 1, torch.where(fail, 2, 0)).to(torch.int32)

    # On evaluation the leaf remembers what is carried (preCarrying <-
    # env.carrying, verifier.py:343-344).
    may_track = ("pickup" in kinds) or ("putnext" in kinds)
    if not may_track:
        return res, pc_none, new.marks, new.carrying_marks
    marks_clear = new.marks & ~rbit
    cm_clear = new.carrying_marks & ~rbit
    cm_set = torch.where(carrying_now, cm_clear | rbit, cm_clear)
    if all(k in ("pickup", "putnext") for k in kinds):
        return res, (~carrying_now).to(torch.int32), marks_clear, cm_set
    tracks_carry = (kind == KIND_PICKUP) | (kind == KIND_PUTNEXT)
    new_pc_none = torch.where(tracks_carry, (~carrying_now).to(torch.int32), pc_none)
    return (
        res,
        new_pc_none,
        torch.where(tracks_carry, marks_clear, new.marks),
        torch.where(tracks_carry, cm_set, new.carrying_marks),
    )


def _where(mask, a, b):
    """``torch.where(mask, a, b)``, or ``a`` where ``mask`` is the static
    True of an evaluation every lane makes."""
    return a if mask is True else torch.where(mask, a, b)


def verify_step(params: EnvParams, generator, prev, new, action, reward, terminated):
    """RoomGridLevel.step's verifier pass (roomgrid_level.py:86-103) over a
    lane-major state: the post-step hook of every BabyAI id, the span
    ``babyai.verify``.  It draws nothing (``generator`` is None)."""
    with profiling.graph_span("babyai.verify"):
        return _verify(params, new, action, reward, terminated)


def _verify(params: EnvParams, new, action, reward, terminated):
    """:func:`verify_step`'s work.

    The id's instruction profile decides in Python what is computed, as it
    decides in JAX what is traced: leaves the profile leaves empty are
    never evaluated, a clause is an and-pair only where its second leaf
    can be active, and clause B and the sequence state machine exist only
    where the profile holds "before" or "after".  The generators give no
    codes outside the profile, so the pruned parts would leave every value
    as it was."""
    action = action.to(torch.int32)
    codes = new.mission
    comb, comb_strict = codes[0], codes[1]
    aux = new.aux

    profile = params.opt("instr_profile") or GENERIC_PROFILE
    combs, leaf_kinds = profile[0], profile[1:]
    live = [i for i in range(4) if leaf_kinds[i]]
    tracks = [i for i in live if any(k in ("pickup", "putnext") for k in leaf_kinds[i])]
    seq = "before" in combs or "after" in combs
    pairs = (bool(leaf_kinds[1]), bool(leaf_kinds[3]))

    # update_objs_poss on drop (roomgrid_level.py:89-91); only goto and
    # putnext leaves read vmarks.
    if any(("goto" in ks) or ("putnext" in ks) for ks in leaf_kinds):
        new = new.replace(vmarks=torch.where(action == ACT_DROP, new.marks, new.vmarks))

    front = _front_cell(params, new)
    res, pc, marks_upd, cm_upd = {}, {}, {}, {}
    for i in live:
        c, l = divmod(i, 2)
        res[i], pc[i], marks_upd[i], cm_upd[i] = _leaf_eval(
            params, new, action, codes, c, l, aux[AUX_PC_NONE + i], front, leaf_kinds[i]
        )

    # BABYAI_DONE_ACTIONS mode (ActionInstr.verify, verifier.py:228-243):
    # success or failure only on `done`, judged by the previous verified
    # step's match; other steps record the match and continue.
    done_actions = bool(params.opt("done_actions", False))
    if done_actions:
        last_bits = aux[AUX_LAST_MATCH]
        is_done_act = action == ACT_DONE
        last_match_new = {}
        for i in live:
            last = (last_bits >> i) & 1
            last_match_new[i] = torch.where(is_done_act, last, (res[i] == 1).to(torch.int32))
            res[i] = torch.where(is_done_act, torch.where(last == 1, 1, 2), 0).to(torch.int32)

    def clause_result(c, eval_mask):
        """AndInstr of a clause's leaves (verifier.py:552-566): success when
        both succeeded (leaf dones stick), never failure.  Returns the
        result, the new leaf dones (None for a single leaf) and each
        leaf's evaluation mask."""
        i0, i1 = c * 2, c * 2 + 1
        if not pairs[c]:
            return res[i0], None, (eval_mask, None)
        is_and = clause_is_and(codes, c)
        d0, d1 = aux[AUX_LEAF_DONE + i0], aux[AUX_LEAF_DONE + i1]
        nd0 = torch.where(d0 == 1, 1, res[i0])
        nd1 = torch.where(d1 == 1, 1, res[i1])
        and_res = ((nd0 == 1) & (nd1 == 1)).to(torch.int32)
        r = torch.where(is_and, and_res, res[i0])
        both = eval_mask & is_and
        eval0 = eval_mask & (~is_and | (d0 != 1))
        eval1 = both & (d1 != 1)
        return r, (torch.where(both, nd0, d0), torch.where(both, nd1, d1)), (eval0, eval1)

    if not seq:  # one clause, evaluated every step
        status, dones_a, leaf_eval = clause_result(0, True)
        leaf_eval, leaf_done_new = leaf_eval + (None, None), (dones_a,)
    else:
        a_done, b_done = aux[AUX_A_DONE], aux[AUX_B_DONE]
        is_single = comb == COMB_SINGLE
        is_before = comb == COMB_BEFORE
        is_after = comb == COMB_AFTER
        everywhere = torch.ones_like(is_single)

        # Clause results as if evaluated; the eval masks follow.
        res_a = clause_result(0, everywhere)[0]
        res_b = clause_result(1, everywhere)[0]
        eval_a = (
            is_single
            | (is_before & (a_done != 1))
            | (is_after & ((b_done == 1) | ((res_b == 1) & (b_done != 1))))
            | (is_after & (comb_strict == 1) & (b_done != 1))
        )
        eval_b = (
            (is_before & ((a_done == 1) | ((a_done != 1) & (res_a == 1))))
            | (is_before & (comb_strict == 1) & (a_done != 1))
            | (is_after & (b_done != 1))
        )
        _, dones_a, eval_0 = clause_result(0, eval_a)
        _, dones_b, eval_1 = clause_result(1, eval_b)
        leaf_eval, leaf_done_new = eval_0 + eval_1, (dones_a, dones_b)

        # The top-level combinator (verifier.py:465-528).
        b_active = a_done == 1
        bf_status = torch.where(
            b_active, res_b,
            torch.where(res_a == 2, 2,
                        torch.where(res_a == 1, res_b,  # into b on the same step
                                    torch.where((comb_strict == 1) & (res_b == 1), 2, 0))),
        )
        bf_a_done = torch.where(b_active, a_done, res_a)
        bf_b_done = torch.where(b_active | (res_a == 1), res_b, b_done)
        a_active = b_done == 1
        af_status = torch.where(
            a_active, res_a,
            torch.where(res_b == 2, 2,
                        torch.where(res_b == 1, res_a,
                                    torch.where((comb_strict == 1) & (res_a == 1), 2, 0))),
        )
        af_b_done = torch.where(a_active, b_done, res_b)
        af_a_done = torch.where(a_active | (res_b == 1), res_a, a_done)
        status = torch.where(is_single, res_a, torch.where(is_before, bf_status, af_status))

    marks, cmarks = new.marks, new.carrying_marks
    writes = {}
    for i in tracks:
        # Only leaves that can track a carry move their remember bit and
        # their pc_none flag.
        rb = remember_bit(*divmod(i, 2))
        marks = _where(leaf_eval[i], (marks & ~rb) | (marks_upd[i] & rb), marks)
        cmarks = _where(leaf_eval[i], (cmarks & ~rb) | (cm_upd[i] & rb), cmarks)
        writes[AUX_PC_NONE + i] = _where(leaf_eval[i], pc[i], aux[AUX_PC_NONE + i])
    for c, dones in enumerate(leaf_done_new):
        if dones is not None:
            writes[AUX_LEAF_DONE + 2 * c], writes[AUX_LEAF_DONE + 2 * c + 1] = dones
    if seq:
        writes[AUX_A_DONE] = torch.where(
            is_before, bf_a_done, torch.where(is_after, af_a_done, a_done)
        )
        writes[AUX_B_DONE] = torch.where(
            is_before, bf_b_done, torch.where(is_after, af_b_done, b_done)
        )
    if done_actions:
        packed = last_bits
        for i in live:
            if leaf_eval[i] is not None:
                bit = _where(leaf_eval[i], last_match_new[i], (last_bits >> i) & 1)
                packed = (packed & ~(1 << i)) | (bit << i)
        writes[AUX_LAST_MATCH] = packed
    if writes:
        aux = aux.clone()
        for slot, value in writes.items():
            aux[slot] = value
    new = new.replace(aux=aux, marks=marks, carrying_marks=cmarks)

    succeeded, failed = status == 1, status == 2
    # The reward reads the per-episode step limit (minigrid_env.py:235-240
    # through roomgrid_level.py:96-98).
    r_succ = 1.0 - 0.9 * (new.step_count.to(torch.float32) / aux[AUX_MAX_STEPS].to(torch.float32))
    reward = torch.where(succeeded, r_succ, torch.where(failed, 0.0, reward))
    return new, reward, terminated | succeeded | failed


# -- mission surface text (host side) -----------------------------------------


def surface_text(codes) -> str:
    """The reference's mission string (Instr.surface, ObjDesc.surface) of
    one code vector (a sequence of 48 ints)."""
    codes = [int(c) for c in codes]

    def desc(c, l, d):
        b = _desc_base(c, l, d)
        t, col, loc, plural = codes[b], codes[b + 1], codes[b + 2], codes[b + 3]
        s = OBJ_TYPE_NAMES.get(t, "object")
        if col != COLOR_ANY:
            s = COLOR_NAMES6[col] + " " + s
        if loc != LOC_NONE:
            s += LOC_SUFFIX[loc]
        return ("a " if plural else "the ") + s

    def leaf_text(c, l):
        kind = codes[_leaf_base(c, l)]
        if kind == KIND_GOTO:
            return "go to " + desc(c, l, 0)
        if kind == KIND_OPEN:
            return "open " + desc(c, l, 0)
        if kind == KIND_PICKUP:
            return "pick up " + desc(c, l, 0)
        if kind == KIND_PUTNEXT:
            return "put " + desc(c, l, 0) + " next to " + desc(c, l, 1)
        return ""

    def clause_text(c):
        if codes[CLAUSE_OFF[c]] == 1:
            return leaf_text(c, 0) + " and " + leaf_text(c, 1)
        return leaf_text(c, 0)

    comb = codes[0]
    a = clause_text(0)
    if comb == COMB_SINGLE:
        return a
    b = clause_text(1)
    if comb == COMB_BEFORE:
        return a + ", then " + b
    return a + " after you " + b
