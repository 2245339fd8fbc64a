"""Plain reference of BabyAI's BossLevel, written from the rules of Farama
Minigrid v2.3.1: ``minigrid/envs/babyai/synth.py:BossLevel`` over
``core/levelgen.py:LevelGen`` (at its defaults), ``core/roomgrid_level.py``,
``core/verifier.py``, ``minigrid/core/roomgrid.py``,
``minigrid/core/world_object.py`` and ``minigrid/minigrid_env.py``.

A 3x3 grid of rooms of ``ROOM`` = 8 cells (22 x 22, grey walls on every
seventh row and column); a locked room on a fair coin, its one door
locked, a key of the door's colour in another room; doors between
neighbouring rooms until every room is reachable (``connect_all``); 18
distractors (keys, balls, boxes of any colour); the agent outside the
locked room, not facing an object; an instruction of the grammar::

    instr  ::= clause | Before(clause, clause) | After(clause, clause)
    clause ::= leaf | And(leaf, leaf)
    leaf   ::= GoTo(d) | Open(d) | Pickup(d) | PutNext(d, d)

Nothing here comes from the program under test.  Three parts:

* :func:`invalid_layouts` judges fresh levels by LevelGen's rules
  (:func:`broken_rules` names the rules each breaks);
* :func:`step` is MiniGrid's step (balls, boxes, keys, locked doors) with
  an object-identity plane moved by pickup and drop, then the verifier:
  each descriptor's object set fixed at reset (``ObjDesc.obj_set``, with
  locations taken from the agent's pose then), its positions
  (``obj_poss``) refreshed only on a drop action
  (``RoomGridLevel.update_objs_poss``), each Pickup and PutNext leaf's
  ``preCarrying`` updated only when the leaf is verified, And latching
  each half's success, Before and After verifying their second clause
  only once the first has succeeded (on the same step), and failing
  where the second completes first only when strict;
* :func:`rollout` observes, steps, verifies and resets as
  ``reference/doorkey.py:rollout`` does.

A layout is ``reference/doorkey.py``'s state dict with three more
fields: ``contains`` (B, H, W) uint8, the object a box holds (``EMPTY``
for none), ``codes`` (B, 48) int64, the mission, and ``max_steps`` (B,)
int64, the episode's step limit as the program set it.  :func:`start`
turns a layout into an episode's state: it adds the verifier's fields
(``oid``, ``carry_id``, ``dset``, ``dposs``, ``pre``, ``and_done``,
``seq_done``) and sets ``max_steps`` by its own rule.

Departures from the published description, none of which changes a
result:

* the mission is its 48-int code vector, the wire format of the port and
  of the JAX package (as in ``babyai_gotodoor.py``), not its string.
  ``codes[0]`` is the combinator (0 single, 1 before, 2 after),
  ``codes[1]`` its strict flag; clause A sits at 2 and clause B at 25, 23
  slots each: an and-flag, then two leaves of 10 slots and a zero pad
  each.  A leaf is (kind: 1 goto, 2 open, 3 pickup, 4 putnext; strict;
  then two descriptors of (type: 4 door, 5 key, 6 ball, 7 box, 0 any;
  colour: 0-5, 6 any; location: 0 none, 1 left, 2 right, 3 front,
  4 behind; plural: more than one object matched at reset)).  A leaf or
  clause that is absent is all zero; a leaf that is not PutNext has the
  second descriptor (0, 6, 0, 0);
* objects are told apart by an identity plane (``oid``: 1 + the cell's
  index at reset, 0 for no object), where upstream compares Python
  objects; a box, when toggled, becomes its contents, which in LevelGen
  are always nothing (``add_distractors`` makes ``Box(color)``), so the
  cell and its identity empty;
* no layout holds a goal, lava or floor (:func:`invalid_layouts`), so
  forward enters empty cells and open doors only and no cell terminates
  an episode by itself;
* the step limit is ``num_navs * room_size**2 * num_rows * num_cols``
  (``RoomGridLevel.reset``: 576 a navigation, a PutNext two), set per
  episode.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from portbench.reference import doorkey as dk

ROOM = 8
ROWS = COLS = 3
PITCH = ROOM - 1
SIZE = PITCH * COLS + 1
NUM_DISTS = 18
NAV_STEPS = ROOM * ROOM * ROWS * COLS  # 576
COLORS = 6
DESCS = 8  # descriptor k = 2 * leaf + d, leaf i = 2 * clause + l

COMB_SINGLE, COMB_BEFORE, COMB_AFTER = 0, 1, 2
GOTO, OPEN, PICKUP, PUTNEXT = 1, 2, 3, 4
TYPE_ANY, COLOR_ANY = 0, 6
LOC_NONE, LOC_LEFT, LOC_RIGHT, LOC_FRONT, LOC_BEHIND = range(5)
CLAUSE_AT = (2, 25)
LEAF_AT = (1, 12)
CONTINUE, SUCCESS, FAILURE = 0, 1, 2
# The kinds of object each leaf's first descriptor may name (levelgen.py:
# rand_instr), and every descriptor's: OBJ_TYPES.
FIRST_TYPES = {GOTO: (dk.DOOR, dk.KEY, dk.BALL, dk.BOX), OPEN: (dk.DOOR,),
               PICKUP: (dk.KEY, dk.BALL, dk.BOX), PUTNEXT: (dk.KEY, dk.BALL, dk.BOX)}
ANY_TYPES = (dk.DOOR, dk.KEY, dk.BALL, dk.BOX)

COMPARED = dk.FIELDS + ("contains", "codes")

State = Dict[str, torch.Tensor]


def leaf_at(i: int) -> int:
    return CLAUSE_AT[i // 2] + LEAF_AT[i % 2]


def desc_at(k: int) -> int:
    return leaf_at(k // 2) + 2 + 4 * (k % 2)


def _kind(codes: torch.Tensor, i: int) -> torch.Tensor:
    return codes[:, leaf_at(i)]


def desc_active(codes: torch.Tensor, k: int) -> torch.Tensor:
    kind = _kind(codes, k // 2)
    return (kind != 0) & ((k % 2 == 0) | (kind == PUTNEXT))


def num_navs(codes: torch.Tensor) -> torch.Tensor:
    """``RoomGridLevel.num_navs_needed``: a PutNext leaf 2, another 1."""
    kinds = torch.stack([_kind(codes, i) for i in range(4)], 1)
    return torch.where(kinds == PUTNEXT, 2, (kinds != 0).long()).sum(1)


def _grids(h: int, w: int, dev):
    return torch.arange(h, device=dev)[:, None], torch.arange(w, device=dev)[None, :]


def _dir(adir: torch.Tensor):
    dx = torch.tensor([v[0] for v in dk.DIR_VEC], device=adir.device)[adir]
    dy = torch.tensor([v[1] for v in dk.DIR_VEC], device=adir.device)[adir]
    return dx, dy


def _next_to(m: torch.Tensor) -> torch.Tensor:
    """(B, H, W): the cells one step (up, down, left, right) from a cell of
    ``m`` (``pos_next_to``)."""
    out = torch.zeros_like(m)
    out[:, :-1] |= m[:, 1:]
    out[:, 1:] |= m[:, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    out[:, :, 1:] |= m[:, :, :-1]
    return out


def matches(s: State, k: int, ax: torch.Tensor, ay: torch.Tensor, adir: torch.Tensor) -> torch.Tensor:
    """(B, H, W): the cells whose object descriptor ``k`` of the mission
    names with the agent at (ax, ay) facing ``adir``
    (``ObjDesc.find_matching_objs``): any object but an empty cell (a
    wall too where the type is any), of the type and colour named, and
    where a location is named, in the agent's room (walls included,
    ``Room.pos_inside``) on the named side of the agent.  None where the
    descriptor is absent."""
    obj, color = s["obj"].long(), s["color"].long()
    b, h, w = obj.shape
    base = desc_at(k)
    t, c, loc = (s["codes"][:, base + j].long()[:, None, None] for j in range(3))
    m = (obj != dk.EMPTY) & ((t == TYPE_ANY) | (obj == t)) & ((c == COLOR_ANY) | (color == c))
    ys, xs = _grids(h, w, obj.device)
    x0 = (ax // PITCH * PITCH)[:, None, None]
    y0 = (ay // PITCH * PITCH)[:, None, None]
    in_room = (xs >= x0) & (xs < x0 + ROOM) & (ys >= y0) & (ys < y0 + ROOM)
    vx, vy = xs - ax[:, None, None], ys - ay[:, None, None]
    d1x, d1y = (d[:, None, None] for d in _dir(adir))
    ahead, right = vx * d1x + vy * d1y, vx * -d1y + vy * d1x
    side = torch.where(loc == LOC_LEFT, right < 0, torch.where(
        loc == LOC_RIGHT, right > 0, torch.where(loc == LOC_FRONT, ahead > 0, ahead < 0)))
    m = m & ((loc == LOC_NONE) | (in_room & side))
    return m & desc_active(s["codes"], k)[:, None, None]


# --- the rules of a fresh level ------------------------------------------------

def _segments(dev) -> torch.Tensor:
    """(H, W) int64: each cell of a wall between two neighbouring rooms,
    corners left out, numbered 0-11 (0-5 between left and right
    neighbours, 6-11 between upper and lower), -1 elsewhere."""
    ys, xs = _grids(SIZE, SIZE, dev)
    seg = torch.full((SIZE, SIZE), -1, dtype=torch.int64, device=dev)
    inner = (xs > 0) & (xs < SIZE - 1) & (ys > 0) & (ys < SIZE - 1)
    vertical = inner & (xs % PITCH == 0) & (ys % PITCH != 0)
    horizontal = inner & (ys % PITCH == 0) & (xs % PITCH != 0)
    seg = torch.where(vertical, (ys // PITCH) * (COLS - 1) + xs // PITCH - 1, seg)
    return torch.where(horizontal, 6 + (ys // PITCH - 1) * COLS + xs // PITCH, seg)


def _segment_rooms() -> list:
    """The two rooms (j * COLS + i) each wall segment joins."""
    out = [(j * COLS + i, j * COLS + i + 1) for j in range(ROWS) for i in range(COLS - 1)]
    return out + [(j * COLS + i, (j + 1) * COLS + i) for j in range(ROWS - 1) for i in range(COLS)]


def _room_of(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (y // PITCH).clamp(max=ROWS - 1) * COLS + (x // PITCH).clamp(max=COLS - 1)


def _codes_ok(codes: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the codes are a well-typed instruction of the grammar as
    LevelGen draws it (nothing strict, pads zero)."""
    comb = codes[:, 0]
    ok = (comb >= 0) & (comb <= 2) & (codes[:, 1] == 0)
    for c in range(2):
        base = CLAUSE_AT[c]
        present = torch.ones_like(ok) if c == 0 else comb != COMB_SINGLE
        nand = codes[:, base]
        ok &= ((nand == 0) | ((nand == 1) & present)) & (codes[:, base + 11] == 0) & (codes[:, base + 22] == 0)
        for l in range(2):
            at = leaf_at(2 * c + l)
            leaf = codes[:, at:at + 10]
            active = present & ((l == 0) | (nand == 1))
            kind = leaf[:, 0]
            first = torch.zeros_like(ok)
            for k, types in FIRST_TYPES.items():
                first |= (kind == k) & torch.isin(leaf[:, 2], torch.tensor(types, device=codes.device))
            d1 = (leaf[:, 3] >= 0) & (leaf[:, 3] <= COLOR_ANY) & (leaf[:, 4] >= 0) & (leaf[:, 4] <= 4) \
                & (leaf[:, 5] >= 0) & (leaf[:, 5] <= 1)
            d2_put = torch.isin(leaf[:, 6], torch.tensor(ANY_TYPES, device=codes.device)) \
                & (leaf[:, 7] >= 0) & (leaf[:, 7] <= COLOR_ANY) & (leaf[:, 8] >= 0) & (leaf[:, 8] <= 4) \
                & (leaf[:, 9] >= 0) & (leaf[:, 9] <= 1)
            d2_none = (leaf[:, 6] == 0) & (leaf[:, 7] == COLOR_ANY) & (leaf[:, 8] == 0) & (leaf[:, 9] == 0)
            typed = first & (leaf[:, 1] == 0) & d1 & torch.where(kind == PUTNEXT, d2_put, d2_none)
            ok &= torch.where(active, typed, (leaf == 0).all(1))
    return ok


def broken_rules(s: State) -> Dict[str, torch.Tensor]:
    """Each rule of LevelGen at BossLevel's settings by name, (B,) bool
    where a fresh level breaks it.  A valid one is a fresh episode (nothing
    carried, step 0, not done) on a 22 x 22 grid whose

    * walls are the grey walls of the 3x3 rooms, with doors only on the
      wall segments between neighbouring rooms (corners left out), at most
      one a segment, each closed or locked, of one of the six colours;
    * every room is reachable from the agent's room through the doors,
      locked ones passable (``implicit_unlock``);
    * at most one door is locked; its room (the locked room) has no other
      door, and a key of its colour lies outside it;
    * rooms hold 18 distractors (keys, balls, boxes of the six colours,
      holding nothing), plus that key, every other cell empty;
    * the agent stands on an empty cell outside the locked room, facing
      0-3 an empty cell or a wall (``RoomGrid.place_agent``);
    * codes form a well-typed instruction (:func:`_codes_ok`) whose every
      descriptor matches an object at the agent's pose, with its plural
      flag where it matches more than one; no PutNext starts satisfied or
      moves an object among the fixed ones; no descriptor names a key of
      a locked door's colour (``validate_instrs``, ``unblocking``);
    * ``max_steps`` is ``num_navs * 576``."""
    obj, color, st = s["obj"].long(), s["color"].long(), s["state"].long()
    b, h, w = obj.shape
    dev = obj.device
    if (h, w) != (SIZE, SIZE):
        return {"size": torch.ones(b, dtype=torch.bool, device=dev)}
    ys, xs = _grids(h, w, dev)
    wall_line = (ys % PITCH == 0) | (xs % PITCH == 0)
    seg = _segments(dev)
    is_door = obj == dk.DOOR
    locked = is_door & (st == dk.LOCKED)
    walls_ok = torch.where(
        is_door, (seg >= 0) & (color < COLORS) & ((st == dk.CLOSED) | (st == dk.LOCKED)),
        torch.where(wall_line, (obj == dk.WALL) & (color == dk.GREY) & (st == 0),
                    (st == 0) & (((obj == dk.EMPTY) & (color == 0))
                                 | (((obj == dk.KEY) | (obj == dk.BALL) | (obj == dk.BOX)) & (color < COLORS)))))
    ok = {"walls": walls_ok.reshape(b, -1).all(1), "boxes_empty": (s["contains"] == dk.EMPTY).reshape(b, -1).all(1)}

    # Doors by segment, the rooms' graph and its reach from the agent's room.
    one_hot = seg[None] == torch.arange(12, device=dev)[:, None, None]  # (12, H, W)
    doors = (is_door[:, None] & one_hot).reshape(b, 12, -1).sum(2)  # (B, 12)
    locked_at = (locked[:, None] & one_hot).reshape(b, 12, -1).any(2)
    ok["one_door_a_wall"] = (doors <= 1).all(1)
    adj = torch.zeros(b, 9, 9, dtype=torch.bool, device=dev)
    degree = torch.zeros(b, 9, dtype=torch.int64, device=dev)
    for k, (r1, r2) in enumerate(_segment_rooms()):
        adj[:, r1, r2] |= doors[:, k] > 0
        adj[:, r2, r1] |= doors[:, k] > 0
        degree[:, r1] += doors[:, k]
        degree[:, r2] += doors[:, k]
    ax, ay, adir = s["ax"], s["ay"], s["adir"]
    axc, ayc = ax.clamp(0, w - 1), ay.clamp(0, h - 1)
    reach = torch.nn.functional.one_hot(_room_of(axc, ayc), 9).bool()
    for _ in range(8):
        reach = reach | (reach[:, :, None] & adj).any(1)
    ok["connected"] = reach.all(1)

    # The locked room: of the two rooms its door joins, the one with no other door.
    n_locked = locked.reshape(b, -1).sum(1)
    ok["one_locked"] = n_locked <= 1
    has_locked = n_locked == 1
    pair = torch.tensor(_segment_rooms(), device=dev)  # (12, 2)
    k_locked = locked_at.long().argmax(1)
    r1, r2 = pair[k_locked, 0], pair[k_locked, 1]
    d1, d2 = degree.gather(1, r1[:, None])[:, 0], degree.gather(1, r2[:, None])[:, 0]
    ok["locked_room"] = ~has_locked | ((d1 == 1) != (d2 == 1))
    locked_room = torch.where(has_locked, torch.where(d1 == 1, r1, r2), -1)
    lock_color = torch.where(locked, color, COLORS).reshape(b, -1).amin(1)
    rooms = _room_of(xs, ys).expand(h, w)
    outside = rooms[None] != locked_room[:, None, None]
    key_out = ((obj == dk.KEY) & (color == lock_color[:, None, None]) & outside & ~wall_line).reshape(b, -1).any(1)
    ok["key_outside"] = ~has_locked | key_out
    n_objects = ((obj == dk.KEY) | (obj == dk.BALL) | (obj == dk.BOX)).reshape(b, -1).sum(1)
    ok["objects"] = n_objects == NUM_DISTS + n_locked

    # The agent.
    agent_ok = (ax % PITCH != 0) & (ay % PITCH != 0) & (ax > 0) & (ax < w - 1) & (ay > 0) & (ay < h - 1) \
        & (adir >= 0) & (adir < 4)
    adir_c = adir.clamp(0, 3)
    dx, dy = _dir(adir_c)
    front = dk._cell(s["obj"], (axc + dx).clamp(0, w - 1), (ayc + dy).clamp(0, h - 1)).long()
    agent_ok &= (dk._cell(s["obj"], axc, ayc) == dk.EMPTY) & ((front == dk.EMPTY) | (front == dk.WALL))
    agent_ok &= _room_of(axc, ayc) != locked_room
    ok["agent"] = agent_ok
    ok["fresh"] = (s["carry_obj"] == dk.EMPTY) & (s["carry_color"] == 0) & (s["steps"] == 0) \
        & ~s["terminated"] & ~s["truncated"]

    # The instruction.
    codes = s["codes"].long()
    ok["codes"] = _codes_ok(codes)
    found = {}
    ok["descriptors"] = ok["unblocking"] = ok["putnext"] = torch.ones_like(ok["codes"])
    for k in range(DESCS):
        found[k] = matches(s, k, axc, ayc, adir_c)
        count = found[k].reshape(b, -1).sum(1)
        active = desc_active(codes, k)
        base = desc_at(k)
        ok["descriptors"] = ok["descriptors"] & (~active | ((count >= 1) & (codes[:, base + 3] == (count > 1).long())))
        names_key = (codes[:, base] == dk.KEY) & (codes[:, base + 1] == lock_color) & has_locked
        ok["unblocking"] = ok["unblocking"] & ~(active & names_key)
    for i in range(4):
        move, fixed = found[2 * i], found[2 * i + 1]
        bad = (move & (fixed | _next_to(fixed))).reshape(b, -1).any(1)
        ok["putnext"] = ok["putnext"] & ~((_kind(codes, i) == PUTNEXT) & bad)
    ok["max_steps"] = s["max_steps"].long() == num_navs(codes) * NAV_STEPS
    return {rule: ~held for rule, held in ok.items()}


def invalid_layouts(s: State) -> torch.Tensor:
    """(B,) bool: the fresh levels that break any of :func:`broken_rules`."""
    return torch.stack(list(broken_rules(s).values())).any(0)


def instruction_shapes(codes: torch.Tensor) -> torch.Tensor:
    """(B,) the shape of each mission among {single, before, after} x
    {goto, open, pickup, putnext} of clause A's first leaf:
    ``comb * 4 + kind - 1``."""
    return codes[:, 0].long() * 4 + _kind(codes, 0).long() - 1


def unseen_shapes(shapes: torch.Tensor) -> int:
    """How many of the 12 shapes :func:`instruction_shapes` names are
    missing from ``shapes``."""
    return 12 - len(set(shapes.unique().tolist()) & set(range(12)))


# --- an episode's state ----------------------------------------------------------

def start(layout: State) -> State:
    """A fresh episode's state from a layout: the layout's fields, the
    identity plane, and the verifier reset (``Instr.reset_verifier``):
    each descriptor's object set and positions at the agent's pose, no
    ``preCarrying``, no half done, and ``max_steps`` by the rule."""
    s = {k: layout[k] for k in COMPARED}
    obj = s["obj"]
    b, h, w = obj.shape
    dev = obj.device
    s["codes"] = s["codes"].long()
    cells = torch.arange(1, h * w + 1, device=dev).reshape(1, h, w)
    s["oid"] = torch.where(obj != dk.EMPTY, cells, 0)
    s["carry_id"] = torch.zeros(b, dtype=torch.int64, device=dev)
    sets = torch.stack([matches(s, k, s["ax"], s["ay"], s["adir"]) for k in range(DESCS)], 1)
    s["dposs"] = sets.reshape(b, DESCS, h * w)
    s["dset"] = torch.cat([torch.zeros(b, DESCS, 1, dtype=torch.bool, device=dev), s["dposs"]], 2)
    s["pre"] = torch.zeros(b, 4, dtype=torch.int64, device=dev)
    s["and_done"] = torch.zeros(b, 2, 2, dtype=torch.bool, device=dev)
    s["seq_done"] = torch.zeros(b, 2, dtype=torch.bool, device=dev)
    s["max_steps"] = num_navs(s["codes"]) * NAV_STEPS
    return s


# --- the transition (MiniGridEnv.step) ---------------------------------------------

def transition(s: State, action: torch.Tensor) -> State:
    """One ``MiniGridEnv.step`` of every env: turns, forward into an empty
    cell or an open door, pickup of a key, ball or box with empty hands,
    drop onto an empty cell, toggle (a door opens or closes, a locked one
    opens with a key of its colour, a box becomes its contents: nothing);
    the identity of a picked up object rides with the agent and lands
    where it is dropped; ``truncated`` at the episode's ``max_steps``."""
    b, h, w = s["obj"].shape
    action = action.to(torch.int64)
    fx, fy = dk._front(s)  # the agent stands inside the walls
    idx = (fy * w + fx)[:, None]
    fobj, fcol, fst = (dk._cell(s[k], fx, fy) for k in ("obj", "color", "state"))
    foid = dk._cell(s["oid"], fx, fy)
    adir = torch.where(action == dk.LEFT, (s["adir"] + 3) % 4,
                       torch.where(action == dk.RIGHT, (s["adir"] + 1) % 4, s["adir"]))
    move = (action == dk.FORWARD) & ((fobj == dk.EMPTY) | ((fobj == dk.DOOR) & (fst == dk.OPEN)))
    empty_hands = s["carry_obj"] == dk.EMPTY
    pickup = (action == dk.PICKUP) & empty_hands & ((fobj == dk.KEY) | (fobj == dk.BALL) | (fobj == dk.BOX))
    drop = (action == dk.DROP) & ~empty_hands & (fobj == dk.EMPTY)
    door = (action == dk.TOGGLE) & (fobj == dk.DOOR)
    unlock = door & (fst == dk.LOCKED) & (s["carry_obj"] == dk.KEY) & (s["carry_color"] == fcol)
    flip = door & (fst != dk.LOCKED)
    open_box = (action == dk.TOGGLE) & (fobj == dk.BOX)
    gone = pickup | open_box

    new_obj = torch.where(gone, dk.EMPTY, torch.where(drop, s["carry_obj"], fobj))
    new_col = torch.where(gone, 0, torch.where(drop, s["carry_color"], fcol))
    new_st = torch.where(gone | drop, 0, torch.where(unlock, dk.OPEN, torch.where(
        flip, torch.where(fst == dk.OPEN, dk.CLOSED, dk.OPEN), fst)))
    new_oid = torch.where(gone, 0, torch.where(drop, s["carry_id"], foid))

    def put(plane, val):
        return plane.reshape(b, -1).scatter(1, idx, val[:, None].to(plane.dtype)).reshape(b, h, w)

    out = dict(s)
    out.update({
        "obj": put(s["obj"], new_obj), "color": put(s["color"], new_col),
        "state": put(s["state"], new_st), "oid": put(s["oid"], new_oid),
        "ax": torch.where(move, fx, s["ax"]), "ay": torch.where(move, fy, s["ay"]), "adir": adir,
        "carry_obj": torch.where(pickup, fobj, torch.where(drop, dk.EMPTY, s["carry_obj"])).to(torch.uint8),
        "carry_color": torch.where(pickup, fcol, torch.where(drop, 0, s["carry_color"])).to(torch.uint8),
        "carry_id": torch.where(pickup, foid, torch.where(drop, 0, s["carry_id"])),
        "steps": s["steps"] + 1,
    })
    out["truncated"] = out["steps"] >= s["max_steps"]
    return out


# --- the verifier (core/verifier.py, RoomGridLevel.step) ---------------------------

def _leaf(v: State, action: torch.Tensor, i: int, mask: torch.Tensor) -> torch.Tensor:
    """``verify_action`` of leaf ``i`` where ``mask`` holds: (B,) status.
    Pickup and PutNext leaves remember what is carried (``preCarrying``)
    on every verification."""
    codes = v["codes"]
    b, h, w = v["obj"].shape
    kind = _kind(codes, i)
    strict = codes[:, leaf_at(i) + 1] == 1
    objects, fixed_at = v["dset"][:, 2 * i], v["dposs"][:, 2 * i + 1]
    fx, fy = dk._front(v)
    fidx = fy * w + fx
    fobj, fst = dk._cell(v["obj"], fx, fy), dk._cell(v["state"], fx, fy)
    foid = dk._cell(v["oid"], fx, fy)
    carry, pre = v["carry_id"], v["pre"][:, i]
    toggle, picking, dropping = action == dk.TOGGLE, action == dk.PICKUP, action == dk.DROP

    # GoTo: the front cell is one of the descriptor's positions.
    goto = v["dposs"][:, 2 * i].gather(1, fidx[:, None])[:, 0]
    # Open: the front cell is one of its doors, open after the toggle.
    front_door = toggle & (fobj == dk.DOOR)
    opened = front_door & (fst == dk.OPEN) & objects.gather(1, foid[:, None])[:, 0]
    # Pickup: nothing carried before, one of its objects carried now.
    picked = picking & (pre == 0) & objects.gather(1, carry[:, None])[:, 0] & (carry != 0)
    # PutNext: the object carried before, one of the movers, now lies next
    # to a position of a fixed object.
    at = v["oid"] == pre[:, None, None]
    put = dropping & (pre != 0) & objects.gather(1, pre[:, None])[:, 0] \
        & (at & _next_to(fixed_at.reshape(b, h, w))).reshape(b, -1).any(1)

    succ = torch.where(kind == GOTO, goto, torch.where(kind == OPEN, opened, torch.where(
        kind == PICKUP, picked, (kind == PUTNEXT) & put)))
    fail = strict & ~succ & torch.where(kind == OPEN, front_door, ((kind == PICKUP) | (kind == PUTNEXT))
                                         & picking & (carry != 0))
    remembers = mask & ((kind == PICKUP) | (kind == PUTNEXT))
    v["pre"] = v["pre"].clone()
    v["pre"][:, i] = torch.where(remembers, carry, pre)
    return torch.where(succ, SUCCESS, torch.where(fail, FAILURE, CONTINUE))


def _clause(v: State, action: torch.Tensor, c: int, mask: torch.Tensor) -> torch.Tensor:
    """A clause verified where ``mask`` holds: its one leaf, or
    ``AndInstr.verify``: each half verified until it has succeeded,
    success once both have, never failure."""
    is_and = v["codes"][:, CLAUSE_AT[c]] == 1
    single = _leaf(v, action, 2 * c, mask & ~is_and)
    done = v["and_done"][:, c]
    now = []
    for half in range(2):
        evaluated = mask & is_and & ~done[:, half]
        r = _leaf(v, action, 2 * c + half, evaluated)
        now.append(done[:, half] | (evaluated & (r == SUCCESS)))
    v["and_done"] = v["and_done"].clone()
    v["and_done"][:, c] = torch.stack(now, 1)
    both = torch.where(now[0] & now[1], SUCCESS, CONTINUE)
    return torch.where(is_and, both, single)


def _seq(v: State, action: torch.Tensor, mask: torch.Tensor, first: int, second: int) -> torch.Tensor:
    """``BeforeInstr.verify`` (first A, then B) where ``mask`` holds;
    ``AfterInstr.verify`` is the same with B first.  The first clause is
    verified until it succeeds; on that step and every step after, the
    second; strict, the second's success while the first is pending
    fails."""
    strict = v["codes"][:, 1] == 1
    done = v["seq_done"][:, first]
    pending = mask & ~done
    r_first = _clause(v, action, first, pending)
    newly = pending & (r_first == SUCCESS)
    v["seq_done"] = v["seq_done"].clone()
    v["seq_done"][:, first] = done | newly
    onto = (mask & done) | newly
    r_second = _clause(v, action, second, onto | (pending & strict & (r_first == CONTINUE)))
    early = torch.where(strict & (r_second == SUCCESS), FAILURE, CONTINUE)
    return torch.where(onto, r_second, torch.where(r_first == FAILURE, FAILURE, early))


def verify(v: State, action: torch.Tensor) -> tuple:
    """``RoomGridLevel.step``'s verification after the transition: on a
    drop action each descriptor's positions are those of its objects on
    the grid (``update_objs_poss``), then the instruction is verified.
    Returns (state, status: 0 continue, 1 success, 2 failure)."""
    action = action.to(torch.int64)
    v = dict(v)
    b, h, w = v["obj"].shape
    oid = v["oid"].reshape(b, 1, h * w).expand(b, DESCS, h * w)
    on_grid = v["dset"].gather(2, oid) & (oid != 0)
    v["dposs"] = torch.where((action == dk.DROP)[:, None, None], on_grid, v["dposs"])
    comb = v["codes"][:, 0]
    single = _clause(v, action, 0, comb == COMB_SINGLE)
    before = _seq(v, action, comb == COMB_BEFORE, 0, 1)
    after = _seq(v, action, comb == COMB_AFTER, 1, 0)
    status = torch.where(comb == COMB_BEFORE, before, torch.where(comb == COMB_AFTER, after, single))
    return v, status


def step(s: State, action: torch.Tensor, reward_dtype=torch.float64):
    """One ``RoomGridLevel.step`` of every env: (state, reward,
    terminated).  Success ends the episode with the reward
    ``1 - 0.9 * step_count / max_steps`` (in ``reward_dtype``; upstream's
    Python floats are float64), failure with 0."""
    v, status = verify(transition(s, action), action)
    success, failure = status == SUCCESS, status == FAILURE
    one = torch.ones((), dtype=reward_dtype, device=success.device)
    reward = torch.where(success, one - 0.9 * (v["steps"].to(reward_dtype) / v["max_steps"].to(reward_dtype)),
                         torch.zeros((), dtype=reward_dtype, device=success.device))
    v["terminated"] = success | failure
    return v, reward, v["terminated"]


def progress(s: State) -> torch.Tensor:
    """(B, 9) bool: how far each episode's verification has come: the
    first clause of a Before (A) or an After (B) succeeded, each half of
    each clause's And succeeded (clause A's two, then B's), and each
    leaf's ``preCarrying`` is None."""
    comb = s["codes"][:, 0]
    first = torch.where(comb == COMB_BEFORE, s["seq_done"][:, 0],
                        torch.where(comb == COMB_AFTER, s["seq_done"][:, 1], False))
    return torch.cat([first[:, None], s["and_done"].reshape(-1, 4), s["pre"] == 0], 1)


# --- the autoreset rollout -------------------------------------------------------

def select(done: torch.Tensor, fresh: State, cur: State) -> State:
    out = {}
    for k, x in cur.items():
        d = done.reshape((-1,) + (1,) * (x.dim() - 1))
        out[k] = torch.where(d, fresh[k].to(x.dtype), x)
    return out


def rollout(first: State, actions: torch.Tensor, fresh: Callable[[int, torch.Tensor], State],
            reward_dtype=torch.float64) -> dict:
    """``actions.shape[0]`` steps of every env from the episode states
    ``first`` (:func:`start`'s).  After each step a finished episode
    (terminated or truncated) restarts from ``fresh(t, resets)`` (started
    episodes for step t, given each lane's count of resets so far), and
    the view of the new state is observed.

    Returns the final state, each lane's resets, and the sums over the
    steps: reward (in ``reward_dtype``), finished episodes, successes
    (terminations with a positive reward), failures (the other
    terminations) and the view checksum (int64, before any modulus)."""
    s = first
    b = s["obj"].shape[0]
    dev = s["obj"].device
    resets = torch.zeros(b, dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=reward_dtype, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)  # episodes, successes, ends, checksum
    for t in range(actions.shape[0]):
        s, reward, term = step(s, actions[t], reward_dtype)
        done = term | s["truncated"]
        resets = resets + done.to(torch.int64)
        s = select(done, fresh(t, resets), s)
        reward_sum = reward_sum + reward.sum()
        counts += torch.stack([done.sum(), (term & (reward > 0)).sum(), term.sum(), dk.obs_checksum(s)])
    episodes, successes, ends, checksum = counts.tolist()
    return {
        "state": s, "resets": resets, "reward": float(reward_sum), "episodes": episodes,
        "successes": successes, "failures": ends - successes, "checksum": checksum,
    }
