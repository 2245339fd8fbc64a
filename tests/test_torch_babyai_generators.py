"""The port's BabyAI generators on all 96 ids, by invariants checked in
numpy, independently of the port's own code:

* every active descriptor of the instruction matches an object, and the
  mark planes are exactly the cells each descriptor matches (with the
  plural flags), by a numpy reading of the reference's ``ObjDesc``;
* no PutNext starts satisfied or with its moved object among the fixed;
* every object is reachable from the agent where the level requires it
  (and some object is not, for UnblockPickup);
* the verifier's aux slots and the per-episode step limit start as
  ``RoomGridLevel.reset`` sets them.

The laws of the generators, held against JAX's, are in
``test_torch_babyai_laws.py``.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu_torch import make, registered_ids
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    DIR_TO_VEC,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B

torch.set_num_threads(1)

BABYAI = [i for i in registered_ids() if i.startswith("BabyAI-")]
N = 32
# Ids whose generator rejects a layout with an unreachable object, checked
# on the final layout (GoToImpUnlock checks before its last object).
REACHABLE = re.compile(
    r"BabyAI-(GoToRedBall|GoToLocal|GoTo-|GoToOpen|GoToObjMaze|GoToRedBlueBall|GoToObjDoor|"
    r"Open-|Pickup-|PutNextLocal|Unlock-|GoToSeq|PickupLoc)"
)


def desc_match(s: dict, b: int, rs: int, dtype: int, dcolor: int, dloc: int) -> np.ndarray:
    """(H, W) cells of env b matching the descriptor (ObjDesc.find_matching_objs)."""
    obj, color = s["grid_obj"][b], s["grid_color"][b]
    h, w = obj.shape
    m = obj != OBJ_EMPTY
    if dtype != B.TYPE_ANY:
        m &= obj == dtype
    if dcolor != B.COLOR_ANY:
        m &= color == dcolor
    if dloc == B.LOC_NONE:
        return m
    ax, ay = s["agent_pos"][b]
    dx, dy = DIR_TO_VEC[s["agent_dir"][b]]
    ys, xs = np.mgrid[0:h, 0:w]
    vx, vy = xs - ax, ys - ay
    front, right = vx * dx + vy * dy, vx * -dy + vy * dx
    where = {B.LOC_LEFT: right < 0, B.LOC_RIGHT: right > 0,
             B.LOC_FRONT: front > 0, B.LOC_BEHIND: front < 0}[dloc]
    tx, ty = (ax // (rs - 1)) * (rs - 1), (ay // (rs - 1)) * (rs - 1)
    room = (xs >= tx) & (xs < tx + rs) & (ys >= ty) & (ys < ty + rs)
    return m & where & room


def all_reachable(s: dict, b: int) -> bool:
    """Every object cell is reached by a flood from the agent through empty
    and door cells (check_objs_reachable)."""
    obj = s["grid_obj"][b]
    passable = (obj == OBJ_EMPTY) | (obj == OBJ_DOOR)
    reach = np.zeros_like(passable)
    reach[s["agent_pos"][b][1], s["agent_pos"][b][0]] = True
    while True:
        src = np.pad(reach & passable, 1)
        grown = reach | src[:-2, 1:-1] | src[2:, 1:-1] | src[1:-1, :-2] | src[1:-1, 2:]
        if (grown == reach).all():
            break
        reach = grown
    is_obj = (obj != OBJ_EMPTY) & (obj != OBJ_WALL)
    return bool((~is_obj | reach).all())


@pytest.mark.parametrize("env_id", BABYAI)
def test_generator_invariants(env_id):
    env = make(env_id)
    p = env.params
    rs, rows, cols = p.opt("room_size"), p.opt("num_rows"), p.opt("num_cols")
    s = to_numpy(env.generate(torch.Generator().manual_seed(3), p, N, device="cpu"))
    carrying = "Carrying" in env_id
    # The grid the verifier resolved: before PutNext lifts the carried
    # object, whose cell vmarks keep.
    seen = {k: v.copy() for k, v in s.items()}
    if carrying:
        rows_b = np.arange(N)
        x, y = s["aux"][:, 10], s["aux"][:, 11]
        seen["grid_obj"][rows_b, y, x] = s["carrying_obj"]
        seen["grid_color"][rows_b, y, x] = s["carrying_color"]
    reachable = []
    for b in range(N):
        codes = s["mission"][b]
        marks = s["vmarks"][b]
        want = np.zeros_like(marks)
        navs = 0
        for c in range(2):
            for l in range(2):
                kind = codes[B._leaf_base(c, l)]
                navs += 0 if kind == B.KIND_NONE else (2 if kind == B.KIND_PUTNEXT else 1)
                for d in range(2 if kind == B.KIND_PUTNEXT else (1 if kind else 0)):
                    base = B._desc_base(c, l, d)
                    m = desc_match(seen, b, rs, *codes[base:base + 3])
                    assert m.any(), (env_id, b, c, l, d)
                    assert codes[base + 3] == int(m.sum() > 1), (env_id, b, "plural")
                    want |= np.where(m, B.desc_bit(c, l, d), 0).astype(want.dtype)
                if kind == B.KIND_PUTNEXT:
                    move = (marks & B.desc_bit(c, l, 0)) > 0
                    fixed = np.pad((marks & B.desc_bit(c, l, 1)) > 0, 1)
                    near = fixed[:-2, 1:-1] | fixed[2:, 1:-1] | fixed[1:-1, :-2] | fixed[1:-1, 2:]
                    assert not (move & (near | fixed[1:-1, 1:-1])).any(), (env_id, b, "putnext")
        np.testing.assert_array_equal(marks, want, err_msg=f"{env_id} env {b}")
        if carrying:  # lifted: the cell is empty and the marks went along
            x, y = s["aux"][b, 10:12]
            assert s["grid_obj"][b, y, x] == OBJ_EMPTY and s["carrying_obj"][b] != OBJ_EMPTY
            assert s["carrying_marks"][b] == marks[y, x] and s["marks"][b, y, x] == 0
        else:
            np.testing.assert_array_equal(s["marks"][b], marks)
            assert s["carrying_obj"][b] == OBJ_EMPTY and s["carrying_marks"][b] == 0
        limit = p.max_steps if p.opt("fixed_max_steps") else navs * rs * rs * rows * cols
        assert s["aux"][b, B.AUX_MAX_STEPS] == limit, (env_id, b)
        assert (s["aux"][b, B.AUX_PC_NONE:B.AUX_PC_NONE + 4] == 1).all()
        assert (s["aux"][b, [B.AUX_A_DONE, B.AUX_B_DONE, B.AUX_LAST_MATCH]] == 0).all()
        assert env.mission_text(codes)
        reachable.append(all_reachable(s, b))
    if REACHABLE.match(env_id):
        assert all(reachable), env_id
    if env_id == "BabyAI-UnblockPickup-v0":
        assert not any(reachable)


def test_reachability_set_is_exact():
    """REACHABLE names exactly the ids whose level checks reachability."""
    assert sum(bool(REACHABLE.match(i)) for i in BABYAI) == 36
