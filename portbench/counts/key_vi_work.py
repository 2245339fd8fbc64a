"""The work of one key-domain value-iteration call, counted from the layouts'
shapes and flags, whatever computes it.

Frozen from the count the port kept beside its kernel in 2026
(``dp/cuda_vi.py:key_vi_work``), rewritten over the reference's own
tables so that a later change to the program cannot move it:

* operations, per state and sweep: one multiply by gamma and one max for
  each candidate action beyond the first.  Stay, left and right are
  always candidates (3 operations); forward adds one where the front cell
  is walkable in the state's configuration, is not lava and does not
  hold the key; pickup one where the key lies in front; drop one where
  the key is carried and may land in front; toggle one where a closed
  door is in front, or a locked door that the key opens and the key is
  carried;
* bytes: the layouts read once and V (float32) written once.  A layout's
  bytes are those of the record the port's kernel wrapper reads in 2026:
  four (H, W) bool planes, an (H, W) int32 door-slot plane, the target and
  key positions, and per door slot its position, start state and
  whether the key opens it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.key_vi import Tables, _ahead, _front_cell


def layout_bytes(b: int, h: int, w: int, doors: int) -> int:
    """Bytes of ``b`` layouts' record: base_walk, base_empty, goal, lava
    (bool), door_id (int32) planes; target_pos (2 x int32), key0 (int32);
    per door slot: door_pos (2 x int32), door_init (int32),
    door_unlockable (bool)."""
    return b * (4 * h * w + 4 * h * w + 8 + 4 + doors * (8 + 4 + 1))


def work(t: Tables, n_sweeps: int) -> Tuple[int, int]:
    """(bytes, operations) of one call over the layouts of ``t`` at
    ``n_sweeps`` sweeps."""
    b, C, h, w = t.walk.shape
    K = h * w + 1
    doors = C.bit_length() - 1
    dev = t.walk.device
    fwd = pick = drop = tog = 0
    for d in range(4):
        front = _front_cell(h, w, d, dev)
        in_grid = front >= 0
        walk = _ahead(t.walk, d, False) & ~_ahead(t.lava, d, False)[:, None]
        fwd += int(walk.sum()) * (K - 1)  # every key location but the front cell
        pick += b * C * int(in_grid.sum())  # the key location at the front cell
        drop += int((_ahead(t.droppable, d, False) & in_grid).sum()) * C
        tog += int(_ahead(t.closed, d, False).sum()) * K + int(_ahead(t.unlockable, d, False).sum())
    per_sweep = b * K * C * 4 * h * w * 3 + fwd + pick + drop + tog
    nbytes = layout_bytes(b, h, w, doors) + b * K * C * 4 * h * w * 4
    return nbytes, n_sweeps * per_sweep
