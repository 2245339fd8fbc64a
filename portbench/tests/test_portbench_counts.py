"""The frozen work count of a key-domain value-iteration call against a
brute-force enumeration of every state's candidate actions, and against
the count the port keeps beside its kernel."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.counts import key_vi_work
from portbench.reference import doorkey as ref
from portbench.reference import key_vi

DIRS = key_vi.DIRS


def _layouts(size: int, n: int, seed: int) -> dict:
    """DoorKey layouts; the last one gets lava, a second key cell's worth
    of floor and its door closed instead of locked, so every branch of the
    count is taken."""
    raw = ref.make_layouts(np.random.default_rng(seed), n, size)
    last = n - 1
    raw["obj"][last, 1, size - 2] = ref.LAVA
    raw["obj"][last, size - 2, 1] = ref.FLOOR
    raw["state"][last][raw["obj"][last] == ref.DOOR] = ref.CLOSED
    return raw


def _brute_ops(raw: dict, doors: int) -> int:
    """Operations of one sweep, state by state: one multiply and one max
    for each candidate beyond the first."""
    obj, color, state = raw["obj"], raw["color"], raw["state"]
    n, h, w = obj.shape
    carried, total = h * w, 0
    for b in range(n):
        door_cells = [i for i in range(h * w) if obj[b].flat[i] == ref.DOOR][:doors]
        slot = {cell: s for s, cell in enumerate(door_cells)}
        keys = [i for i in range(h * w) if obj[b].flat[i] == ref.KEY]
        key_color = color[b].flat[keys[0]] if keys else 0
        for c in range(1 << doors):
            def opened(cell):
                return bool(c >> slot[cell] & 1) or state[b].flat[cell] == ref.OPEN

            def walkable(cell):
                o = obj[b].flat[cell]
                if o == ref.DOOR:
                    return opened(cell) if cell in slot else state[b].flat[cell] == ref.OPEN
                return o in (ref.EMPTY, ref.FLOOR, ref.GOAL, ref.LAVA, ref.KEY)

            for d, (dx, dy) in enumerate(DIRS):
                for y in range(h):
                    for x in range(w):
                        fx, fy = x + dx, y + dy
                        inside = 0 <= fx < w and 0 <= fy < h
                        f = fy * w + fx
                        for k in range(h * w + 1):
                            cands = 3  # left, right, done
                            if inside:
                                fo = obj[b].flat[f]
                                if walkable(f) and fo != ref.LAVA and k != f:
                                    cands += 1
                                if k == f:
                                    cands += 1
                                if k == carried and fo in (ref.EMPTY, ref.KEY):
                                    cands += 1
                                if f in slot and not opened(f):
                                    locked = state[b].flat[f] == ref.LOCKED
                                    if not locked:
                                        cands += 1
                                    elif k == carried and color[b].flat[f] == key_color:
                                        cands += 1
                            total += cands
    return total


def _tables(raw: dict, doors: int) -> key_vi.Tables:
    n = raw["obj"].shape[0]
    t = {k: torch.from_numpy(raw[k]) for k in ("obj", "color", "state")}
    return key_vi.tables(t["obj"], t["color"], t["state"], torch.full((n,), ref.EMPTY, dtype=torch.uint8),
                         torch.zeros(n, dtype=torch.uint8), doors)


@pytest.mark.parametrize("size,doors", [(5, 1), (6, 1), (6, 2)])
def test_count_matches_brute_force(size, doors):
    raw = _layouts(size, 3, seed=size + doors)
    nbytes, ops = key_vi_work.work(_tables(raw, doors), n_sweeps=7)
    assert ops == 7 * _brute_ops(raw, doors)
    n = raw["obj"].shape[0]
    v_bytes = n * (size * size + 1) * (1 << doors) * 4 * size * size * 4
    assert nbytes == key_vi_work.layout_bytes(n, size, size, doors) + v_bytes


@pytest.mark.parametrize("size", [6, 8])
def test_count_matches_the_ports_count(size):
    """The frozen count equals the port's own ``key_vi_work`` on the
    port's layouts of the same states (the record's bytes included)."""
    from minigrid_dynamicprogramming_tpu_torch import bridge
    from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK
    from portbench.drivers.dp_solve import port_arrays

    raw = _layouts(size, 4, seed=size)
    state = bridge.from_numpy(EnvState, port_arrays(raw), "cpu")
    theirs = cuda_vi.key_vi_work(TK.extract_key_layout(state, max_doors=1), 96)
    assert key_vi_work.work(_tables(raw, 1), 96) == theirs
