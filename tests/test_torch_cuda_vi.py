"""The CUDA wrappers of ``dp/cuda_vi.py`` on the CPU.

On CPU tensors each wrapper runs its plain version, and that is held
against the JAX package's Pallas kernel in interpret mode, as
``tests/test_dp.py`` runs it: bit for bit for the restricted domain, within
atol 1e-6 for the key-position domain.  The wrapper must not count a launch
there.

The kernels themselves run only on a card (``tests/test_torch_on_card.py``);
what can be checked here is the contract between a wrapper and its kernel.
The ``*_plan`` helpers mirror how each ``.cu`` file splits the states over
its threads and CTAs, from the plan the wrapper hands the kernel
(``cuda_vi.vi_plan``, ``key_vi_groups``, ``key_vi_wide_groups``,
``key_vi_rows``): which thread owns which states, and where each
candidate's read lands (for the key domain: which CTA of the cluster, at
which offset of its shared memory; for the restricted domain: which
toggle-table entry a door-facing thread reads).
``_run_vi_plan``, ``_run_key_vi_plan`` and ``_run_key_vi_wide_plan``
replay each kernel's arithmetic over the byte masks the wrapper builds,
thread by thread and item by item through those plans, and must reproduce
the plain values.  The wide route's replay also runs its rounds in the
kernel's order against one shared-memory image per CTA, and checks that
no read sees a value written in the same sweep, which is what makes its
in-place sweep exact.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp import tabular as jtab
from minigrid_dynamicprogramming_tpu.dp import tabular_key as jkey
from minigrid_dynamicprogramming_tpu.dp.pallas_vi import (
    pallas_key_value_iteration,
    pallas_value_iteration,
)

from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

torch.set_num_threads(1)

GAMMA = 0.995


def _states(env_id: str, batch: int, seed: int):
    """(JAX batch of states, the same states in the port)."""
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    arrays = {n: np.asarray(getattr(states, n)) for n in states.__dataclass_fields__}
    return states, from_numpy(EnvState, arrays, "cpu")


def test_cuda_vi_plain_path_matches_pallas_interpret():
    jstates, tstates = _states("MiniGrid-DoorKey-5x5-v0", 4, seed=0)
    jlay = jax.vmap(partial(jtab.extract_layout, max_doors=1))(jstates)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_value_iteration(jlay, gamma=GAMMA, n_sweeps=48)
    before = profiling.counter("vi.launches")
    got = cuda_vi.cuda_value_iteration(ttab.extract_layout(tstates, 1), GAMMA, 48)
    assert profiling.counter("vi.launches") == before  # CPU: no kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_key_vi_plain_path_matches_pallas_interpret():
    jstates, tstates = _states("MiniGrid-DoorKey-8x8-v0", 3, seed=2)
    jlay = jax.vmap(partial(jkey.extract_key_layout, max_doors=1))(jstates)
    with pltpu.force_tpu_interpret_mode():
        jv_pl = pallas_key_value_iteration(jlay, gamma=GAMMA, n_sweeps=48)
    tlay = tkey.extract_key_layout(tstates, 1)
    assert (np.asarray(jv_pl) > 0).any()
    before = profiling.counter("key_vi.launches")
    got = cuda_vi.cuda_key_value_iteration(tlay, GAMMA, 48)
    assert profiling.counter("key_vi.launches") == before
    np.testing.assert_allclose(got.numpy(), np.asarray(jv_pl), rtol=0, atol=1e-6)


def test_wrappers_check_their_inputs():
    _, tstates = _states("MiniGrid-DoorKey-5x5-v0", 2, seed=5)
    layouts = ttab.extract_layout(tstates, 1)
    with pytest.raises(ValueError, match="door_id"):
        cuda_vi.cuda_value_iteration(
            dataclasses.replace(layouts, door_id=layouts.door_id.long()), GAMMA, 4
        )
    with pytest.raises(ValueError, match="key_pos"):
        cuda_vi.cuda_value_iteration(
            dataclasses.replace(layouts, key_pos=layouts.key_pos[:1]), GAMMA, 4
        )
    with pytest.raises(ValueError, match="n_sweeps"):
        cuda_vi.cuda_value_iteration(layouts, GAMMA, -1)
    key_layouts = tkey.extract_key_layout(tstates, 1)
    with pytest.raises(ValueError, match="base_empty"):
        cuda_vi.cuda_key_value_iteration(
            dataclasses.replace(key_layouts, base_empty=key_layouts.base_empty.to(torch.uint8)),
            GAMMA, 4,
        )


def test_work_counts():
    """The bound's operation counts lie between the always-present
    candidates and every candidate at every state."""
    _, tstates = _states("MiniGrid-DoorKey-8x8-v0", 3, seed=6)
    for layouts, work, states, n_opt in [
        (ttab.extract_layout(tstates, 1), cuda_vi.vi_work, 3 * 6 * 4 * 64, 3),
        (tkey.extract_key_layout(tstates, 1), cuda_vi.key_vi_work, 3 * 65 * 2 * 4 * 64, 4),
    ]:
        nbytes, ops = work(layouts, 10)
        assert 10 * states * 3 < ops < 10 * states * (3 + n_opt)
        assert nbytes > states * 4


# --- The kernels' index plans ------------------------------------------------

_STEP = lambda w: (1, w, -1, -w)  # raster step to the front cell, per direction


def _doors(C: int) -> int:
    """D of C = 2 * 3**D configs."""
    D = 0
    while 2 * 3**D < C:
        D += 1
    assert 2 * 3**D == C
    return D


def _vi_plan(b: int, hw: int, C: int):
    """``csrc/vi.cu``'s threads: (layout, config group, cell) of every active
    thread over all blocks, as the kernel derives them from (blockIdx,
    threadIdx) and the wrapper's (lpb, G); and G."""
    lpb, G = cuda_vi.vi_plan(C, _doors(C), hw)
    per = G * hw
    blocks = -(-b // lpb)
    t = torch.arange(lpb * per)
    slot = t // per
    g = (t - slot * per) // hw
    cell = t - slot * per - g * hw
    layout = (torch.arange(blocks)[:, None] * lpb + slot[None]).reshape(-1)
    active = layout < b
    return layout[active], g.repeat(blocks)[active], cell.repeat(blocks)[active], G


def _run_vi_plan(layouts, gamma: float, n_sweeps: int) -> torch.Tensor:
    """``vi_kernel``'s arithmetic, thread by thread (all threads at once):
    each thread's registers, then its sweep over its carry pairs (c, c + 1),
    each pair taking stay, turns, forward, pickup and, where the thread
    faces a door, the toggle, read as the kernel reads it: the target
    config at ``tog[c * D + slot]`` of the layout's flat table.  Reads and
    writes of its layout's V are flat."""
    walk, flags, slot, tog = cuda_vi.vi_masks(layouts)
    B, C, _, hw = walk.shape
    D = tog.shape[2]
    tog = tog.reshape(B, C * D).long()
    h, w = layouts.base_walk.shape[1:]
    slab, S = 4 * hw, C * 4 * hw
    tb, tg, cell, G = _vi_plan(B, hw, C)
    T = len(tb)
    d = torch.arange(4)
    own = d * hw + cell[:, None]  # (T, 4)
    fwd = own + torch.tensor(_STEP(w))
    f = flags[tb[:, None], d, cell[:, None]]
    goal, key = (f & 1) != 0, (f & 4) != 0
    walk_bits = walk[tb].permute(0, 2, 3, 1)[torch.arange(T)[:, None], d, cell[:, None]]
    walk_bits = walk_bits.bool() & ((f & 2) == 0)[..., None]  # (T, 4, C), lava folded in
    sl = slot[tb[:, None], d, cell[:, None]].long()
    cur = torch.zeros(B, S)
    left, right = (d + 3) % 4, (d + 1) % 4
    rounds = -(-(C // 2) // G)
    row = tb[:, None]
    for _ in range(n_sweeps):
        nxt = torch.full((B, S), float("nan"))
        for r in range(rounds):
            c = 2 * (tg + r * G)  # (T,): each thread's config of this round
            ok = (c < C)[:, None]
            c = c.clamp(max=C - 2)[:, None]
            a = cur[row, c * slab + own]
            e = cur[row, (c + 1) * slab + own]
            wb = walk_bits.gather(2, c[..., None].expand(T, 4, 1))[..., 0]
            wb1 = walk_bits.gather(2, (c + 1)[..., None].expand(T, 4, 1))[..., 0]
            q0 = torch.maximum(a, torch.maximum(a[:, left], a[:, right]))
            ahead = cur[row, (c * slab + fwd).clamp(0, S - 1)]
            q0 = torch.where(wb, torch.maximum(q0, ahead), q0)
            q0 = torch.where(key, torch.maximum(q0, e), q0)
            q1 = torch.maximum(e, torch.maximum(e[:, left], e[:, right]))
            ahead = cur[row, ((c + 1) * slab + fwd).clamp(0, S - 1)]
            q1 = torch.where(wb1, torch.maximum(q1, ahead), q1)
            if D:
                door = sl >= 0
                t0 = tog[row, c * D + sl.clamp(min=0)]
                t1 = tog[row, (c + 1) * D + sl.clamp(min=0)]
                q0 = torch.where(door, torch.maximum(q0, cur[row, t0 * slab + own]), q0)
                q1 = torch.where(door, torch.maximum(q1, cur[row, t1 * slab + own]), q1)
            for ci, q in ((c, q0), (c + 1, q1)):
                idx = torch.where(ok, ci * slab + own, -1)
                keep = idx >= 0
                nxt[row.expand_as(idx)[keep], idx[keep]] = torch.where(goal, 1.0, gamma * q)[keep]
        cur = nxt
    return cur.reshape(B, C, 4, h, w)


def _check_vi_plan_writes_every_state_once(b, hw, C):
    tb, g, cell, G = _vi_plan(b, hw, C)
    assert len(tb) == b * G * hw and (C // 2) % G == 0
    assert len(torch.unique((tb * G + g) * hw + cell)) == len(tb)
    pairs = torch.arange(C // 2 // G)[:, None] * G + g[None]  # (rounds, T)
    cfg = torch.stack([2 * pairs, 2 * pairs + 1])[:, :, :, None]  # (2, rounds, T, 1)
    own = cfg * 4 * hw + torch.arange(4) * hw + cell[None, None, :, None]
    writes = tb[None, None, :, None] * C * 4 * hw + own
    assert torch.equal(torch.sort(writes.reshape(-1)).values, torch.arange(b * C * 4 * hw))
    lpb = cuda_vi.vi_plan(C, _doors(C), hw)[0]
    assert lpb * G * hw <= cuda_vi.VI_MAX_THREADS
    assert cuda_vi.vi_shared_bytes(C, _doors(C), hw, lpb) <= cuda_vi.SMEM_PER_BLOCK


@pytest.mark.parametrize("b,hw", [(37, 25), (10, 36), (9, 64), (3, 256)])
@pytest.mark.parametrize("C", [2, 6, 18])
def test_vi_plan_writes_every_state_once(b, hw, C):
    """Each (layout, group, cell) has one thread; a thread writes all four
    directions of its cell in its group's configs, so every state is
    written once per sweep."""
    _check_vi_plan_writes_every_state_once(b, hw, C)


@pytest.mark.parametrize("b,hw,C", [(37, 25, 54), (9, 64, 54), (5, 25, 162), (4, 36, 162)])
def test_vi_plan_many_doors_writes_every_state_once(b, hw, C):
    """Three door slots (a 64-bit walk mask) and four (walkability bytes in
    shared memory, one layout a block where two would not fit)."""
    _check_vi_plan_writes_every_state_once(b, hw, C)
    assert cuda_vi.vi_walk_bits(C) == (64 if C == 54 else 0)


@pytest.mark.parametrize("max_doors", [1, 2, 3, 4])
def test_vi_kernel_contract_reproduces_plain(max_doors):
    """DoorKey-8x8 up to three door slots (C = 54); four (C = 162) on
    DoorKey-5x5, since at 8x8 that V does not fit a block."""
    env_id = "MiniGrid-DoorKey-8x8-v0" if max_doors < 4 else "MiniGrid-DoorKey-5x5-v0"
    _, tstates = _states(env_id, 5, seed=3)
    layouts = ttab.extract_layout(tstates, max_doors)
    want = ttab.value_iteration(layouts, GAMMA, 48)[0]
    assert (want > 0).any()
    torch.testing.assert_close(_run_vi_plan(layouts, GAMMA, 48), want, rtol=0, atol=0)


def _key_vi_plan(h: int, w: int, C: int, n: int):
    """``key_vi_cluster_kernel``'s items: one row of (rank, group g, local
    row j, config c) per item, as the kernel's loops visit them.  The rows
    other than CARRIED come first, walked by the ``j -= ngen`` loop; then
    the CARRIED row (the last CTA's last), whose configs G - 1 - g,
    2G - 1 - g, ... group g takes.  Every cell of a group takes the same
    items."""
    hw = h * w
    G = cuda_vi.key_vi_groups(hw)
    rows = cuda_vi.key_vi_rows(hw + 1, n)
    items = []
    for rank, (_, nrows) in enumerate(rows):
        ngen = nrows - (rank == n - 1)
        for g in range(G):
            j = g
            for c in range(C):
                while j < ngen:
                    items.append((rank, g, j, c))
                    j += G
                j -= ngen
            if rank == n - 1:
                items += [(rank, g, ngen, c) for c in range(G - 1 - g, C, G)]
    return torch.tensor(items)


def _key_vi_reads(h: int, w: int, C: int, n: int, items):
    """Where each candidate's read lands, per (item, cell, direction), as
    the kernel computes it: (rank, offset into that CTA's V buffer) for the
    item's own state, forward, pickup (the CARRIED row) and drop (row
    `front`)."""
    hw, K = h * w, h * w + 1
    slab, kslab = 4 * hw, C * 4 * hw
    rows = cuda_vi.key_vi_rows(K, n)
    starts = torch.tensor([r0 for r0, _ in rows] + [K])
    cell = torch.arange(hw)
    x, y = cell % w, cell // w
    fx = torch.stack([x + 1, x, x - 1, x], 1)
    fy = torch.stack([y, y + 1, y, y - 1], 1)
    fr = torch.where((fx >= 0) & (fx < w) & (fy >= 0) & (fy < h), fy * w + fx, -1)  # (HW, 4)
    d = torch.arange(4)
    rank, j, c = items[:, 0, None, None], items[:, 2, None, None], items[:, 3, None, None]
    own = j * kslab + c * slab + d * hw + cell[:, None]  # (I, HW, 4)
    in_row = c * slab + d * hw + cell[:, None]
    # Row fr's owner, as row_owner computes it, and its local row.
    q, rem = divmod(K, n)
    safe = fr.clamp(min=0)
    owner = torch.where(safe < rem * (q + 1), safe // (q + 1), rem + (safe - rem * (q + 1)) // max(q, 1))
    return {
        "k": starts[rank] + j,
        "fr": fr,
        "own": (rank.expand_as(own), own),
        "forward": (rank.expand_as(own), own + torch.tensor(_STEP(w))),
        "pickup": (torch.full_like(own, n - 1), (hw - starts[n - 1]) * kslab + in_row.expand_as(own)),
        "drop": (owner.expand_as(own), (safe - starts[owner]) * kslab + in_row.expand_as(own)),
    }


@pytest.mark.parametrize("h,w,C,n", [
    (5, 5, 2, 1), (6, 6, 2, 1), (6, 6, 2, 2), (8, 8, 2, 2), (8, 8, 4, 4), (8, 8, 2, 8),
])
def test_key_vi_plan_writes_every_state_once(h, w, C, n):
    hw = h * w
    K = hw + 1
    kslab = C * 4 * hw
    rows = cuda_vi.key_vi_rows(K, n)
    assert [r0 for r0, _ in rows] == sorted(r0 for r0, _ in rows) and sum(r for _, r in rows) == K
    items = _key_vi_plan(h, w, C, n)
    r = _key_vi_reads(h, w, C, n, items)
    rank, own = r["own"]
    # Global state index of each write: row k, then (c, d, cell) within it.
    state = r["k"] * kslab + own - items[:, 2, None, None] * kslab
    assert torch.equal(torch.sort(state.reshape(-1)).values, torch.arange(K * kslab))
    nrows = torch.tensor([nr for _, nr in rows])
    starts = torch.tensor([r0 for r0, _ in rows])
    fr, k = r["fr"], r["k"]
    carried = (k == hw).expand(-1, hw, 4)
    # Stay, left, right and forward stay in the item's own CTA, within its
    # rows; forward is taken only where the front cell is on the grid.
    assert torch.equal(r["forward"][0], rank)
    for name in ("own", "forward"):
        rk, off = r[name]
        valid = (fr >= 0).expand_as(off)
        assert (off[valid] >= 0).all() and (off[valid] < nrows[rk[valid]] * kslab).all(), name
    # Pickup reads the CARRIED row on the last CTA, for the rows k == front.
    rk, off = r["pickup"]
    assert (rk == n - 1).all() and (starts[n - 1] + off // kslab == hw).all()
    # Drop, from the CARRIED row (on the last CTA), reads row `front` where
    # that row lives.
    assert (rank[carried] == n - 1).all()
    rk, off = r["drop"]
    valid = (fr >= 0).expand_as(rk)
    assert (off[valid] < nrows[rk[valid]] * kslab).all()
    assert torch.equal((starts[rk] + off // kslab)[valid], fr.expand_as(rk)[valid])
    assert cuda_vi.key_vi_cluster_shared_bytes(C, hw, n) <= cuda_vi.SMEM_PER_BLOCK


def _run_key_vi_plan(layouts, gamma: float, n_sweeps: int, n: int) -> torch.Tensor:
    """``key_vi_cluster_kernel``'s arithmetic over the plan: V split over n
    CTAs' buffers (B, n, rows * K slab), every item of every thread at
    once, reads and writes at the plan's (rank, offset).  Rows other than
    CARRIED take stay, turns, forward and pickup, then the closed-door
    toggle pass; the CARRIED row takes its own loop."""
    cell_flags, cfg_flags, door_bit = cuda_vi.key_vi_masks(layouts)
    B, C, _, hw = cfg_flags.shape
    h, w = layouts.base_walk.shape[1:]
    K, CARRIED, slab, kslab = hw + 1, hw, 4 * hw, C * 4 * hw
    items = _key_vi_plan(h, w, C, n)
    r = _key_vi_reads(h, w, C, n, items)
    size = -(-K // n) * kslab
    c = items[:, 3, None, None]
    d = torch.arange(4)
    cell = torch.arange(hw)[:, None]
    f = cell_flags[:, d, cell]  # (B, HW, 4)
    g = cfg_flags[:, :, d, cell][:, items[:, 3]]  # (B, I, HW, 4)
    bit = door_bit[:, d, cell].long()[:, None]  # (B, 1, HW, 4)
    k, fr = r["k"], r["fr"]
    carried = k == CARRIED
    key_front = k == fr
    walk = ((g & 1) != 0) & ((f & 2) == 0)[:, None]
    closed, unlock = (g & 2) != 0, (g & 4) != 0
    drop_ok = ((f & 8) != 0)[:, None] & (fr >= 0)
    goal = ((f & 1) != 0)[:, None]
    term = ((f & 5) != 0)[:, None]  # goal or target, in every row but CARRIED
    rank, own = r["own"]
    bi = torch.arange(B)[:, None, None, None]

    def read(v, where):
        rk, off = where
        return v[bi, rk, off.clamp(0, size - 1)]

    cur = torch.zeros(B, n, size)
    for _ in range(n_sweeps):
        vv = read(cur, r["own"])
        q = torch.maximum(vv, torch.maximum(vv[..., (d + 3) % 4], vv[..., (d + 1) % 4]))
        ahead = read(cur, r["forward"])
        toggled = read(cur, (rank, own + ((c | bit) - c) * slab))
        # Rows other than CARRIED.
        qg = torch.where(walk & ~key_front, torch.maximum(q, ahead), q)
        qg = torch.where(key_front, torch.maximum(qg, read(cur, r["pickup"])), qg)
        out = torch.where(term, 1.0, gamma * qg)
        out = torch.where(closed & ~term, torch.maximum(out, gamma * toggled), out)
        # The CARRIED row.
        qc = torch.where(walk, torch.maximum(q, ahead), q)
        qc = torch.where(closed | unlock, torch.maximum(qc, toggled), qc)
        qc = torch.where(drop_ok, torch.maximum(qc, read(cur, r["drop"])), qc)
        out = torch.where(carried, torch.where(goal, 1.0, gamma * qc), out)
        nxt = torch.full_like(cur, float("nan"))
        nxt[bi, rank, own] = out
        cur = nxt
    rows = [cur[:, i, : nr * kslab] for i, (_, nr) in enumerate(cuda_vi.key_vi_rows(K, n))]
    return torch.cat(rows, 1).reshape(B, K, C, 4, h, w)


def _closed_doors(layouts):
    """The same layouts with every door closed, not locked: the toggle then
    opens it from every key row."""
    return dataclasses.replace(layouts, door_init=torch.ones_like(layouts.door_init))


@pytest.mark.parametrize("env_id,n,closed", [
    ("MiniGrid-DoorKey-6x6-v0", 2, False),
    ("MiniGrid-DoorKey-8x8-v0", 2, False),
    ("MiniGrid-DoorKey-8x8-v0", 4, False),
    ("MiniGrid-DoorKey-8x8-v0", 2, True),
])
def test_key_vi_kernel_contract_reproduces_plain(env_id, n, closed):
    """K is odd (37, 65), so the split is uneven, and the CARRIED row and
    most drop targets lie on different CTAs."""
    _, tstates = _states(env_id, 2, seed=4)
    layouts = tkey.extract_key_layout(tstates, 1)
    if closed:
        layouts = _closed_doors(layouts)
    want = tkey.key_value_iteration(layouts, GAMMA, 40)[0]
    assert (want > 0).any()
    got = _run_key_vi_plan(layouts, GAMMA, 40, n)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w,D,want", [
    (5, 5, 1, ("cluster", 1)),
    (6, 6, 1, ("cluster", 2)),
    (8, 8, 1, ("cluster", 4)),
    (8, 8, 2, ("cluster", 8)),
    (16, 16, 1, ("wide", 16)),
    (16, 16, 2, ("grid", 20, "resident")),
    (6, 11, 1, ("cluster", 4)),
    (5, 7, 6, ("wide", 16)),
    (7, 7, 7, ("grid", 25, "resident")),
    (19, 19, 1, ("grid", 20, "resident")),
    (8, 8, 7, ("grid", 65, "resident")),
    (16, 16, 7, ("grid", 128, "streamed")),
    (19, 19, 6, ("grid", 128, "streamed")),
])
def test_key_vi_route(h, w, D, want):
    """The smallest cluster whose CTAs fit three to an SM; where a cluster
    of 8 cannot hold V, a cluster of 16 (DoorKey-16x16 in place,
    KeyCorridorS3R2 at six door slots double-buffered); else the grid
    route: resident, the fewest CTAs that hold the K key rows in place
    (DoorKey-16x16 at two door slots: 4.2 MB, KeyCorridorS3R3 at seven: 5.0
    MB, 19x19: 4.2 MB, DoorKey-8x8 at seven, the default max_doors: 8.5 MB,
    one row a CTA), where a row fits a CTA; else streamed, a layout over
    128 CTAs (a 16x16 grid at seven door slots: 524 KB a row; LockedRoom,
    19x19 at six: 370 KB)."""
    hw = h * w
    C = 1 << D
    K = hw + 1
    assert cuda_vi.key_vi_route(K, C, hw) == want[:2]
    route, n = want[:2]
    if route == "grid":
        assert cuda_vi.key_vi_cluster_shared_bytes(C, hw, 8) > cuda_vi.SMEM_PER_BLOCK
        assert cuda_vi.key_vi_wide_shared_bytes(C, hw, 16, True) > cuda_vi.SMEM_PER_BLOCK
        resident = want[2] == "resident"
        assert cuda_vi.key_vi_grid_resident(K, C, hw) == resident
        rows = cuda_vi.key_vi_grid_rows(C, hw)
        if not resident:
            assert n == cuda_vi.KEY_GRID_MAX_CTAS and cuda_vi.key_vi_grid_shared_bytes(C, hw, n, False) == 0
            assert rows == 0
            return
        # The fewest CTAs: each holds ceil(K / n) <= rows rows, n - 1 could not.
        assert -(-K // n) <= rows < -(-K // (n - 1))
        assert cuda_vi.key_vi_grid_shared_bytes(C, hw, n, True) <= cuda_vi.SMEM_PER_BLOCK
        assert cuda_vi.key_vi_grid_threads(hw) == cuda_vi.KEY_GRID_THREADS // hw * hw
        # In place keeps more layouts a wave (of the 132 SMs) than a double
        # buffer, which holds half the rows a CTA, would.
        double = (cuda_vi.SMEM_PER_BLOCK - C * hw * 4) // (2 * C * 4 * hw * 4)
        assert double == 0 or 132 // -(-K // double) < 132 // n
        return
    if route == "cluster":
        smem = cuda_vi.key_vi_cluster_shared_bytes(C, hw, n)
        assert cuda_vi.SMEM_PER_SM // (smem + 1024) >= cuda_vi.KEY_CTAS_PER_SM
        if n > 1:
            smaller = cuda_vi.key_vi_cluster_shared_bytes(C, hw, n // 2)
            assert cuda_vi.SMEM_PER_SM // (smaller + 1024) < cuda_vi.KEY_CTAS_PER_SM
        return
    assert route == "wide"
    assert cuda_vi.key_vi_cluster_shared_bytes(C, hw, 8) > cuda_vi.SMEM_PER_BLOCK
    assert cuda_vi.key_vi_wide_shared_bytes(C, hw, 16, True) <= cuda_vi.SMEM_PER_BLOCK
    assert cuda_vi.key_vi_wide_in_place(C, hw) == (hw == 256)
    assert cuda_vi.key_vi_wide_groups(hw) * hw <= cuda_vi.KEY_WIDE_THREADS


# --- The wide route: a cluster of 16, in place where V does not fit twice ----


def _key_vi_wide_plan(h: int, w: int, C: int, n: int, reverse: bool = False):
    """``key_vi_wide_kernel``'s walk: (rank, round, group g, local row j,
    config c) of each item other than CARRIED, on the first n - 1 CTAs,
    from the group's first item g and the stride G = dc * ngen + dj, as
    the kernel steps them; then (group, first config) of the hub's items,
    config pairs 2g, 2g + 2G, ...  ``reverse`` walks each CTA's items in
    the opposite order (not the kernel's: the test of the order uses it);
    and G."""
    hw = h * w
    G = cuda_vi.key_vi_wide_groups(hw)
    items = []
    for rank, (_, ngen) in enumerate(cuda_vi.key_vi_rows(hw, n - 1)):
        rounds = -(-ngen * C // G)
        dc, dj = divmod(G, ngen)
        for g in range(G):
            c, j = divmod(g, ngen)
            for r in range(rounds):
                if c < C:
                    if reverse:
                        c_, j_ = divmod(ngen * C - 1 - (c * ngen + j), ngen)
                        items.append((rank, r, g, j_, c_))
                    else:
                        items.append((rank, r, g, j, c))
                j, c = j + dj, c + dc
                if j >= ngen:
                    j, c = j - ngen, c + 1
    hub = [(g, c) for g in range(G) for c in range(2 * g, C, 2 * G)]
    return torch.tensor(items), torch.tensor(hub), G


def _wide_front_rows(h: int, w: int):
    """(HW, 4) front cell per (cell, direction), -1 off the grid."""
    cell = torch.arange(h * w)
    x, y = cell % w, cell // w
    fx = torch.stack([x + 1, x, x - 1, x], 1)
    fy = torch.stack([y, y + 1, y, y - 1], 1)
    return torch.where((fx >= 0) & (fx < w) & (fy >= 0) & (fy < h), fy * w + fx, -1)


@pytest.mark.parametrize("h,w,C", [(16, 16, 2), (16, 16, 4), (5, 7, 64), (8, 8, 16), (5, 7, 1)])
def test_key_vi_wide_plan_writes_every_state_once(h, w, C):
    """Each state other than CARRIED's is one (rank, group, cell) thread's
    item once per sweep, on the first 15 CTAs; every group has at most the
    CTA's rounds of items and takes one in each of its rounds; the hub's
    groups split the CARRIED row's configs, two at a time."""
    n = cuda_vi.KEY_WIDE_CLUSTER
    hw = h * w
    items, hub, G = _key_vi_wide_plan(h, w, C, n)
    rows = cuda_vi.key_vi_rows(hw, n - 1)
    assert sum(nr for _, nr in rows) == hw and max(nr for _, nr in rows) - min(nr for _, nr in rows) <= 1
    starts = torch.tensor([r0 for r0, _ in rows])
    k = starts[items[:, 0]] + items[:, 3]
    kc = torch.sort(k * C + items[:, 4]).values
    assert torch.equal(kc, torch.arange(hw * C))
    hub_cfg = torch.cat([hub[:, 1], hub[hub[:, 1] + 1 < C, 1] + 1])
    assert torch.equal(torch.sort(hub_cfg).values, torch.arange(C))
    # Items of one (rank, round) belong to distinct groups, and a group's
    # items are in rounds 0, 1, ... with no gap.
    key = (items[:, 0] * 10_000 + items[:, 1]) * G + items[:, 2]
    assert len(torch.unique(key)) == len(items)
    for rank in range(n - 1):
        mine = items[items[:, 0] == rank]
        per_round = torch.bincount(mine[:, 1])
        assert (per_round[:-1] == G).all() and per_round[-1] <= G
    assert G * hw <= cuda_vi.KEY_WIDE_THREADS


def _run_key_vi_wide_plan(layouts, gamma: float, n_sweeps: int, in_place=None,
                          reverse: bool = False) -> torch.Tensor:
    """``key_vi_wide_kernel``'s arithmetic over its plan, on one image of
    each CTA's shared memory, (B, n, floats): its V row slots (once in
    place, else twice), then its two pickup tables.  Each sweep runs the
    hub's CARRIED items, then the other CTAs' items round by round, every
    item of a round at once (reads, then writes), with the stores the
    kernel sends to other CTAs: each new CARRIED value to the pickup table
    of the CTA that owns row front(cell, d), and each new value a drop
    reads to the hub's drop table.  Every read is checked against the
    values written in the sweep so far, so no read may see one; and, since
    the hub and the other CTAs do not wait for each other within a sweep,
    no state read in a sweep may be written in it, but for a CTA's own rows
    in place, which its round barriers order.  Every state is written once
    a sweep, as is every table entry that is read.  ``in_place`` defaults
    to the route's choice."""
    cell_flags, cfg_flags, door_bit = cuda_vi.key_vi_masks(layouts)
    B, C, _, hw = cfg_flags.shape
    h, w = layouts.base_walk.shape[1:]
    n = cuda_vi.KEY_WIDE_CLUSTER
    m = n - 1
    if in_place is None:
        in_place = cuda_vi.key_vi_wide_in_place(C, hw, n)
    K, slab, kslab = hw + 1, 4 * hw, C * 4 * hw
    rows = cuda_vi.key_vi_rows(hw, m)
    starts = torch.tensor([r0 for r0, _ in rows] + [hw])
    ngen = torch.tensor([nr for _, nr in rows] + [0])
    mrows = -(-hw // m)
    slots = cuda_vi.key_vi_wide_slots(hw, n, in_place)
    ptab = mrows * 4 * C
    P0 = (1 if in_place else 2) * slots * kslab  # the pickup tables
    size = P0 + 2 * ptab
    assert size * 4 + C * hw * 4 == cuda_vi.key_vi_wide_shared_bytes(C, hw, n, in_place)
    items, hub, G = _key_vi_wide_plan(h, w, C, n, reverse)
    fr = _wide_front_rows(h, w)  # (HW, 4)
    safe = fr.clamp(min=0)
    q_, rem = divmod(hw, m)
    owner = torch.where(safe < rem * (q_ + 1), safe // (q_ + 1), rem + (safe - rem * (q_ + 1)) // q_)
    d = torch.arange(4)
    cell = torch.arange(hw)[:, None]
    step = torch.tensor(_STEP(w))
    f = cell_flags[:, d, cell].long()  # (B, HW, 4)
    bit = door_bit[:, d, cell].long()[:, None]  # (B, 1, HW, 4)
    lava = ((f & 2) != 0)[:, None]
    goal, term = ((f & 1) != 0)[:, None], ((f & 5) != 0)[:, None]
    drop_ok = ((f & 8) != 0)[:, None] & (fr >= 0)
    on_grid = (fr >= 0).expand(B, 1, hw, 4)
    own_rows = torch.zeros(n, size, dtype=torch.bool)  # a CTA's own rows, in place
    if in_place:
        for rank in range(m):
            own_rows[rank, : int(ngen[rank]) * kslab] = True
    mem = torch.zeros(B, n, size)

    def flags(c):  # (B, I, HW, 4) walk, closed, unlock for each item's config
        g = cfg_flags[:, :, d, cell][:, c].long()
        return ((g & 1) != 0) & ~lava, (g & 2) != 0, (g & 4) != 0

    def sweep_once(sweep: int, odd: int):
        stamp = torch.zeros(B, n, size, dtype=torch.bool)  # written in this sweep
        seen = torch.zeros(B, n, size, dtype=torch.bool)  # read in this sweep
        count = torch.zeros(B, n, size, dtype=torch.int64)

        def index(rank, off, where):
            rank, off = torch.broadcast_tensors(rank, off)
            rank, off = rank.expand_as(where), off.expand_as(where)
            assert (off[where] >= 0).all() and (off[where] < size).all()
            b = torch.arange(B).reshape(-1, *[1] * (where.dim() - 1)).expand_as(where)
            return b, rank, off.clamp(0, size - 1)

        def read(rank, off, where):
            b, rank, off = index(rank, off, where)
            hit = where & stamp[b, rank, off]
            assert not hit.any(), f"sweep {sweep}: a read sees a value written in this sweep"
            seen[b[where], rank[where], off[where]] = True
            return mem[b, rank, off]

        def write(rank, off, val, where):
            b, rank, off = index(rank, off, where)
            return b[where], rank[where], off[where], val.expand_as(where)[where]

        def apply(writes):
            for b, rank, off, val in writes:
                mem[b, rank, off] = val
                stamp[b, rank, off] = True
                count[b, rank, off] += 1

        cur = 0
        nxt = 0 if in_place else slots * kslab
        if odd and not in_place:
            cur, nxt = nxt, cur
        car_cur = odd * kslab if in_place else cur
        car_nxt = (1 - odd) * kslab if in_place else nxt
        dt_cur = (2 + odd) * kslab if in_place else cur + kslab
        dt_nxt = (3 - odd) * kslab if in_place else nxt + kslab
        pick_cur, pick_nxt = P0 + odd * ptab, P0 + (1 - odd) * ptab
        hub_rank = torch.tensor(m)
        # The hub: the CARRIED row's items, both configs of each pair.
        pairs = torch.cat([hub[:, 1], hub[hub[:, 1] + 1 < C, 1] + 1])
        c = pairs[:, None, None]
        walk, closed, unlock = flags(pairs)
        base = car_cur + c * slab + d * hw + cell
        every = torch.ones(B, len(pairs), hw, 4, dtype=torch.bool)
        vv = read(hub_rank, base, every)
        q = torch.maximum(vv, torch.maximum(vv[..., (d + 3) % 4], vv[..., (d + 1) % 4]))
        q = torch.where(walk, torch.maximum(q, read(hub_rank, base + step, walk)), q)
        tog = closed | unlock
        q = torch.where(tog, torch.maximum(q, read(hub_rank, base + ((c | bit) - c) * slab, tog)), q)
        dk = drop_ok.expand_as(every)
        q = torch.where(dk, torch.maximum(q, read(hub_rank, dt_cur + c * slab + d * hw + cell, dk)), q)
        out = torch.where(goal, 1.0, gamma * q)
        j_fr = safe - starts[owner]
        sends = [write(hub_rank, car_nxt + c * slab + d * hw + cell, out, every),
                 write(owner, pick_nxt + (j_fr * 4 + d) * C + c, out, on_grid.expand_as(every))]
        # The other CTAs, round by round: all reads of a round, then its
        # writes; the hub's stores land in between.
        for r in range(int(items[:, 1].max()) + 1):
            it = items[items[:, 1] == r]
            rank = it[:, 0, None, None]
            j, c = it[:, 3, None, None], it[:, 4, None, None]
            walk, closed, _ = flags(it[:, 4])
            row0 = starts[rank]
            fj = torch.where((fr >= row0) & (fr < row0 + ngen[rank]), fr - row0, -1)
            every = torch.ones(B, len(it), hw, 4, dtype=torch.bool)
            kf = (j == fj).expand_as(every)
            base = cur + j * kslab + c * slab + d * hw + cell
            vv = read(rank, base, every)
            q = torch.maximum(vv, torch.maximum(vv[..., (d + 3) % 4], vv[..., (d + 1) % 4]))
            pick = read(rank, pick_cur + (j * 4 + d) * C + c, kf)
            fwd = walk & ~kf
            ahead = read(rank, base + step, fwd)
            q = torch.where(kf, torch.maximum(q, pick), torch.where(fwd, torch.maximum(q, ahead), q))
            q = torch.where(closed, torch.maximum(q, read(rank, base + ((c | bit) - c) * slab, closed)), q)
            out = torch.where(term, 1.0, gamma * q)
            if r == 0:
                apply(sends)
            apply([write(rank, nxt + j * kslab + c * slab + d * hw + cell, out, every),
                   write(hub_rank, dt_nxt + c * slab + d * hw + cell, out, kf & drop_ok)])
        # Each state written once (the rows' K * C * 4 * HW), and each
        # pickup and drop entry once.
        v_writes = count.clone()
        v_writes[:, :, P0:] = 0
        v_writes[:, m, dt_nxt: dt_nxt + kslab] = 0
        assert (v_writes.sum(dim=(1, 2)) == K * kslab).all() and int(count.max()) == 1
        assert (count[:, m, dt_nxt: dt_nxt + kslab].reshape(B, C, 4, hw).sum(1)
                == C * drop_ok[:, 0].transpose(1, 2)).all()
        if not (seen & stamp & ~own_rows).any():
            return
        raise AssertionError(f"sweep {sweep}: a state read in this sweep is written in it")

    for sweep in range(n_sweeps):
        sweep_once(sweep, sweep & 1)
    odd = n_sweeps & 1
    fin = slots * kslab if odd and not in_place else 0
    car_fin = odd * kslab if in_place else fin
    out = [mem[:, rank, fin: fin + int(ngen[rank]) * kslab] for rank in range(m)]
    out.append(mem[:, m, car_fin: car_fin + kslab])
    return torch.cat(out, 1).reshape(B, K, C, 4, h, w)


def _wide_layouts(env_id: str, max_doors: int, closed: bool):
    """Two layouts from the port's own generator (the target from aux slots
    0-1 where the family names one)."""
    import minigrid_dynamicprogramming_tpu_torch as port

    env = port.make(env_id)
    states = env.generate(torch.Generator().manual_seed(11), env.params, 2, "cpu")
    if "KeyCorridor" in env_id:
        layouts = tkey.extract_key_layout(states, max_doors, states.aux[:, 0], states.aux[:, 1])
    else:
        layouts = tkey.extract_key_layout(states, max_doors)
    return _closed_doors(layouts) if closed else layouts


@pytest.mark.parametrize("env_id,max_doors,closed,in_place", [
    ("MiniGrid-DoorKey-16x16-v0", 1, False, None),
    ("MiniGrid-DoorKey-16x16-v0", 1, True, None),
    ("MiniGrid-KeyCorridorS3R2-v0", 6, False, None),
    ("MiniGrid-KeyCorridorS3R2-v0", 6, False, True),
])
def test_key_vi_wide_kernel_contract_reproduces_plain(env_id, max_doors, closed, in_place):
    """DoorKey-16x16 swept in place (closed doors make every key row
    toggle, so the order of the configs matters), KeyCorridorS3R2 at six
    door slots double-buffered as the route runs it, and in place as a
    second check of the order at 64 configs."""
    layouts = _wide_layouts(env_id, max_doors, closed)
    hw = layouts.base_walk.shape[1] * layouts.base_walk.shape[2]
    assert cuda_vi.key_vi_route(hw + 1, 1 << max_doors, hw) == ("wide", 16)
    sweeps = 24
    want = tkey.key_value_iteration(layouts, GAMMA, sweeps)[0]
    assert (want > 0).any()
    got = _run_key_vi_wide_plan(layouts, GAMMA, sweeps, in_place)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_key_vi_wide_in_place_order_matters():
    """The mirror's check catches an order that is not exact: walking the
    items from the last config down, a closed door's toggle reads a slab
    the sweep has already overwritten."""
    layouts = _wide_layouts("MiniGrid-DoorKey-16x16-v0", 1, True)
    with pytest.raises(AssertionError, match="written in this sweep"):
        _run_key_vi_wide_plan(layouts, GAMMA, 4, True, reverse=True)


# --- The grid route: groups of CTAs that meet through device memory ----------


def _key_vi_grid_plan(hw: int, C: int, n: int, reverse: bool = False):
    """``key_vi_grid_resident_kernel``'s walk: (rank, round, group g, local
    row j, config c) of each item of each of the n CTAs, the CARRIED row
    (the last CTA's last) among them, from the group's first item g and the
    stride G = dc * nrows + dj, as the kernel steps them.  ``reverse`` walks
    each CTA's items in the opposite order (not the kernel's: the test of
    the order uses it).  Also G."""
    G = cuda_vi.key_vi_grid_threads(hw) // hw
    items = []
    for rank, (_, nrows) in enumerate(cuda_vi.key_vi_rows(hw + 1, n)):
        rounds = -(-nrows * C // G)
        dc, dj = divmod(G, nrows)
        for g in range(G):
            c, j = divmod(g, nrows)
            for r in range(rounds):
                if c < C:
                    if reverse:
                        c_, j_ = divmod(nrows * C - 1 - (c * nrows + j), nrows)
                        items.append((rank, r, g, j_, c_))
                    else:
                        items.append((rank, r, g, j, c))
                j, c = j + dj, c + dc
                if j >= nrows:
                    j, c = j - nrows, c + 1
    return torch.tensor(items), G


def _key_vi_grid_stream_plan(hw: int, C: int, n: int):
    """``key_vi_grid_streamed_kernel``'s walk: (rank, group g, k, c) of each
    slab, a CTA's slabs k * C + c split over its groups, from the group's
    first slab and the stride G = dk * C + dc, as the kernel steps them.
    Also G."""
    T = min(hw, cuda_vi.KEY_GRID_THREADS)
    G = cuda_vi.key_vi_grid_threads(hw) // T
    dk, dc = divmod(G, C)
    slabs = []
    for rank, (s0, ns) in enumerate(cuda_vi.key_vi_rows((hw + 1) * C, n)):
        for g in range(G):
            k, c = divmod(s0 + g, C)
            for _ in range(g, ns, G):
                slabs.append((rank, g, k, c))
                k, c = k + dk, c + dc
                if c >= C:
                    k, c = k + 1, c - C
    return torch.tensor(slabs), G


@pytest.mark.parametrize("h,w,D", [(16, 16, 2), (7, 7, 7), (8, 8, 7), (19, 19, 1)])
def test_key_vi_grid_plan_writes_every_state_once(h, w, D):
    """Resident: each (key row, config) is one (rank, group) item once a
    sweep, the CARRIED row's on the last CTA; a group takes one item in
    each of its CTA's rounds, with no gap."""
    hw, C = h * w, 1 << D
    K = hw + 1
    n = cuda_vi.key_vi_grid_ctas(K, C, hw)
    assert cuda_vi.key_vi_grid_resident(K, C, hw)
    items, G = _key_vi_grid_plan(hw, C, n)
    rows = cuda_vi.key_vi_rows(K, n)
    assert max(nr for _, nr in rows) <= min(cuda_vi.key_vi_grid_rows(C, hw), cuda_vi.KEY_GRID_ROWS)
    starts = torch.tensor([r0 for r0, _ in rows])
    k = starts[items[:, 0]] + items[:, 3]
    assert torch.equal(torch.sort(k * C + items[:, 4]).values, torch.arange(K * C))
    assert set(k[items[:, 0] == n - 1].tolist()) >= {hw}
    key = (items[:, 0] * 10_000 + items[:, 1]) * G + items[:, 2]
    assert len(torch.unique(key)) == len(items)
    for rank in range(n):
        per_round = torch.bincount(items[items[:, 0] == rank][:, 1])
        assert (per_round[:-1] == G).all() and per_round[-1] <= G
    assert G * hw <= cuda_vi.KEY_GRID_THREADS


@pytest.mark.parametrize("h,w,D", [(16, 16, 7), (19, 19, 6), (8, 8, 2)])
def test_key_vi_grid_stream_plan_writes_every_slab_once(h, w, D):
    """Streamed: each (key row, config) slab is one (rank, group)'s once a
    sweep; the groups of a CTA split its slabs within one."""
    hw, C = h * w, 1 << D
    K = hw + 1
    n = min(K * C, cuda_vi.KEY_GRID_MAX_CTAS)
    slabs, G = _key_vi_grid_stream_plan(hw, C, n)
    assert torch.equal(torch.sort(slabs[:, 2] * C + slabs[:, 3]).values, torch.arange(K * C))
    for rank in range(n):
        per_group = torch.bincount(slabs[slabs[:, 0] == rank][:, 1], minlength=G)
        assert int(per_group.max() - per_group.min()) <= 1
    assert G * min(hw, cuda_vi.KEY_GRID_THREADS) == cuda_vi.key_vi_grid_threads(hw)


def _run_key_vi_grid_plan(layouts, gamma: float, n_sweeps: int, resident=None,
                          reverse: bool = False) -> torch.Tensor:
    """The grid kernels' arithmetic over their plans, for one group (B
    layouts, each as the group runs it), on an image of the memory they
    use.  ``resident`` defaults to the route's choice.

    Resident, (B, n + 1, floats): each CTA's rows of V (zeroed; in place),
    then, as rank n, the device memory of the group's pickup table twice
    and drop table twice (NaN until written).  Each sweep runs the CTAs'
    rounds in order, all items of a round at once (reads, then writes),
    the CARRIED row's items writing each new value to the pickup table and
    the other rows' items each value a drop reads to the drop table; the
    first sweep reads no table.  Every read is checked against the values
    written in the sweep so far, so no read may see one; and, since the
    CTAs meet only at the end of a sweep, no state read in a sweep may be
    written in it, but for a CTA's own rows in place, which its round
    barriers order.  Every state and every table entry read is written once
    a sweep.

    Streamed, (B, 2, floats): v_out and the scratch layout in device memory
    (NaN until written); each sweep reads one and writes the other, so
    that the last lands in v_out; all slabs of the plan at once, with the
    same checks; the first sweep reads nothing."""
    cell_flags, cfg_flags, door_bit = cuda_vi.key_vi_masks(layouts)
    B, C, _, hw = cfg_flags.shape
    h, w = layouts.base_walk.shape[1:]
    K, slab, kslab = hw + 1, 4 * hw, C * 4 * hw
    if resident is None:
        resident = cuda_vi.key_vi_grid_resident(K, C, hw)
    n = cuda_vi.key_vi_grid_ctas(K, C, hw) if resident else min(K * C, cuda_vi.KEY_GRID_MAX_CTAS)
    fr = _wide_front_rows(h, w)  # (HW, 4)
    d = torch.arange(4)
    cell = torch.arange(hw)[:, None]
    step = torch.tensor(_STEP(w))
    f = cell_flags[:, d, cell].long()  # (B, HW, 4)
    bit = door_bit[:, d, cell].long()[:, None]  # (B, 1, HW, 4)
    lava = ((f & 2) != 0)[:, None]
    goal, term = ((f & 1) != 0)[:, None], ((f & 5) != 0)[:, None]
    drop_ok = ((f & 8) != 0)[:, None] & (fr >= 0)

    def flags(c):  # (B, I, HW, 4) walk, closed, unlock for each item's config
        g = cfg_flags[:, :, d, cell][:, c].long()
        return ((g & 1) != 0) & ~lava, (g & 2) != 0, (g & 4) != 0

    if resident:
        rows = cuda_vi.key_vi_rows(K, n)
        starts = torch.tensor([r0 for r0, _ in rows])
        nrows = torch.tensor([nr for _, nr in rows])
        ngen = nrows - (starts + nrows == K).long()  # rows other than CARRIED
        mrows = -(-K // n)
        assert mrows * kslab * 4 + C * hw * 4 == cuda_vi.key_vi_grid_shared_bytes(C, hw, n, True)
        size = max(mrows, 4) * kslab
        items, _ = _key_vi_grid_plan(hw, C, n, reverse)
        rounds = int(items[:, 1].max()) + 1
        own_rows = torch.zeros(n + 1, size, dtype=torch.bool)
        for rank in range(n):
            own_rows[rank, : int(nrows[rank]) * kslab] = True
        mem = torch.full((B, n + 1, size), float("nan"))
        mem[:, :n][:, own_rows[:n]] = 0.0
    else:
        slabs, _ = _key_vi_grid_stream_plan(hw, C, n)
        size = K * kslab
        own_rows = torch.zeros(2, size, dtype=torch.bool)
        mem = torch.full((B, 2, size), float("nan"))
    tab = torch.tensor(n)  # the rank of the resident route's tables

    ranks = mem.shape[1]
    flat_mem = mem.view(-1)

    def sweep_once(sweep: int):
        stamp = torch.zeros(mem.shape, dtype=torch.bool)  # written in this sweep
        seen = torch.zeros(mem.shape, dtype=torch.bool)  # read in this sweep
        count = torch.zeros(mem.shape, dtype=torch.int64)
        first = sweep == 0

        def index(rank, off, where):
            """The flat index of (layout, rank, offset) in the image."""
            assert not (where & ((off < 0) | (off >= size))).any()
            b = torch.arange(B).reshape(-1, *[1] * (where.dim() - 1))
            return ((b * ranks + rank) * size + off.clamp(0, size - 1)).expand_as(where)

        def read(rank, off, where):
            assert not (first and where.any()), "the first sweep reads nothing but V = 0"
            at = index(rank, off, where)
            hit = where & stamp.view(-1)[at]
            assert not hit.any(), f"sweep {sweep}: a read sees a value written in this sweep"
            seen.view(-1)[at[where]] = True
            return flat_mem[at]

        def write(rank, off, val, where):
            return index(rank, off, where)[where], val.expand_as(where)[where]

        def apply(writes):
            for at, val in writes:
                flat_mem[at] = val
                stamp.view(-1)[at] = True
                count.view(-1).index_add_(0, at, torch.ones_like(at))

        def backup(rank, base, c, car, kf, pick_at, drop_at):
            """The new V of the items at ``base`` (config c): stay, turns,
            forward, and pickup (read at ``pick_at``) where the key lies in
            front (``kf``); toggle; for the CARRIED row (``car``) unlock and
            drop (read at ``drop_at``)."""
            walk, closed, unlock = flags(c[:, 0, 0])
            every = torch.ones(B, len(c), hw, 4, dtype=torch.bool)
            if first:
                return torch.where(car, goal, term).float().expand_as(every), every
            vv = read(rank, base, every)
            q = torch.maximum(vv, torch.maximum(vv[..., (d + 3) % 4], vv[..., (d + 1) % 4]))
            kf = kf.expand_as(every)
            fwd = walk & ~kf
            q = torch.where(fwd, torch.maximum(q, read(rank, base + step, fwd)), q)
            q = torch.where(kf, torch.maximum(q, read(*pick_at, kf)), q)
            tog = torch.where(car, closed | unlock, closed)
            q = torch.where(tog, torch.maximum(q, read(rank, base + ((c | bit) - c) * slab, tog)), q)
            dr = drop_ok & car
            q = torch.where(dr, torch.maximum(q, read(*drop_at, dr)), q)
            return torch.where(torch.where(car, goal, term), 1.0, gamma * q), every

        if resident:
            odd = sweep & 1
            pick_cur, pick_nxt = odd * kslab, (1 - odd) * kslab
            drop_cur, drop_nxt = (2 + odd) * kslab, (3 - odd) * kslab
            for r in range(rounds):
                it = items[items[:, 1] == r]
                rank = it[:, 0, None, None]
                j, c = it[:, 3, None, None], it[:, 4, None, None]
                row0 = starts[rank]
                car = row0 + j == hw
                fj = torch.where((fr >= row0) & (fr < row0 + ngen[rank]), fr - row0, -1)
                kf = j == fj
                base = j * kslab + c * slab + d * hw + cell
                at = c * slab + d * hw + cell
                out, every = backup(rank, base, c, car, kf, (tab, pick_cur + at), (tab, drop_cur + at))
                apply([write(rank, base, out, every),
                       write(tab, pick_nxt + at, out, car.expand_as(every)),
                       write(tab, drop_nxt + at, out, kf & drop_ok)])
            # Each state written once, and each pickup and drop entry.
            v_writes = count * own_rows
            assert (v_writes.sum(dim=(1, 2)) == K * kslab).all() and int(count.max()) == 1
            assert (count[:, n, pick_nxt: pick_nxt + kslab] == 1).all()
            assert (count[:, n, drop_nxt: drop_nxt + kslab].reshape(B, C, 4, hw).sum(1)
                    == C * drop_ok[:, 0].transpose(1, 2)).all()
        else:
            cur, nxt = torch.tensor((n_sweeps - sweep) & 1), torch.tensor((n_sweeps - 1 - sweep) & 1)
            k, c = slabs[:, 2, None, None], slabs[:, 3, None, None]
            car = k == hw
            kf = (k == fr) & (fr >= 0)
            base = k * kslab + c * slab + d * hw + cell
            at = c * slab + d * hw + cell
            out, every = backup(cur, base, c, car, kf,
                                (cur, hw * kslab + at), (cur, fr.clamp(min=0) * kslab + at))
            apply([write(nxt, base, out, every)])
            assert (count[:, int(nxt)] == 1).all() and int(count.max()) == 1
        if (seen & stamp & ~own_rows).any():
            raise AssertionError(f"sweep {sweep}: a state read in this sweep is written in it")

    for sweep in range(n_sweeps):
        sweep_once(sweep)
    if resident:
        out = [mem[:, rank, : int(nrows[rank]) * kslab] for rank in range(n)]
        return torch.cat(out, 1).reshape(B, K, C, 4, h, w)
    return mem[:, 0].reshape(B, K, C, 4, h, w)


def _grid_layouts(env_id: str, max_doors: int, closed: bool):
    """The first two layouts with at most ``max_doors`` doors from the port's
    own generator (the target from aux slots 0-1 where the family names
    one)."""
    import minigrid_dynamicprogramming_tpu_torch as port
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_DOOR

    env = port.make(env_id)
    states = env.generate(torch.Generator().manual_seed(11), env.params, 8, "cpu")
    keep = torch.nonzero((states.grid_obj == OBJ_DOOR).sum(dim=(1, 2)) <= max_doors)[:2, 0]
    assert len(keep) == 2
    states = EnvState(**{k: v[keep] for k, v in states.__dict__.items()})
    if "KeyCorridor" in env_id:
        layouts = tkey.extract_key_layout(states, max_doors, states.aux[:, 0], states.aux[:, 1])
    else:
        layouts = tkey.extract_key_layout(states, max_doors)
    return _closed_doors(layouts) if closed else layouts


@pytest.mark.parametrize("env_id,max_doors,closed,resident,sweeps", [
    ("MiniGrid-DoorKey-16x16-v0", 2, True, None, 24),
    ("MiniGrid-KeyCorridorS3R3-v0", 7, False, None, 12),
    ("MiniGrid-DoorKey-8x8-v0", 2, True, False, 24),
])
def test_key_vi_grid_kernel_contract_reproduces_plain(env_id, max_doors, closed, resident, sweeps):
    """Resident as the route runs it: DoorKey-16x16 at two door slots with
    closed doors (every key row toggles, so the configs' order within a
    sweep matters), and KeyCorridorS3R3 at seven (two rows a CTA, the
    pickup and drop tables carrying the key between CTAs).  Streamed, at a
    shape the route gives the cluster (DoorKey-8x8 at two door slots, 260
    slabs over 128 CTAs)."""
    layouts = _grid_layouts(env_id, max_doors, closed)
    hw = layouts.base_walk.shape[1] * layouts.base_walk.shape[2]
    if resident is None:
        assert cuda_vi.key_vi_route(hw + 1, 1 << max_doors, hw)[0] == "grid"
    want = tkey.key_value_iteration(layouts, GAMMA, sweeps)[0]
    assert (want > 0).any()
    got = _run_key_vi_grid_plan(layouts, GAMMA, sweeps, resident)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_key_vi_grid_in_place_order_matters():
    """The mirror's check catches an order that is not exact: walking the
    items from the last config down, a closed door's toggle reads a slab
    the sweep has already overwritten."""
    layouts = _grid_layouts("MiniGrid-DoorKey-16x16-v0", 2, True)
    with pytest.raises(AssertionError, match="written in this sweep"):
        _run_key_vi_grid_plan(layouts, GAMMA, 4, True, reverse=True)
