"""Hand-written CUDA kernels for batched value iteration, with their plain
versions.

* :func:`cuda_value_iteration` (``csrc/vi.cu``) replaces
  ``minigrid_dynamicprogramming_tpu/dp/pallas_vi.py:_vi_kernel`` (launched
  by ``pallas_value_iteration``).  Plain version: ``tabular.vi_values``,
  which is ``tabular.value_iteration``'s V.
* :func:`cuda_key_value_iteration` (``csrc/key_vi.cu``) replaces
  ``pallas_vi.py:_key_vi_kernel`` (launched by
  ``pallas_key_value_iteration``).  Plain version:
  ``tabular_key.key_vi_values``, ``key_value_iteration``'s V.  It has
  three routes, which :func:`key_vi_route` picks from the shape alone:
  ``cluster``, V split by key row over the shared memory of a thread-block
  cluster of up to 8 CTAs, three CTAs an SM (DoorKey up to 8x8 at one or
  two door slots, ObstructedMaze-1Dl); ``wide``, a cluster of 16 CTAs, one
  CTA an SM with up to 1024 threads: the rows other than CARRIED split
  over 15 of them, the CARRIED row alone on the last, which sends each CTA
  its pickup values and takes their drop values (remote stores only), V
  double-buffered where that fits (KeyCorridorS3R2 at six door slots) and
  else swept in place (DoorKey-16x16); ``grid``, where even one buffer of
  V is too large for 16 CTAs: a cooperative, persistent launch whose
  resident CTAs form groups of n, one group a layout at a time, with one
  barrier a sweep over the group through a counter in device memory;
  ``resident`` where a CTA holds at least one key row (the rows split over
  the group's shared memory, swept in place, pickups and drops through two
  small tables in device memory: DoorKey-16x16 at two door slots,
  KeyCorridorS3R3 at seven, DoorKey-8x8 at seven, the default
  ``max_doors`` of ``extract_key_layout``, 19x19 grids), else
  ``streamed`` (V double-buffered in device memory, each layout's (row,
  config) slabs split over the group: KeyCorridorS4R3 and larger at
  seven door slots, LockedRoom).

What bounds each kernel on an H100, and what its design does about it, is
noted at the top of its ``.cu`` file.  A wrapper checks its inputs, then
runs the plain version for tensors on the CPU and launches its kernel for
CUDA tensors (raising if the launch fails; there is no fallback, and no
other route is tried).  Each wrapper counts its launches in a counter of
``utils/profiling.py``, ``vi.launches`` and ``key_vi.launches``, so a run
can show that it went through the kernel; ``key_vi.launches.<route>``
splits the key-domain count by route.  ``cuda_key_value_iteration`` is
the span ``dp.vi``, holding ``dp.masks`` (:func:`key_vi_masks`) and
``dp.kernel`` (the launch, its ``route`` an attribute).  Like
``pallas_vi``, the wrappers return V only: the policy is one plain backup
over it.

Each kernel's launch plan (which thread owns which states, how many
layouts or key rows a block holds, its shared memory) is mirrored here in
Python from the constants of its ``.cu`` file, so the CPU tests can check
it; the on-card tests check the mirror against the C side.

The per-layout masks are packed here into bytes from the same per-direction
decode of the layout that the plain backups read (``tabular._front_tables``,
``tabular_key._front_tables``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch import _kernels
from minigrid_dynamicprogramming_tpu_torch.dp import tabular, tabular_key
from minigrid_dynamicprogramming_tpu_torch.dp.tabular import _DIRS, TabularLayout, _num_cfg
from minigrid_dynamicprogramming_tpu_torch.dp.tabular_key import KeyTabularLayout
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

__all__ = ["cuda_value_iteration", "cuda_key_value_iteration", "key_vi_route"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U8, _I32, _BOOL = torch.uint8, torch.int32, torch.bool


def _check_layouts(layouts, spec) -> torch.device:
    """Raise unless every field has its dtype and shape (``spec`` maps a
    field to its dtype and dims, with "B", "H", "W", "D" for the layout's
    sizes) and all lie on one device, the CPU or a card.  Returns it."""
    b, h, w = layouts.base_walk.shape
    sizes = {"B": b, "H": h, "W": w, "D": layouts.n_doors}
    dev = layouts.base_walk.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"value iteration runs on the CPU or a card, not {dev}")
    for name, (dtype, dims) in spec.items():
        t = getattr(layouts, name)
        shape = tuple(sizes.get(d, d) for d in dims)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return dev


def _check_run(gamma: float, n_sweeps: int) -> None:
    if not 0.0 < gamma <= 1.0 or n_sweeps < 0:
        raise ValueError(f"want 0 < gamma <= 1 and n_sweeps >= 0, got {gamma}, {n_sweeps}")


def _nbytes(record) -> int:
    return sum(t.numel() * t.element_size() for t in record.__dict__.values())


SMEM_PER_BLOCK = 232_448  # the 227 KB of shared memory a block may use (H100)
SMEM_PER_SM = 233_472  # an SM's 228 KB; each resident block also takes 1 KB of it


# --- B1: restricted domain ---------------------------------------------------

_LAYOUT_SPEC = {
    "base_walk": (_BOOL, ("B", "H", "W")),
    "goal": (_BOOL, ("B", "H", "W")),
    "lava": (_BOOL, ("B", "H", "W")),
    "door_pos": (_I32, ("B", "D", 2)),
    "door_id": (_I32, ("B", "H", "W")),
    "door_unlockable": (_BOOL, ("B", "D")),
    "key_pos": (_I32, ("B", 2)),
    "init_cfg": (_I32, ("B",)),
}


def vi_masks(layouts: TabularLayout):
    """The kernel's per-layout inputs, as bytes:

    * walk_front (B, C, 4, HW) u8: the front cell is walkable in config c;
    * cell_flags (B, 4, HW) u8: bit 0 goal, bit 1 lava, bit 2 key in front;
    * door_slot (B, 4, HW) i8: slot of the door in front, -1 if none;
    * toggle_cfg (B, C, D) i32: the config after toggling door slot k."""
    toggle_cfg, _, fronts = tabular._front_tables(layouts)
    b, C, h, w = fronts[0][0].shape
    walk_front, flags, slot = [], [], []
    for walk_n, goal_n, lava_n, key_front, front_did in fronts:
        walk_front.append(walk_n.reshape(b, C, h * w))
        f = goal_n.to(_U8) | lava_n.to(_U8) << 1 | key_front.to(_U8) << 2
        flags.append(f.reshape(b, h * w))
        slot.append(front_did.reshape(b, h * w))
    return (
        torch.stack(walk_front, dim=2).to(_U8).contiguous(),
        torch.stack(flags, dim=1).contiguous(),
        torch.stack(slot, dim=1).to(torch.int8).contiguous(),
        toggle_cfg.contiguous(),
    )


def vi_work(layouts: TabularLayout, n_sweeps: int) -> Tuple[int, int]:
    """(bytes, operations) of one :func:`cuda_value_iteration` call on these
    layouts: the layouts read once and V written once; per state and sweep
    one multiply by gamma and one max for each candidate beyond the first
    (stay, left, right always; forward, pickup, toggle where the layout
    offers them)."""
    walk, flags, slot, _ = vi_masks(layouts)
    b, C, _, hw = walk.shape
    fwd = ((walk == 1) & ((flags & 2) == 0)[:, None]).sum()
    pick = ((flags & 4) != 0).sum() * (C // 2)
    tog = (slot >= 0).sum() * C
    per_sweep = b * C * 4 * hw * 3 + int(fwd + pick + tog)
    return _nbytes(layouts) + b * C * 4 * hw * 4, n_sweeps * per_sweep


VI_LAYOUT_THREADS = 256  # at most, per layout: cells times config groups
VI_BLOCK_THREADS = 256  # threads per block to aim for
VI_MAX_THREADS = 1024


def vi_walk_bits(C: int) -> int:
    """How ``csrc/vi.cu`` holds walkability per config: a 32- or 64-bit mask
    in registers, or 0 for bytes in shared memory (C > 64, four or more
    door slots).  Each is an instance of the kernel (``kWalkBits``)."""
    return 32 if C <= 32 else 64 if C <= 64 else 0


def vi_shared_bytes(C: int, D: int, hw: int, lpb: int) -> int:
    """A block's shared memory: two V buffers and the toggle table for each
    of its lpb layouts, then their walkability bytes where C > 64."""
    S = C * 4 * hw
    return lpb * (2 * S * 4 + C * D * 4 + (0 if vi_walk_bits(C) else S))


def vi_plan(C: int, D: int, hw: int) -> Tuple[int, int]:
    """(layouts per block lpb, config groups G) of ``csrc/vi.cu``.  A
    layout has G * HW threads, (group g, cell) = divmod(thread, HW); group
    g owns the carry pairs p = g, g + G, ... of the C / 2 = 3**D pairs.  G
    is the largest power of 3 that divides the pairs and keeps a layout
    within VI_LAYOUT_THREADS; lpb fills VI_BLOCK_THREADS as far as shared
    memory allows."""
    pairs, G = C // 2, 1
    while pairs % (3 * G) == 0 and 3 * G * hw <= VI_LAYOUT_THREADS:
        G *= 3
    lpb = min(VI_BLOCK_THREADS // (G * hw), SMEM_PER_BLOCK // vi_shared_bytes(C, D, hw, 1))
    return max(1, lpb), G


def _check_vi_plan(C: int, D: int, hw: int, lpb: int, G: int) -> None:
    smem = vi_shared_bytes(C, D, hw, lpb)
    if lpb * G * hw > VI_MAX_THREADS or smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"csrc/vi.cu takes at most {VI_MAX_THREADS} threads a block (one per cell "
            f"and config group) and {SMEM_PER_BLOCK} bytes of shared memory; got "
            f"H*W={hw}, C={C}, D={D}, {lpb} layouts of {G} groups a block ({smem} bytes)"
        )


def _vi_kernel(masks, gamma: float, n_sweeps: int, shape) -> torch.Tensor:
    """Launch ``csrc/vi.cu`` on the masks of :func:`vi_masks`, with the
    (lpb, G) of :func:`vi_plan`: V of ``shape`` (B, C, 4, H, W) f32."""
    walk_front, cell_flags, door_slot, toggle_cfg = masks
    b, C, _, h, w = shape
    D = toggle_cfg.shape[2]
    dev = walk_front.device
    _kernels.check("vi masks", dev, {
        "walk_front": (walk_front, _U8, (b, C, 4, h * w)),
        "cell_flags": (cell_flags, _U8, (b, 4, h * w)),
        "door_slot": (door_slot, torch.int8, (b, 4, h * w)),
        "toggle_cfg": (toggle_cfg, _I32, (b, C, D)),
    })
    lpb, G = vi_plan(C, D, h * w)
    _check_vi_plan(C, D, h * w, lpb, G)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _kernels.entry("vi", "vi_launch", [_P] * 5 + [_I] * 7 + [_F, _I, _P])
    _kernels.launch(
        dev, fn,
        walk_front.data_ptr(), cell_flags.data_ptr(), door_slot.data_ptr(),
        toggle_cfg.data_ptr(), v.data_ptr(), b, C, D, h, w, lpb, G, gamma, n_sweeps,
    )
    profiling.count("vi.launches")
    return v


def cuda_value_iteration(
    layouts: TabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """Batched VI with V resident in shared memory: V (B, C, 4, H, W) f32,
    equal bit for bit to ``tabular.value_iteration``'s V."""
    dev = _check_layouts(layouts, _LAYOUT_SPEC)
    _check_run(gamma, n_sweeps)
    if dev.type == "cpu":
        return tabular.vi_values(layouts, gamma, n_sweeps)
    b, h, w = layouts.base_walk.shape
    shape = (b, _num_cfg(layouts.n_doors), 4, h, w)
    return _vi_kernel(vi_masks(layouts), gamma, n_sweeps, shape)



# --- B2: key-position domain -------------------------------------------------

_KEY_LAYOUT_SPEC = {
    "base_walk": (_BOOL, ("B", "H", "W")),
    "base_empty": (_BOOL, ("B", "H", "W")),
    "goal": (_BOOL, ("B", "H", "W")),
    "lava": (_BOOL, ("B", "H", "W")),
    "target_pos": (_I32, ("B", 2)),
    "door_pos": (_I32, ("B", "D", 2)),
    "door_id": (_I32, ("B", "H", "W")),
    "door_init": (_I32, ("B", "D")),
    "door_unlockable": (_BOOL, ("B", "D")),
    "key0": (_I32, ("B",)),
}


def key_vi_masks(layouts: KeyTabularLayout):
    """The kernel's per-layout inputs, as bytes:

    * cell_flags (B, 4, HW) u8: bit 0 goal, bit 1 lava, bit 2 target in
      front, bit 3 the key may be dropped in front;
    * cfg_flags (B, C, 4, HW) u8: in config c, bit 0 the front cell is
      walkable (the key aside), bit 1 a closed door is in front, bit 2 a
      locked door that the key opens is in front;
    * door_bit (B, 4, HW) u8: the config bit of the door in front."""
    fronts = tabular_key._front_tables(layouts)
    b, C, h, w = fronts[0].walk.shape
    cell_flags, cfg_flags, door_bit = [], [], []
    for f in fronts:
        cell = (
            f.goal.to(_U8)
            | f.lava.to(_U8) << 1
            | f.target.to(_U8) << 2
            | f.droppable.to(_U8) << 3
        )
        per_cfg = f.walk.to(_U8) | f.closed.to(_U8) << 1 | f.unlock.to(_U8) << 2
        cell_flags.append(cell.reshape(b, h * w))
        cfg_flags.append(per_cfg.reshape(b, C, h * w))
        door_bit.append(f.bit.reshape(b, h * w))
    return (
        torch.stack(cell_flags, dim=1).contiguous(),
        torch.stack(cfg_flags, dim=2).contiguous(),
        torch.stack(door_bit, dim=1).to(_U8).contiguous(),
    )


def key_vi_work(layouts: KeyTabularLayout, n_sweeps: int) -> Tuple[int, int]:
    """(bytes, operations) of one :func:`cuda_key_value_iteration` call: the
    layouts read once and V written once; per state and sweep one multiply
    by gamma and one max for each candidate beyond the first (stay, left,
    right always; forward, pickup, drop, toggle where the state offers
    them)."""
    cell_flags, cfg_flags, _ = key_vi_masks(layouts)
    b, C, _, hw = cfg_flags.shape
    K = hw + 1
    h, w = layouts.base_walk.shape[1:]
    # Forward for every key location but the front cell; pickup for the key
    # location in front; drop and unlocking only when carried; opening a
    # closed door for every key location.
    fwd = ((cfg_flags & 1) != 0) & ((cell_flags & 2) == 0)[:, None]
    in_grid = sum(
        int((tabular_key._front_index(h, w, dxy, "cpu") >= 0).sum()) for dxy in _DIRS
    )
    fwd = fwd.sum() * (K - 1)
    pick = b * C * in_grid
    drop = ((cell_flags & 8) != 0).sum() * C
    tog = ((cfg_flags & 2) != 0).sum() * K + ((cfg_flags & 4) != 0).sum()
    per_sweep = b * K * C * 4 * hw * 3 + int(fwd + pick + drop + tog)
    return _nbytes(layouts) + b * K * C * 4 * hw * 4, n_sweeps * per_sweep


KEY_CTA_THREADS = 256  # threads of a cluster CTA, at most (csrc/key_vi.cu:kCtaThreads)
KEY_CTAS_PER_SM = 3  # CTAs an SM should hold, so that one's barrier wait overlaps the others' work
KEY_MAX_CLUSTER = 8  # the portable limit of a thread-block cluster
KEY_WIDE_THREADS = 1024  # threads of a wide CTA, at most (csrc/key_vi.cu:kWideThreads)
KEY_WIDE_CLUSTER = 16  # CTAs of a wide cluster, above the portable limit (kWideCluster)
KEY_WIDE_ROWS = 32  # rows of a wide CTA, at most (kWideRows: a bit each in a register)
KEY_GRID_THREADS = 1024  # threads of a grid CTA, at most (kGridThreads)
KEY_GRID_ROWS = 32  # rows of a resident grid CTA, at most (kGridRows: a bit each in a register)
# CTAs of a layout on the grid route, at most: a group must be resident at
# once, one CTA an SM, and an H100 SXM has 132 SMs.
KEY_GRID_MAX_CTAS = 128
ROUTES = ("cluster", "wide", "grid")


def key_vi_groups(hw: int) -> int:
    """Thread groups G of a cluster CTA: its G * HW threads are (group,
    cell) = divmod(thread, HW)."""
    return max(1, KEY_CTA_THREADS // hw)


def key_vi_rows(K: int, n: int) -> List[Tuple[int, int]]:
    """(first key row, rows) that each CTA of a cluster of ``n`` owns: the
    first K % n CTAs take one row more."""
    q, rem = divmod(K, n)
    starts = [r * q + min(r, rem) for r in range(n + 1)]
    return [(starts[r], starts[r + 1] - starts[r]) for r in range(n)]


def key_vi_cluster_shared_bytes(C: int, hw: int, n: int) -> int:
    """A cluster CTA's shared memory: two V buffers, each of ceil(K / n)
    key rows, then the per-(config, cell) flags."""
    K = hw + 1
    return 2 * -(-K // n) * C * 4 * hw * 4 + C * hw * 4


def key_vi_wide_groups(hw: int) -> int:
    """Thread groups G of a wide CTA: G * HW <= KEY_WIDE_THREADS threads,
    (group, cell) = divmod(thread, HW)."""
    return max(1, KEY_WIDE_THREADS // hw)


def key_vi_wide_slots(hw: int, n: int, in_place: bool) -> int:
    """Row slots of each V buffer of a wide CTA: the HW rows other than
    CARRIED split over n - 1 CTAs, at least 2 (the hub's CARRIED row and
    drop table), in place 4 (each of them twice)."""
    return max(-(-hw // (n - 1)), 4 if in_place else 2)


def key_vi_wide_shared_bytes(C: int, hw: int, n: int, in_place: bool) -> int:
    """A wide CTA's shared memory: its row slots of V twice, or in place
    once; the per-(config, cell) flags; two pickup tables of 4 * C values
    for each row of the largest CTA."""
    rows = -(-hw // (n - 1))
    slots = key_vi_wide_slots(hw, n, in_place)
    return (1 if in_place else 2) * slots * C * 4 * hw * 4 + C * hw * 4 + 2 * rows * 4 * C * 4


def key_vi_wide_in_place(C: int, hw: int, n: int = KEY_WIDE_CLUSTER) -> bool:
    """Whether the wide route sweeps V in place: where the double buffer
    does not fit a CTA."""
    return key_vi_wide_shared_bytes(C, hw, n, False) > SMEM_PER_BLOCK


def key_vi_grid_rows(C: int, hw: int) -> int:
    """The most key rows (all C configs each) a resident grid CTA can hold
    in place beside the packed flags, at most KEY_GRID_ROWS; 0 where not
    one fits or a CTA cannot give each cell its thread."""
    if hw > KEY_GRID_THREADS:
        return 0
    return max(0, min(KEY_GRID_ROWS, (SMEM_PER_BLOCK - C * hw * 4) // (C * 4 * hw * 4)))


def key_vi_grid_resident(K: int, C: int, hw: int) -> bool:
    """Whether the grid route keeps V resident in its CTAs' shared memory:
    where a CTA holds at least one row and the K rows need at most
    KEY_GRID_MAX_CTAS CTAs; else V is streamed from device memory."""
    rows = key_vi_grid_rows(C, hw)
    return rows > 0 and -(-K // rows) <= KEY_GRID_MAX_CTAS


def key_vi_grid_ctas(K: int, C: int, hw: int) -> int:
    """CTAs n of a layout on the grid route: resident, the fewest that hold
    its K rows; streamed, its K * C (row, config) slabs over
    KEY_GRID_MAX_CTAS CTAs (one layout fills the card)."""
    if key_vi_grid_resident(K, C, hw):
        return -(-K // key_vi_grid_rows(C, hw))
    return min(K * C, KEY_GRID_MAX_CTAS)


def key_vi_grid_threads(hw: int) -> int:
    """Threads of a grid CTA: G groups of min(HW, KEY_GRID_THREADS), (group,
    cell) = divmod(thread, HW); a thread of a larger grid (streamed only)
    takes cells cell, cell + KEY_GRID_THREADS, ..."""
    t = min(hw, KEY_GRID_THREADS)
    return KEY_GRID_THREADS // t * t


def key_vi_grid_shared_bytes(C: int, hw: int, n: int, resident: bool) -> int:
    """A grid CTA's shared memory: resident, ceil(K / n) key rows of V (in
    place), then the per-(config, cell) flags; streamed, none."""
    return -(-(hw + 1) // n) * C * 4 * hw * 4 + C * hw * 4 if resident else 0


def key_vi_route(K: int, C: int, hw: int) -> Tuple[str, int]:
    """The kernel for V of (K, C, 4, HW) per layout: ``("cluster", n)``,
    the smallest power-of-two cluster whose CTAs' share of V lets an SM
    hold KEY_CTAS_PER_SM of them, else the smallest whose share fits at
    all; where even a cluster of 8 cannot hold V (or a CTA cannot give
    each cell its thread), ``("wide", 16)`` if 16 CTAs can hold it, in
    place if need be, with a thread for each cell and at most
    KEY_WIDE_ROWS rows a CTA; else ``("grid", n)`` with n from
    :func:`key_vi_grid_ctas`.  The shape alone decides."""
    fits = [
        n for n in (1, 2, 4, KEY_MAX_CLUSTER)
        if n <= K and key_vi_cluster_shared_bytes(C, hw, n) <= SMEM_PER_BLOCK
    ]
    if hw <= KEY_CTA_THREADS and fits:
        for n in fits:
            per_sm = SMEM_PER_SM // (key_vi_cluster_shared_bytes(C, hw, n) + 1024)
            if per_sm >= KEY_CTAS_PER_SM:
                return "cluster", n
        return "cluster", fits[0]
    n = KEY_WIDE_CLUSTER
    if (hw <= KEY_WIDE_THREADS and n <= hw + 1 and -(-hw // (n - 1)) <= KEY_WIDE_ROWS
            and key_vi_wide_shared_bytes(C, hw, n, True) <= SMEM_PER_BLOCK):
        return "wide", n
    return "grid", key_vi_grid_ctas(K, C, hw)


def key_vi_active_clusters(C: int, h: int, w: int, n: int) -> int:
    """Clusters of ``n`` CTAs of the cluster kernel that the current card
    can hold at once (``cudaOccupancyMaxActiveClusters``)."""
    fn = _kernels.entry("key_vi", "key_vi_cluster_occupancy", [_I] * 5)
    got = fn(C, h, w, n, key_vi_groups(h * w))
    if got < 0:
        raise RuntimeError(f"key_vi_cluster_occupancy failed: CUDA error {-got}")
    return got


def key_vi_wide_active_clusters(C: int, h: int, w: int, n: int = KEY_WIDE_CLUSTER) -> int:
    """Clusters of ``n`` CTAs of the wide kernel that the current card can
    hold at once (``cudaOccupancyMaxActiveClusters``)."""
    fn = _kernels.entry("key_vi", "key_vi_wide_occupancy", [_I] * 6)
    got = fn(C, h, w, n, key_vi_wide_groups(h * w), int(key_vi_wide_in_place(C, h * w, n)))
    if got < 0:
        raise RuntimeError(f"key_vi_wide_occupancy failed: CUDA error {-got}")
    return got


def key_vi_grid_active_groups(C: int, h: int, w: int, n: int, resident: bool) -> int:
    """Groups of ``n`` grid CTAs that the current card holds at once: the
    CTAs it holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times
    its SMs) over n."""
    fn = _kernels.entry("key_vi", "key_vi_grid_occupancy", [_I] * 6)
    got = fn(C, h, w, n, key_vi_grid_threads(h * w), int(resident))
    if got < 0:
        raise RuntimeError(f"key_vi_grid_occupancy failed: CUDA error {-got}")
    return got // n


def _check_key_masks(masks, shape) -> None:
    cell_flags, cfg_flags, door_bit = masks
    b, K, C, _, h, w = shape
    _kernels.check("key_vi masks", cell_flags.device, {
        "cell_flags": (cell_flags, _U8, (b, 4, h * w)),
        "cfg_flags": (cfg_flags, _U8, (b, C, 4, h * w)),
        "door_bit": (door_bit, _U8, (b, 4, h * w)),
    })


def _key_vi_kernel_cluster(masks, gamma: float, n_sweeps: int, shape, n: int) -> torch.Tensor:
    """Launch the cluster route of ``csrc/key_vi.cu`` with clusters of
    ``n`` CTAs of :func:`key_vi_groups` groups: V of ``shape`` (B, K, C, 4,
    H, W) f32."""
    _check_key_masks(masks, shape)
    b, K, C, _, h, w = shape
    G = key_vi_groups(h * w)
    smem = key_vi_cluster_shared_bytes(C, h * w, n)
    if not (1 <= n <= min(KEY_MAX_CLUSTER, K) and G * h * w <= KEY_CTA_THREADS
            and smem <= SMEM_PER_BLOCK):
        raise ValueError(f"no cluster of {n} CTAs of {G} groups for K={K}, H*W={h * w}")
    dev = masks[0].device
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _kernels.entry("key_vi", "key_vi_cluster_launch", [_P] * 4 + [_I] * 6 + [_F, _I, _P])
    _kernels.launch(
        dev, fn, *(m.data_ptr() for m in masks), v.data_ptr(), b, C, h, w, n, G,
        gamma, n_sweeps,
    )
    return v


def _key_vi_kernel_wide(masks, gamma: float, n_sweeps: int, shape,
                        n: int = KEY_WIDE_CLUSTER) -> torch.Tensor:
    """Launch the wide route of ``csrc/key_vi.cu`` with clusters of ``n``
    CTAs of :func:`key_vi_wide_groups` groups, in place where
    :func:`key_vi_wide_in_place` says: V of ``shape`` (B, K, C, 4, H, W)
    f32."""
    _check_key_masks(masks, shape)
    b, K, C, _, h, w = shape
    G = key_vi_wide_groups(h * w)
    in_place = key_vi_wide_in_place(C, h * w, n)
    smem = key_vi_wide_shared_bytes(C, h * w, n, in_place)
    if not (2 <= n <= min(KEY_WIDE_CLUSTER, K) and G * h * w <= KEY_WIDE_THREADS
            and -(-h * w // (n - 1)) <= KEY_WIDE_ROWS and smem <= SMEM_PER_BLOCK):
        raise ValueError(f"no wide cluster of {n} CTAs of {G} groups for K={K}, C={C}, H*W={h * w}")
    dev = masks[0].device
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _kernels.entry("key_vi", "key_vi_wide_launch", [_P] * 4 + [_I] * 7 + [_F, _I, _P])
    _kernels.launch(
        dev, fn, *(m.data_ptr() for m in masks), v.data_ptr(), b, C, h, w, n, G,
        int(in_place), gamma, n_sweeps,
    )
    return v


def _key_vi_kernel_grid(masks, gamma: float, n_sweeps: int, shape, n: int) -> torch.Tensor:
    """Launch the grid route of ``csrc/key_vi.cu``, resident where
    :func:`key_vi_grid_resident` says, else streamed: groups of ``n`` CTAs,
    as many groups as the card holds at once and the batch has layouts, in
    one cooperative launch.  V of ``shape`` (B, K, C, 4, H, W) f32."""
    _check_key_masks(masks, shape)
    b, K, C, _, h, w = shape
    hw = h * w
    resident = key_vi_grid_resident(K, C, hw)
    smem = key_vi_grid_shared_bytes(C, hw, n, resident)
    ok = (1 <= n <= K and -(-K // n) <= KEY_GRID_ROWS and hw <= KEY_GRID_THREADS
          and smem <= SMEM_PER_BLOCK) if resident else 1 <= n <= K * C
    if not ok:
        raise ValueError(f"no grid of {n} CTAs a layout for K={K}, C={C}, H*W={hw}")
    dev = masks[0].device
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    if b == 0:
        return v
    with torch.cuda.device(dev):
        groups = min(b, key_vi_grid_active_groups(C, h, w, n, resident))
    if groups < 1:
        raise RuntimeError(f"the card cannot hold a group of {n} grid CTAs at once")
    # Resident: each group's pickup and drop tables, two of each; streamed:
    # one layout of V a group, the double buffer's second half.
    scratch = torch.empty((groups, 4 if resident else K, C * 4 * hw), dtype=torch.float32, device=dev)
    count = torch.zeros(groups, dtype=torch.int32, device=dev)
    fn = _kernels.entry("key_vi", "key_vi_grid_launch", [_P] * 6 + [_I] * 8 + [_F, _I, _P])
    _kernels.launch(
        dev, fn, *(m.data_ptr() for m in masks), v.data_ptr(), scratch.data_ptr(),
        count.data_ptr(), b, C, h, w, n, key_vi_grid_threads(hw), groups, int(resident),
        gamma, n_sweeps,
    )
    return v


def _key_vi_kernel(masks, gamma: float, n_sweeps: int, shape) -> torch.Tensor:
    """Launch ``csrc/key_vi.cu`` on the masks of :func:`key_vi_masks` by the
    route :func:`key_vi_route` gives the shape, and count the launch."""
    _, K, C, _, h, w = shape
    route, n = key_vi_route(K, C, h * w)
    with profiling.span("dp.kernel", route=route):
        if route == "cluster":
            v = _key_vi_kernel_cluster(masks, gamma, n_sweeps, shape, n)
        elif route == "wide":
            v = _key_vi_kernel_wide(masks, gamma, n_sweeps, shape, n)
        else:
            v = _key_vi_kernel_grid(masks, gamma, n_sweeps, shape, n)
    profiling.count("key_vi.launches")
    profiling.count(f"key_vi.launches.{route}")
    return v


def cuda_key_value_iteration(
    layouts: KeyTabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """Batched key-domain VI: V (B, K, C, 4, H, W) f32, within 1e-6 of
    ``tabular_key.key_value_iteration``'s V."""
    dev = _check_layouts(layouts, _KEY_LAYOUT_SPEC)
    _check_run(gamma, n_sweeps)
    with profiling.span("dp.vi"):
        if dev.type == "cpu":
            return tabular_key.key_vi_values(layouts, gamma, n_sweeps)
        D = layouts.n_doors
        if D > 7:
            raise ValueError(f"the key-domain kernel takes at most 7 doors, got {D}")
        b, h, w = layouts.base_walk.shape
        shape = (b, h * w + 1, 1 << D, 4, h, w)
        with profiling.span("dp.masks"):
            masks = key_vi_masks(layouts)
        return _key_vi_kernel(masks, gamma, n_sweeps, shape)
