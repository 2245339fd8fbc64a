"""Hand-written CUDA kernels for batched value iteration, with their plain
versions.

* :func:`cuda_value_iteration` (``csrc/vi.cu``) replaces
  ``minigrid_dynamicprogramming_tpu/dp/pallas_vi.py:_vi_kernel`` (launched
  by ``pallas_value_iteration``).  Plain version: ``tabular.vi_values``,
  which is ``tabular.value_iteration``'s V.
* :func:`cuda_key_value_iteration` (``csrc/key_vi.cu``) replaces
  ``pallas_vi.py:_key_vi_kernel`` (launched by
  ``pallas_key_value_iteration``).  Plain version:
  ``tabular_key.key_vi_values``, ``key_value_iteration``'s V.

What bounds each kernel on an H100, and what its design does about it, is
noted at the top of its ``.cu`` file.  A wrapper checks its inputs, then
runs the plain version for tensors on the CPU and launches its kernel for
CUDA tensors (raising if the launch fails; there is no fallback).  Each
wrapper counts its launches in a plain integer attribute,
``cuda_value_iteration.launches``, so a run can show that it went through
the kernel.  Like ``pallas_vi``, the wrappers return V only: the policy is
one plain backup over it.

The per-layout masks are packed here into bytes from the same per-direction
decode of the layout that the plain backups read (``tabular._front_tables``,
``tabular_key._front_tables``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch import _kernels
from minigrid_dynamicprogramming_tpu_torch.dp import tabular, tabular_key
from minigrid_dynamicprogramming_tpu_torch.dp.tabular import _DIRS, TabularLayout, _num_cfg
from minigrid_dynamicprogramming_tpu_torch.dp.tabular_key import KeyTabularLayout

__all__ = ["cuda_value_iteration", "cuda_key_value_iteration"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U8, _I32, _BOOL = torch.uint8, torch.int32, torch.bool


def _lib_fn(name: str, fn: str, argtypes):
    f = getattr(_kernels.library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


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


def _check_mask(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} (contiguous: {t.is_contiguous()})"
        )


def _launch(dev: torch.device, fn, *args) -> None:
    """Call the C entry point on the current stream of ``dev``; it returns
    the launch's cudaError_t."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _nbytes(record) -> int:
    return sum(t.numel() * t.element_size() for t in record.__dict__.values())


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


def _vi_kernel(masks, gamma: float, n_sweeps: int, shape) -> torch.Tensor:
    """Launch ``csrc/vi.cu`` on the masks of :func:`vi_masks`: V of ``shape``
    (B, C, 4, H, W) f32."""
    walk_front, cell_flags, door_slot, toggle_cfg = masks
    b, C, _, h, w = shape
    D = toggle_cfg.shape[2]
    _check_mask(walk_front, "walk_front", _U8, (b, C, 4, h * w))
    _check_mask(cell_flags, "cell_flags", _U8, (b, 4, h * w))
    _check_mask(door_slot, "door_slot", torch.int8, (b, 4, h * w))
    _check_mask(toggle_cfg, "toggle_cfg", _I32, (b, C, D))
    dev = walk_front.device
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _lib_fn("vi", "vi_launch", [_P] * 5 + [_I] * 5 + [_F, _I, _P])
    _launch(
        dev, fn,
        walk_front.data_ptr(), cell_flags.data_ptr(), door_slot.data_ptr(),
        toggle_cfg.data_ptr(), v.data_ptr(), b, C, D, h, w, gamma, n_sweeps,
    )
    cuda_value_iteration.launches += 1
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


cuda_value_iteration.launches = 0


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


def _key_vi_kernel(masks, gamma: float, n_sweeps: int, shape) -> torch.Tensor:
    """Launch ``csrc/key_vi.cu`` on the masks of :func:`key_vi_masks`: V of
    ``shape`` (B, K, C, 4, H, W) f32."""
    cell_flags, cfg_flags, door_bit = masks
    b, K, C, _, h, w = shape
    _check_mask(cell_flags, "cell_flags", _U8, (b, 4, h * w))
    _check_mask(cfg_flags, "cfg_flags", _U8, (b, C, 4, h * w))
    _check_mask(door_bit, "door_bit", _U8, (b, 4, h * w))
    dev = cell_flags.device
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _lib_fn("key_vi", "key_vi_launch", [_P] * 5 + [_I] * 4 + [_F, _I, _P])
    _launch(
        dev, fn,
        cell_flags.data_ptr(), cfg_flags.data_ptr(), door_bit.data_ptr(),
        v.data_ptr(), scratch.data_ptr(), b, C, h, w, gamma, n_sweeps,
    )
    cuda_key_value_iteration.launches += 1
    return v


def cuda_key_value_iteration(
    layouts: KeyTabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """Batched key-domain VI: V (B, K, C, 4, H, W) f32, within 1e-6 of
    ``tabular_key.key_value_iteration``'s V."""
    dev = _check_layouts(layouts, _KEY_LAYOUT_SPEC)
    _check_run(gamma, n_sweeps)
    if dev.type == "cpu":
        return tabular_key.key_vi_values(layouts, gamma, n_sweeps)
    D = layouts.n_doors
    if D > 7:
        raise ValueError(f"the key-domain kernel takes at most 7 doors, got {D}")
    b, h, w = layouts.base_walk.shape
    shape = (b, h * w + 1, 1 << D, 4, h, w)
    return _key_vi_kernel(key_vi_masks(layouts), gamma, n_sweeps, shape)


cuda_key_value_iteration.launches = 0
