#!/usr/bin/env python3
"""Run B2 (``csrc/key_vi.cu``) from this checkout and from another one on
the same layouts, on one card: V compared, kernel times taken in turns
(other, this, this, other).

Run from the repository root, on a machine with a card, after unpacking
the other commit (``git archive``) into a git-ignored directory:

    python3 compare_key_vi.py _checkouts/parent [--out results.json]

The other checkout's ``key_vi.cu`` is built with this checkout's flags
into ``_build/`` and called through its C entry points, whose arguments
are the same in both.  Shapes:

* DoorKey-8x8 at one and two door slots (512 layouts, 96 sweeps): the
  cluster route in both (clusters of 4 and 8); V must be equal bit for bit.
* The shapes this checkout sends to its wide route, DoorKey-16x16 (32
  layouts at 24 sweeps, as ``chip_smoke.py`` runs it, and 512 at 96, the
  B2 bench's size) and KeyCorridorS3R2 at six door slots (512 layouts, 128
  sweeps, as ``chip_smoke.py`` phase 9 runs it), against the other
  checkout's wide route (V equal bit for bit).
* The shapes this checkout sends to its grid route, as ``chip_smoke.py``
  runs them: DoorKey-16x16 at two door slots (32 layouts, 24 sweeps),
  DoorKey-8x8 at seven (64 layouts, 96 sweeps), the KeyCorridorS3R3
  layouts of 512 that have at most seven doors (128 sweeps) and LockedRoom
  at six (4 layouts, 128 sweeps; streamed), against the other checkout's
  grid route (bit for bit).

Prints one line per shape and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import DEVICE, GAMMA, bound, card_line, cuda_ms, gen, require

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SHAPES = (
    # (env, max_doors, layouts, sweeps, this checkout's route)
    ("MiniGrid-DoorKey-8x8-v0", 1, 512, 96, "cluster"),
    ("MiniGrid-DoorKey-8x8-v0", 2, 512, 96, "cluster"),
    ("MiniGrid-DoorKey-16x16-v0", 1, 32, 24, "wide"),
    ("MiniGrid-DoorKey-16x16-v0", 1, 512, 96, "wide"),
    ("MiniGrid-KeyCorridorS3R2-v0", 6, 512, 128, "wide"),
    ("MiniGrid-DoorKey-16x16-v0", 2, 32, 24, "grid"),
    ("MiniGrid-DoorKey-8x8-v0", 7, 64, 96, "grid"),
    ("MiniGrid-KeyCorridorS3R3-v0", 7, 512, 128, "grid"),
    ("MiniGrid-LockedRoom-v0", 6, 4, 128, "grid"),
)
REPS = 3


def other_library(checkout: Path) -> ctypes.CDLL:
    """The other checkout's ``key_vi.cu``, built with this checkout's flags."""
    from minigrid_dynamicprogramming_tpu_torch import _kernels

    src = checkout / "minigrid_dynamicprogramming_tpu_torch" / "csrc" / "key_vi.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_kernels.NVCC_FLAGS).encode()).hexdigest()
    lib = _kernels.BUILD / f"other-key_vi-{digest[:16]}.so"
    if not lib.exists():
        _kernels.BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def other_launch(lib, route: str, masks, shape, sweeps: int, n: int) -> torch.Tensor:
    """V from the other checkout's cluster, wide or grid route."""
    b, K, C, _, h, w = shape
    v = torch.empty(shape, dtype=torch.float32, device=masks[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [m.data_ptr() for m in masks]
    if route == "cluster":
        from minigrid_dynamicprogramming_tpu_torch.dp.cuda_vi import key_vi_groups

        fn = lib.key_vi_cluster_launch
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_F, _I, _P]
        err = fn(*ptrs, v.data_ptr(), b, C, h, w, n, key_vi_groups(h * w), GAMMA, sweeps, stream)
    elif route == "wide":
        from minigrid_dynamicprogramming_tpu_torch.dp.cuda_vi import key_vi_wide_groups, key_vi_wide_in_place

        fn = lib.key_vi_wide_launch
        fn.argtypes = [_P] * 4 + [_I] * 7 + [_F, _I, _P]
        err = fn(*ptrs, v.data_ptr(), b, C, h, w, n, key_vi_wide_groups(h * w),
                 int(key_vi_wide_in_place(C, h * w, n)), GAMMA, sweeps, stream)
    else:
        from minigrid_dynamicprogramming_tpu_torch.dp.cuda_vi import key_vi_grid_resident, key_vi_grid_threads

        resident, threads = key_vi_grid_resident(K, C, h * w), key_vi_grid_threads(h * w)
        occupancy = lib.key_vi_grid_occupancy
        occupancy.argtypes = [_I] * 6
        groups = min(b, occupancy(C, h, w, n, threads, int(resident)) // n)
        require(groups >= 1, "the other checkout's grid route: a group fits the card")
        scratch = torch.empty((groups, 4 if resident else K, C * 4 * h * w), dtype=torch.float32,
                              device=v.device)
        count = torch.zeros(groups, dtype=torch.int32, device=v.device)
        fn = lib.key_vi_grid_launch
        fn.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
        err = fn(*ptrs, v.data_ptr(), scratch.data_ptr(), count.data_ptr(), b, C, h, w, n, threads,
                 groups, int(resident), GAMMA, sweeps, stream)
    require(err == 0, f"the other checkout's {route} launch: CUDA error {err}")
    return v


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other checkout's root")
    parser.add_argument("--out", help="also write the results as JSON to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_key_vi: no CUDA card is available", file=sys.stderr)
        return 1
    import minigrid_dynamicprogramming_tpu_torch as port
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_DOOR
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK

    lib = other_library(args.other)
    results = []
    for seed, (env_id, doors, b, sweeps, route) in enumerate(SHAPES):
        env = port.make(env_id)
        states = env.generate(gen(20 + seed), env.params, b, device=DEVICE)
        # The layouts the domain holds: at most `doors` doors.
        fits = (states.grid_obj == OBJ_DOOR).sum(dim=(1, 2)) <= doors
        states = dataclasses.replace(states, **{k: t[fits] for k, t in states.__dict__.items()})
        b = int(fits.sum())
        if "KeyCorridor" in env_id:
            layouts = TK.extract_key_layout(states, doors, states.aux[:, 0], states.aux[:, 1])
        else:
            layouts = TK.extract_key_layout(states, doors)
        h, w = env.params.height, env.params.width
        K, C = h * w + 1, 1 << doors
        shape = (b, K, C, 4, h, w)
        got_route, n = cuda_vi.key_vi_route(K, C, h * w)
        require(got_route == route, f"{env_id}: this checkout's route is {route}")
        masks = cuda_vi.key_vi_masks(layouts)

        def this():
            return cuda_vi._key_vi_kernel(masks, GAMMA, sweeps, shape)

        def other():
            return other_launch(lib, route, masks, shape, sweeps, n)

        diff = float((this() - other()).abs().max())
        require(diff == 0.0, f"{env_id}: the {route} route's V equal bit for bit")
        ms = [cuda_ms(f, REPS) for f in (other, this, this, other)]
        bound_ms, bound_by = bound(*cuda_vi.key_vi_work(layouts, sweeps))
        row = {
            "env": env_id, "max_doors": doors, "layouts": b, "sweeps": sweeps,
            "route": route, "cluster": n,
            "other_ms": [ms[0], ms[3]], "this_ms": [ms[1], ms[2]],
            "max_abs_diff": diff, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print(f"[compare_key_vi] {json.dumps(row)}", flush=True)
        results.append(row)
        del states, layouts, masks
    card = card_line()
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card, "shapes": results}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
