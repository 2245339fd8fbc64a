#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, hold every kernel
against its plain version, and check the results.

Run from the repository root, on a machine with a card:

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises, exits nonzero and prints no "ok" line):

1. card and build: the card's name and power limit; the CUDA kernels under
   ``minigrid_dynamicprogramming_tpu_torch/csrc`` built with ``nvcc``.
2. rollout: ``lane_rollout`` on DoorKey-8x8 at B=65536, T=768, four pool
   rounds, layouts generated on the card.  T is above max_steps=640, so
   every lane resets.  The pool's layouts must hold DoorKey's invariants.
3. B1: ``tabular.solve`` on 1024 DoorKey-8x8 layouts, 128 sweeps, at
   max_doors 1 and 2; the kernel's V must equal the plain version's exactly.
4. B2: ``cuda_key_value_iteration`` on 512 layouts, 96 sweeps, within 1e-6
   of the plain version.
5. greedy solve: the max_doors=1 policy of phase 3, stepped by the port's
   ``step_lanes`` on the card, reaches the goal in every layout in exactly
   ``steps_to_go`` steps with the closed-form return.
6. the kernels line: for each kernel, its launches on the main path (each
   part of it driven with the counts set to 0 just before and read just
   after), its largest difference from the plain version, and the times of
   kernel, plain version and bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
ENV_ID = "MiniGrid-DoorKey-8x8-v0"
GAMMA = 0.995
ROLLOUT_B, ROLLOUT_T, POOL_ROUNDS = 65536, 768, 4
VI_B, VI_SWEEPS = 1024, 128
KEY_B, KEY_SWEEPS = 512, 96
KEY_ATOL = 1e-6
RETURN_ATOL = 1e-5

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth, and
# float32 operations outside the tensor cores.  The data sheet's 67 TFLOP/s
# counts a fused multiply-add as two operations; the kernels' work is
# multiplies and maxes, one operation per lane and cycle each, so their peak
# is half of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12 / 2

PALLAS_VI = "minigrid_dynamicprogramming_tpu/dp/pallas_vi.py"
CSRC = "minigrid_dynamicprogramming_tpu_torch/csrc"


def require(ok, what: str) -> None:
    if not bool(ok):
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations (float32 multiplies and maxes) over their rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(seed)


def check_doorkey_pool(pool, h: int, w: int) -> int:
    """DoorKey's layout invariants over every layout of a lane-major pool
    (rounds, HW, B): one locked yellow door on the split column, which is
    wall elsewhere; the yellow key and the agent left of it; the goal
    bottom-right.  Returns the number of layouts checked."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import (
        COLOR_YELLOW, OBJ_DOOR, OBJ_EMPTY, OBJ_GOAL, OBJ_KEY, OBJ_WALL,
        STATE_LOCKED,
    )

    def batch_first(plane):
        return plane.permute(0, 2, 1).reshape(-1, h, w).cpu().numpy()

    obj, color, st = (batch_first(getattr(pool, n)) for n in ("grid_obj", "grid_color", "grid_state"))
    ax = pool.agent_x.reshape(-1).cpu().numpy()
    ay = pool.agent_y.reshape(-1).cpu().numpy()
    n = obj.shape[0]
    rows = np.arange(n)
    doors = np.argwhere(obj == OBJ_DOOR)
    require(len(doors) == n and (doors[:, 0] == rows).all(), "one door per layout")
    door_y, split = doors[:, 1], doors[:, 2]
    require(((split >= 2) & (split < w - 2)).all(), "split column in [2, W-2)")
    require((st[rows, door_y, split] == STATE_LOCKED).all(), "the door is locked")
    require((color[rows, door_y, split] == COLOR_YELLOW).all(), "the door is yellow")
    column = obj[rows, :, split]
    require(((column == OBJ_WALL) | (np.arange(h) == door_y[:, None])).all(), "split column is wall")
    keys = np.argwhere(obj == OBJ_KEY)
    require(len(keys) == n and (keys[:, 0] == rows).all(), "one key per layout")
    require((keys[:, 2] < split).all(), "the key is left of the wall")
    require((color[rows, keys[:, 1], keys[:, 2]] == COLOR_YELLOW).all(), "the key is yellow")
    require(((ax >= 1) & (ax < split)).all(), "the agent is left of the wall")
    require((obj[rows, ay, ax] == OBJ_EMPTY).all(), "the agent stands on an empty cell")
    require((obj[:, h - 2, w - 2] == OBJ_GOAL).all(), "the goal is bottom-right")
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON to this file")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    try:
        from minigrid_dynamicprogramming_tpu_torch import _kernels, make
        from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
        from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
        from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK
        from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    counters = {"vi": cuda_vi.cuda_value_iteration, "key_vi": cuda_vi.cuda_key_value_iteration}

    def drive(part, fn):
        """Run one part of the main path with every launch count set to 0
        just before it; returns (fn's result, the counts just after)."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: c.launches for name, c in counters.items()}
        print(f"[main path] {part}: launches {counts}", flush=True)
        return out, counts

    # 1. Card and build.
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = _kernels.build()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    results = {"card": card, "build_s": time.perf_counter() - t0}

    # 2. Rollout.
    env = make(ENV_ID)
    h, w = env.params.height, env.params.width
    require(ROLLOUT_T > env.params.max_steps, "the horizon crosses the step limit")
    L.lane_rollout(env, gen(0), ROLLOUT_B, 4, pool_rounds=POOL_ROUNDS, device=DEVICE)  # warm-up
    torch.cuda.synchronize()
    g = gen(1)
    g_pool = torch.Generator(device=DEVICE).set_state(g.get_state())
    t0 = time.perf_counter()
    res, _ = drive(
        "rollout",
        lambda: L.lane_rollout(
            env, g, ROLLOUT_B, ROLLOUT_T, pool_rounds=POOL_ROUNDS, device=DEVICE
        ),
    )
    rollout_s = time.perf_counter() - t0
    # The same pool again, from the same generator state, timed and checked.
    t0 = time.perf_counter()
    pool = L._lane_pool(env, g_pool, ROLLOUT_B, "pool", POOL_ROUNDS, torch.device(DEVICE))
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    episodes = int(res.episodes)
    require(episodes > 0, "episodes > 0")
    require(int(res.resets_per_env.min()) >= 1, "every lane reset at least once")
    require(float(res.total_reward) > 0, "total reward > 0")
    n_layouts = check_doorkey_pool(pool, h, w)
    steps_per_s = ROLLOUT_B * ROLLOUT_T / rollout_s
    print(
        f"[rollout] B={ROLLOUT_B} T={ROLLOUT_T} pool={POOL_ROUNDS}: {rollout_s:.3f} s "
        f"({steps_per_s:.4g} env-steps/s incl. generating the pool, which alone takes "
        f"{pool_s:.3f} s); episodes {episodes}, total reward {float(res.total_reward):.1f}, "
        f"resets per lane >= {int(res.resets_per_env.min())}, {n_layouts} pool layouts valid",
        flush=True,
    )
    results["rollout"] = {
        "B": ROLLOUT_B, "T": ROLLOUT_T, "pool_rounds": POOL_ROUNDS, "s": rollout_s,
        "env_steps_per_s": steps_per_s, "pool_s": pool_s,
        "steps_per_s_after_pool": ROLLOUT_B * ROLLOUT_T / (rollout_s - pool_s),
        "episodes": episodes, "total_reward": float(res.total_reward),
    }
    del res, pool

    kernels = []

    def kernel_row(name, source, replaces, launches, err, call, kernel_only, plain, work, reps):
        ms = cuda_ms(call, reps)
        kernel_ms = cuda_ms(kernel_only, reps)
        plain_ms = cuda_ms(plain, 2)
        bound_ms, bound_by = bound(*work)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_only_ms": kernel_ms,
        }
        print(
            f"[{name}] max|kernel - plain| {err:.3g}; kernel {ms:.4f} ms "
            f"(the launch alone {kernel_ms:.4f} ms), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}; main-path launches {launches}",
            flush=True,
        )
        kernels.append(row)

    # 3. B1 through solve, at one and two door slots, on the same layouts.
    solved = {}
    for doors in (1, 2):
        solved[doors], counts = drive(
            f"solve max_doors={doors}",
            lambda: T.solve(
                env, gen(2), VI_B, GAMMA, VI_SWEEPS, max_doors=doors, device=DEVICE
            ),
        )
        states, layouts, v, _ = solved[doors]
        require(counts["vi"] == 1, "solve launched the B1 kernel once")
        v_plain = T.vi_values(layouts, GAMMA, VI_SWEEPS)
        err = float((v - v_plain).abs().max())
        require(err == 0.0, f"B1 equals its plain version at max_doors={doors}")
        require(bool((v > 0).any()), "some state reaches the goal")
        masks = cuda_vi.vi_masks(layouts)
        kernel_row(
            f"vi_max_doors{doors}", f"{CSRC}/vi.cu", f"{PALLAS_VI}:201", counts["vi"], err,
            lambda: cuda_vi.cuda_value_iteration(layouts, GAMMA, VI_SWEEPS),
            lambda: cuda_vi._vi_kernel(masks, GAMMA, VI_SWEEPS, v.shape),
            lambda: T.vi_values(layouts, GAMMA, VI_SWEEPS),
            cuda_vi.vi_work(layouts, VI_SWEEPS), reps=10,
        )
        del v_plain
    require(torch.equal(solved[1][0].grid_obj, solved[2][0].grid_obj), "same layouts at both budgets")

    # 4. B2 on the key-position domain.
    def key_path():
        states = env.generate(gen(3), env.params, KEY_B, device=DEVICE)
        layouts = TK.extract_key_layout(states, max_doors=1)
        return layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY_SWEEPS)

    (key_layouts, kv), counts = drive("key-domain VI", key_path)
    require(counts["key_vi"] == 1, "the B2 kernel launched once")
    kv_plain = TK.key_vi_values(key_layouts, GAMMA, KEY_SWEEPS)
    err = float((kv - kv_plain).abs().max())
    require(err <= KEY_ATOL, f"B2 within {KEY_ATOL} of its plain version")
    require(bool((kv > 0).any()), "some key-domain state reaches the goal")
    del kv_plain
    key_masks = cuda_vi.key_vi_masks(key_layouts)
    kernel_row(
        "key_vi", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts["key_vi"], err,
        lambda: cuda_vi.cuda_key_value_iteration(key_layouts, GAMMA, KEY_SWEEPS),
        lambda: cuda_vi._key_vi_kernel(key_masks, GAMMA, KEY_SWEEPS, kv.shape),
        lambda: TK.key_vi_values(key_layouts, GAMMA, KEY_SWEEPS),
        cuda_vi.key_vi_work(key_layouts, KEY_SWEEPS), reps=5,
    )
    del kv

    # 5. The greedy policy of the max_doors=1 solve, stepped on the card.
    states, layouts, v, policy = solved[1]
    params = env.params
    vals = T.state_value(v, layouts, states)
    dists = T.steps_to_go(vals, GAMMA)
    require(bool(torch.isfinite(dists).all()), "every start state reaches the goal")
    ls = L.to_lanes(states)
    done = torch.zeros(VI_B, dtype=torch.bool, device=DEVICE)
    steps = torch.zeros(VI_B, dtype=torch.float32, device=DEVICE)
    rew = torch.zeros(VI_B, dtype=torch.float32, device=DEVICE)
    for t in range(int(dists.max()) + 1):
        act = T.greedy_action(policy, layouts, L.from_lanes(params, ls))
        ls, r, term = L.step_lanes(params, ls, act)
        newly = term & ~done
        rew = torch.where(newly, r, rew)
        steps = torch.where(newly, float(t + 1), steps)
        done |= term
    want_r = T.env_return(vals, GAMMA, 0, params.max_steps)
    require(bool(done.all()), "every env terminated")
    require(bool((rew > 0).all()), "every env reached the goal")
    require(torch.equal(steps, dists.to(steps.dtype)), "each in exactly steps_to_go steps")
    r_err = float((rew - want_r).abs().max())
    require(r_err <= RETURN_ATOL, f"returns within {RETURN_ATOL} of env_return")
    print(
        f"[greedy] {VI_B} layouts solved optimally: {int(dists.min())}..{int(dists.max())} "
        f"steps, max|return - env_return| {r_err:.3g}",
        flush=True,
    )
    results["greedy"] = {"layouts": VI_B, "max_steps_to_go": int(dists.max()), "return_err": r_err}

    # 6. Kernels line, card, ok.
    results["kernels"] = kernels
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**results, "device": device}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
