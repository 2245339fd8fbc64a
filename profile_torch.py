#!/usr/bin/env python3
"""Where a step of the PyTorch port's DoorKey-8x8 rollout, and a PPO
update, spend their time, on one CUDA card.

Run from the repository root, on a machine with a card:

    python3 profile_torch.py [--out results.json]

It works at the rollout's batch, B=65536, with four pool rounds, and prints
the card's name and power limit, then:

* the device time of each part of a rollout step (transition, autoreset
  select, observation and checksum), each timed alone with CUDA events on
  the same state, over 32 repetitions;
* for 32 steps of the rollout loop: the wall time per step without the
  profiler, and under ``torch.profiler`` the kernel time and kernels
  launched per step and the ten kernels that take the most device time.
  The device's busy share is the profiler's kernel time over the wall time
  of the same loop run without the profiler.
* for one PPO update at ``chip_smoke.py``'s throughput configuration
  (BabyAI-GoToDoor, 32768 envs, T=32, 2 epochs x 8 minibatches, bf16): the
  same for its two halves, the rollout (``PPO._collect``) and the learner
  (``PPO._learn``: GAE and the 16 minibatch steps) on that rollout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
BATCH, STEPS, POOL_ROUNDS = 65536, 32, 4
PPO_ENV, PPO_B, PPO_T, PPO_MB = "BabyAI-GoToDoor-v0", 32768, 32, 8


def part_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, label: str, per: int, results: dict) -> None:
    """Time ``fn()`` on the host clock, then under ``torch.profiler``:
    kernel time, kernels launched and the ten costliest kernels, each
    divided by ``per`` (steps or updates); adds them to ``results``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    out = results[label] = dict(
        wall_ms=wall_ms / per,
        profiled_wall_ms=profiled_ms / per,
        device_ms=device_ms / per,
        busy_share=device_ms / wall_ms,
        kernels=launches / per,
        top_kernels=[],
    )
    print(
        f"[{label}] {wall_ms / per:.4f} ms on the host clock ({profiled_ms / per:.4f} ms under "
        f"the profiler), {device_ms / per:.4f} ms of kernels, busy share "
        f"{device_ms / wall_ms:.4f}, {launches / per:.1f} kernels",
        flush=True,
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        share = e.self_device_time_total / 1e3 / device_ms
        out["top_kernels"].append({"name": e.key[:120], "count": e.count, "share": share})
        print(f"[kernel] {share:6.3f} x{e.count:6d} {e.key[:100]}")


def profile_ppo(results: dict) -> None:
    """The rollout and the learner of one PPO update, after one update
    that warms both up."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    cfg = PPOConfig(num_envs=PPO_B, rollout_len=PPO_T, epochs=2, num_minibatches=PPO_MB)
    ppo = PPO(make(PPO_ENV), cfg)
    ts, _ = ppo.update(ppo.init(3))
    _, last_obs, _, traj = ppo._collect(ts)
    with torch.no_grad():
        _, last_value = ts.model(last_obs)
    results["ppo"] = {"env": PPO_ENV, "num_envs": PPO_B, "rollout_len": PPO_T}
    profiled(lambda: ppo._collect(ts), "ppo rollout, per step", PPO_T, results["ppo"])
    profiled(lambda: ppo._learn(ts, traj, last_value), "ppo learner, per update", 1, results["ppo"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA card is available", file=sys.stderr)
        return 1
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    b, steps = BATCH, STEPS
    env = make(ENV_ID)
    params = env.params
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    pool = L._lane_pool(env, g, b, "pool", POOL_ROUNDS, dev)
    skip = L._skip_fields(params)
    ls = L.LaneState(**{n: getattr(pool, n)[0] for n in L._FIELDS})
    act = torch.randint(0, env.action_dim, (b,), generator=g, device=dev, dtype=torch.int32)
    done = torch.rand(b, generator=g, device=dev) < 0.01
    resets = torch.randint(0, 8, (b,), generator=g, device=dev, dtype=torch.int32)

    def observe():
        obj, color, obj_state, vis = L.obs_lanes(params, ls)
        return ((obj.to(torch.int64) + color + obj_state) * vis).sum()

    parts = {
        "transition (step_lanes)": lambda: L.step_lanes_env(env, ls, act),
        "autoreset select": lambda: L._select_lanes(
            done, L._select_pool(pool, resets % POOL_ROUNDS, POOL_ROUNDS, skip), ls, skip
        ),
        "observation + checksum": observe,
    }
    results = {"card": card, "batch": b, "steps": steps, "parts_ms": {}}
    for name, fn in parts.items():
        ms = part_ms(fn, steps)
        results["parts_ms"][name] = ms
        print(f"[part] {name}: {ms:.4f} ms per step")

    L._lane_scan(env, g, pool, b, 4, "pool", POOL_ROUNDS)  # warm-up
    profiled(lambda: L._lane_scan(env, g, pool, b, steps, "pool", POOL_ROUNDS),
             f"rollout loop, B={b}, per step", steps, results)
    del pool, ls
    profile_ppo(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
