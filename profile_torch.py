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
  (``PPO._learn``: GAE and the 16 minibatch steps) on that rollout;
* the same for ``chip_smoke.py``'s rendering: ``render_frame`` (tile 32,
  highlight) of 4096 DoorKey-8x8 states, and a step of the pixel
  observation ``ImgObs(RGBImgPartialObs(env, 8))`` on BabyAI-GoToDoor at
  32768 envs;
* the frame's row gather alone, the renderer's largest kernel, at those
  4096 frames: tile rows moved as bytes against the same rows moved as
  int64 words, CUDA-event means over 10 calls, timed bytes, words, words,
  bytes, three times over.
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
RENDER_B, RENDER_TILE = 4096, 32


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


def profile_render(results: dict) -> None:
    """One ``render_frame`` call, and one step of the pixel observation."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch import wrappers as W
    from minigrid_dynamicprogramming_tpu_torch.render import render_frame

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    env = make(ENV_ID)
    _, state = env.reset(g, RENDER_B, device=dev)
    render_frame(env.params, state, RENDER_TILE)  # warm-up, builds the tile table
    results["render"] = {"env": ENV_ID, "B": RENDER_B, "tile": RENDER_TILE}
    profiled(lambda: render_frame(env.params, state, RENDER_TILE), "render_frame", 1, results["render"])
    pixel = W.ImgObsWrapper(W.RGBImgPartialObsWrapper(make(PPO_ENV), 8))
    _, state = pixel.reset(g, PPO_B, device=dev)
    act = torch.randint(0, 7, (PPO_B,), generator=g, device=dev)
    pixel.step(state, act, g)  # warm-up
    results["pixel_step"] = {"env": PPO_ENV, "B": PPO_B, "tile": 8}
    profiled(lambda: pixel.step(state, act, g), "pixel step", 1, results["pixel_step"])


def profile_render_rows(results: dict) -> None:
    """The row gather of ``render_frame`` (tile 32, 4096 DoorKey-8x8
    states; keys without agent and highlight) with the table's rows read
    as uint8 and as int64 words, in alternating order."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.render import tiles

    dev = torch.device("cuda")
    env = make(ENV_ID)
    _, state = env.reset(torch.Generator(device=dev).manual_seed(1), RENDER_B, device=dev)
    ts = RENDER_TILE
    key = ((state.grid_obj.to(torch.int64) * tiles.N_COLOR + state.grid_color) * tiles.N_STATE
           + state.grid_state) * tiles.N_AGENT * tiles.N_HL
    rows = (key[:, :, None, :] * ts + torch.arange(ts, device=dev)[:, None]).reshape(-1)
    table = tiles.tile_lut_tensor(ts, dev).reshape(-1, ts * 3)
    words = table.view(torch.int64)
    gathers = {"bytes": lambda: table.index_select(0, rows), "words": lambda: words.index_select(0, rows)}
    equal = torch.equal(gathers["bytes"](), gathers["words"]().view(torch.uint8))
    out = results["render_rows"] = {"B": RENDER_B, "tile": ts, "equal": equal,
                                    "bytes_ms": [], "words_ms": []}
    for _ in range(3):
        for name in ("bytes", "words", "words", "bytes"):
            out[f"{name}_ms"].append(part_ms(gathers[name], 10))
    print(f"[render rows] equal {equal}; uint8 rows ms {out['bytes_ms']}; "
          f"int64 words ms {out['words_ms']}", flush=True)


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
    profile_render(results)
    profile_render_rows(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
