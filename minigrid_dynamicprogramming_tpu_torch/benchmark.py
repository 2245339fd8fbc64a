"""Micro-benchmark CLI.

Counterpart of ``minigrid_dynamicprogramming_tpu/benchmark.py``, the mirror
of the reference's ``minigrid/benchmark.py`` (reset ms, render FPS and
agent-view FPS over one env, ``benchmark.py:13-49``), plus batched
env-steps/s, here from ``lane_rollout`` (pool autoreset, the observation
encoded and checksummed every step).  Same default workload
(``MiniGrid-LavaGapS7-v0``, 200 resets, 5000 frames).  A single env is a
call at B=1.  On a card every time is read after
``torch.cuda.synchronize()``.

Run: ``python -m minigrid_dynamicprogramming_tpu_torch.benchmark --env-id ...``
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import time

import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device
from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import lane_rollout
from minigrid_dynamicprogramming_tpu_torch.render import render_frame, render_pov


def benchmark(
    env_id: str = "MiniGrid-LavaGapS7-v0",
    num_resets: int = 200,
    num_frames: int = 5000,
    tile_size: int = 32,
    batch: int = 4096,
    horizon: int = 256,
    device="cuda",
) -> dict:
    dev = resolve_device(device)
    env = port.make(env_id)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    # --- env.reset at B=1 (benchmark.py:16-21) ----------------------------
    obs, state = env.reset(gen(0), 1, dev)  # warm-up
    t0 = clock()
    for i in range(num_resets):
        obs, state = env.reset(gen(i), 1, dev)
    reset_ms = (clock() - t0) * 1000 / num_resets

    # --- full-frame rendering FPS (benchmark.py:24-29) --------------------
    frame = render_frame(env.params, state, tile_size)  # warm-up, builds the tile table
    t0 = clock()
    for _ in range(num_frames):
        frame = render_frame(env.params, state, tile_size)
    render_fps = num_frames / (clock() - t0)

    # --- agent-view FPS: step + POV render (benchmark.py:31-47) -----------
    g = gen(1)
    s = env.step(state, 0, g)[1]
    img = render_pov(env.params, s, tile_size)
    t0 = clock()
    for i in range(num_frames):
        s = env.step(s, i % 3, g)[1]
        img = render_pov(env.params, s, tile_size)
    agent_view_fps = num_frames / (clock() - t0)

    # --- batched env-steps/s on the lane engine ----------------------------
    lane_rollout(env, gen(2), batch, horizon, "pool", device=dev)  # warm-up
    t0 = clock()
    res = lane_rollout(env, gen(3), batch, horizon, "pool", device=dev)
    int(res.obs_checksum)  # the observation ran every step
    steps_per_s = batch * horizon / (clock() - t0)

    results = {
        "env_id": env_id,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "reset_ms": reset_ms,
        "render_fps": render_fps,
        "agent_view_fps": agent_view_fps,
        "batched_env_steps_per_s": steps_per_s,
        "batch": batch,
        "horizon": horizon,
        "frame_shape": tuple(frame.shape[1:]),
        "pov_shape": tuple(img.shape[1:]),
    }
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env-id", default="MiniGrid-LavaGapS7-v0")
    p.add_argument("--num-resets", type=int, default=200)
    p.add_argument("--num-frames", type=int, default=5000)
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    benchmark(
        args.env_id, args.num_resets, args.num_frames, args.tile_size,
        args.batch, args.horizon, args.device,
    )


if __name__ == "__main__":
    main()
