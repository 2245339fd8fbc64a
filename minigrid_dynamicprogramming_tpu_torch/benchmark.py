"""Micro-benchmark CLI.

Counterpart of ``minigrid_dynamicprogramming_tpu/benchmark.py``, the mirror
of the reference's ``minigrid/benchmark.py`` (reset ms, render FPS and
agent-view FPS over one env, ``benchmark.py:13-49``), plus JAX's two
batched rates, both from ``lane_rollout`` with the observation encoded
and checksummed every step: ``batched_env_steps_per_s`` from the
``"regen"`` rollout (a fresh layout generated every step, JAX's default
``rollout``) and ``lane_env_steps_per_s`` from the ``"pool"`` rollout.
Same default workload (``MiniGrid-LavaGapS7-v0``, 200 resets, 5000
frames, 4096 envs for 256 steps).  A single env is a
call at B=1.  On a card every time is read after
``torch.cuda.synchronize()``.

``--dp`` also times value iteration on DoorKey-8x8 layouts (JAX's
``benchmark_dp`` sizes), the plain PyTorch version and then the CUDA
kernel (``dp/cuda_vi.py:cuda_value_iteration``, the counterpart of JAX's
Pallas kernel); the kernel runs on a card only.  ``--trace DIR`` writes a
Chrome trace of the whole run to ``DIR/trace.json`` and, beside it, the
run's spans and counters (``utils/profiling.py``: the CLI's own spans, the
rollouts' ``lanes.*`` and ``generator.generate``) to ``DIR/spans.json``;
``--telemetry`` prints the generator's acceptance report for ``--env-id``.

Run: ``python -m minigrid_dynamicprogramming_tpu_torch.benchmark --env-id ...``
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi, tabular
from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import lane_rollout, supports_lanes
from minigrid_dynamicprogramming_tpu_torch.render import render_frame, render_pov
from minigrid_dynamicprogramming_tpu_torch.utils.profiling import span, trace

DP_ENV, DP_SEED, DP_MAX_DOORS, DP_GAMMA = "MiniGrid-DoorKey-8x8-v0", 7, 2, 0.995


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

    clock = _clock(dev)

    # --- env.reset at B=1 (benchmark.py:16-21) ----------------------------
    with span("reset"):
        obs, state = env.reset(gen(0), 1, dev)  # warm-up
        t0 = clock()
        for i in range(num_resets):
            obs, state = env.reset(gen(i), 1, dev)
        reset_ms = (clock() - t0) * 1000 / num_resets

    # --- full-frame rendering FPS (benchmark.py:24-29) --------------------
    with span("render_frame"):
        frame = render_frame(env.params, state, tile_size)  # warm-up, builds the tile table
        t0 = clock()
        for _ in range(num_frames):
            frame = render_frame(env.params, state, tile_size)
        render_fps = num_frames / (clock() - t0)

    # --- agent-view FPS: step + POV render (benchmark.py:31-47) -----------
    with span("agent_view"):
        g = gen(1)
        s = env.step(state, 0, g)[1]
        img = render_pov(env.params, s, tile_size)
        t0 = clock()
        for i in range(num_frames):
            s = env.step(s, i % 3, g)[1]
            img = render_pov(env.params, s, tile_size)
        agent_view_fps = num_frames / (clock() - t0)

    # --- batched env-steps/s: the "regen" rollout, JAX's headline ---------
    with span("regen_rollout"):
        lane_rollout(env, gen(2), batch, horizon, "regen", device=dev)  # warm-up
        t0 = clock()
        res = lane_rollout(env, gen(3), batch, horizon, "regen", device=dev)
        int(res.obs_checksum)  # the observation ran every step
        steps_per_s = batch * horizon / (clock() - t0)

    # --- the lane engine's pool autoreset ----------------------------------
    lane_steps_per_s = None
    if supports_lanes(env):
        with span("lane_rollout"):
            lane_rollout(env, gen(4), batch, horizon, "pool", device=dev)  # warm-up
            t0 = clock()
            res = lane_rollout(env, gen(5), batch, horizon, "pool", device=dev)
            int(res.obs_checksum)
            lane_steps_per_s = batch * horizon / (clock() - t0)

    results = {
        "env_id": env_id,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "reset_ms": reset_ms,
        "render_fps": render_fps,
        "agent_view_fps": agent_view_fps,
        "batched_env_steps_per_s": steps_per_s,
        "lane_env_steps_per_s": lane_steps_per_s,
        "batch": batch,
        "horizon": horizon,
        "frame_shape": tuple(frame.shape[1:]),
        "pov_shape": tuple(img.shape[1:]),
    }
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


def _clock(dev: torch.device):
    """A host clock that first waits for ``dev`` if it is a card."""

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    return clock


def dp_layouts(env_id: str = DP_ENV, batch: int = 1024, device="cuda") -> tabular.TabularLayout:
    """The layouts :func:`benchmark_dp` solves: ``batch`` generated from
    seed 7, extracted at two door slots (JAX's ``benchmark_dp``)."""
    dev = resolve_device(device)
    env = port.make(env_id)
    states = env.generate(torch.Generator(device=dev).manual_seed(DP_SEED), env.params, batch, dev)
    return tabular.extract_layout(states, max_doors=DP_MAX_DOORS)


def dp_solve(layouts: tabular.TabularLayout, n_sweeps: int, use_kernel: bool):
    """(V, policy) of ``layouts``, V from the CUDA kernel or from the plain
    version; the policy is one plain backup over V either way."""
    if not use_kernel:
        return tabular.value_iteration(layouts, DP_GAMMA, n_sweeps)
    if layouts.base_walk.device.type != "cuda":
        raise RuntimeError("the value-iteration kernel runs on a card; the layouts are on the CPU")
    v = cuda_vi.cuda_value_iteration(layouts, DP_GAMMA, n_sweeps)
    return v, tabular.greedy_policy(v, layouts, DP_GAMMA)


def benchmark_dp(
    env_id: str = DP_ENV,
    batch: int = 1024,
    n_sweeps: int = 128,
    use_kernel: bool = False,
    device="cuda",
) -> dict:
    """Value-iteration layout-sweeps/s: one sweep is a Bellman backup over
    the (door config, dir, y, x) states of one layout; the rate is ``batch
    * n_sweeps`` over the time of one solve, after a warm-up solve.
    ``use_kernel`` times the CUDA kernel (a card only: it raises for the
    CPU), else the plain PyTorch version."""
    dev = resolve_device(device)
    clock = _clock(dev)
    with span("dp/layouts"):
        layouts = dp_layouts(env_id, batch, dev)
    with span("dp/value_iteration"):
        dp_solve(layouts, n_sweeps, use_kernel)  # warm-up
        t0 = clock()
        dp_solve(layouts, n_sweeps, use_kernel)
        sweeps_per_s = batch * n_sweeps / (clock() - t0)
    results = {
        "env_id": env_id,
        "vi_backend": "cuda" if use_kernel else "torch",
        "vi_sweeps_per_s": sweeps_per_s,
        "vi_batch": batch,
        "vi_n_sweeps": n_sweeps,
    }
    for k, val in results.items():
        print(f"{k}: {val}")
    return results


def main(argv=None) -> dict:
    """Run the CLI; returns every report it printed, by name."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env-id", default="MiniGrid-LavaGapS7-v0")
    p.add_argument("--num-resets", type=int, default=200)
    p.add_argument("--num-frames", type=int, default=5000)
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument("--device", default="cuda")
    p.add_argument(
        "--dp", action="store_true",
        help="also time value iteration: the plain version, then the CUDA kernel (a card only)",
    )
    p.add_argument(
        "--trace", metavar="LOGDIR", default=None,
        help="write a Chrome trace of the run to LOGDIR/trace.json, its spans to LOGDIR/spans.json",
    )
    p.add_argument(
        "--telemetry", action="store_true",
        help="also report the generator's acceptance telemetry for --env-id",
    )
    args = p.parse_args(argv)

    reports = {}
    with trace(args.trace) if args.trace else contextlib.nullcontext():
        reports["benchmark"] = benchmark(
            args.env_id, args.num_resets, args.num_frames, args.tile_size,
            args.batch, args.horizon, args.device,
        )
        if args.telemetry:
            from minigrid_dynamicprogramming_tpu_torch.utils.telemetry import generation_acceptance

            reports["telemetry"] = generation_acceptance(port.make(args.env_id), device=args.device)
            for k, v in reports["telemetry"].items():
                print(f"gen_{k}: {v}")
        if args.dp:
            for use_kernel in (False, True):
                reports["dp_cuda" if use_kernel else "dp_torch"] = benchmark_dp(
                    use_kernel=use_kernel, device=args.device
                )
    return reports


if __name__ == "__main__":
    main()
