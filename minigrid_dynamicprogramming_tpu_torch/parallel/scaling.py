"""Scaling harness: env-steps/s against the number of devices.

Counterpart of ``minigrid_dynamicprogramming_tpu/parallel/scaling.py``.
A weak-scaling sweep: a fixed batch per device and a growing group, one
process a device (rank r on ``cuda:r``, or on the CPU when asked), each
group formed anew in worker processes.  The envs are independent, so the
step needs no communication; what a larger group adds is the launch of
its ranks and the final all-reduce of the rollout's scalars.

Usage::

    python -m minigrid_dynamicprogramming_tpu_torch.parallel.scaling \\
        --env-id MiniGrid-DoorKey-8x8-v0 --per-device-batch 8192

prints one JSON line a group size.  ``--device cpu`` runs every rank on
the CPU (gloo, one thread a rank).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

import torch

# The bound of each group's rendezvous, collectives and worker processes.
TIMEOUT_S = 600.0
_PKG_PARENT = str(Path(__file__).resolve().parents[2])


class ScalePoint(NamedTuple):
    n_devices: int
    batch: int
    steps_per_s: float
    efficiency: float  # steps_per_s / (n * steps_per_s[1 device])


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(spec: dict) -> None:
    """One rank of ``spec`` (what :func:`_run_group` passes): join the
    group, time ``iters`` sharded rollouts after ``warmup`` ones, and
    (rank 0) print the slowest rank's seconds."""
    from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
    from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import lane_rollout
    from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import sharded_keys
    from minigrid_dynamicprogramming_tpu_torch.registry import make

    import torch.distributed as dist

    args = argparse.Namespace(**spec)
    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    distributed.initialize(
        f"127.0.0.1:{args.port}", args.world, args.rank, local_device_ids=[args.rank],
        max_retries=1, backend="gloo" if cpu else "nccl", timeout_s=args.timeout_s,
    )
    try:
        group = distributed.global_env_group("cpu" if cpu else None)
        env = make(args.env_id)
        batch = args.per_device_batch * args.world
        g = sharded_keys(args.seed, group)

        def sync():
            if not cpu:
                torch.cuda.synchronize(group.device)

        for _ in range(args.warmup):
            lane_rollout(env, g, batch, args.horizon, "pool", 4, group=group)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            res = lane_rollout(env, g, batch, args.horizon, "pool", 4, group=group)
        int(res.obs_checksum)
        sync()
        elapsed = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=group.device)
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)  # the slowest rank's time
        if args.rank == 0:
            print(json.dumps({"seconds": float(elapsed), "episodes": int(res.episodes)}), flush=True)
    finally:
        dist.destroy_process_group()


def _run_group(env_id, n, per_device_batch, horizon, warmup, iters, seed, device, timeout_s) -> float:
    """Seconds of ``iters`` rollouts of one group of ``n`` ranks, the
    slowest rank's."""
    spec = dict(env_id=env_id, world=n, per_device_batch=per_device_batch, horizon=horizon,
                warmup=warmup, iters=iters, seed=seed, device=device, port=free_port(),
                timeout_s=timeout_s)
    env = dict(os.environ, PYTHONPATH=_PKG_PARENT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "minigrid_dynamicprogramming_tpu_torch.parallel.scaling",
             "--worker", json.dumps(dict(spec, rank=r))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for r in range(n)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"scaling worker {r} of {n} exited {p.returncode}:\n{err[-4000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])["seconds"]


def measure_scaling(
    env_id: str,
    per_device_batch: int = 4096,
    horizon: int = 256,
    device_counts: Optional[Sequence[int]] = None,
    warmup: int = 1,
    iters: int = 2,
    seed: int = 0,
    device="cuda",
    timeout_s: float = TIMEOUT_S,
) -> List[ScalePoint]:
    """Weak-scaling sweep: ``per_device_batch`` lanes a rank, one group of
    each size in ``device_counts`` (default 1 to the number of cards), on
    the pool-autoreset lane rollout.  A point's rate is its global
    env-steps over the slowest rank's time; efficiency(n) = steps/s(n) /
    (n * steps/s(first point))."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        available = torch.cuda.device_count()
    elif device == "cpu":
        available = None
    else:
        raise ValueError(f"device is 'cuda' or 'cpu', not {device!r}")
    if device_counts is None:
        device_counts = range(1, (available or 1) + 1)
    points: List[ScalePoint] = []
    base = None
    for n in device_counts:
        if available is not None and n > available:
            raise ValueError(f"{n} ranks need {n} cards; this machine has {available}")
        seconds = _run_group(env_id, n, per_device_batch, horizon, warmup, iters, seed, device, timeout_s)
        batch = per_device_batch * n
        sps = batch * horizon * iters / seconds
        if base is None:
            base = sps
        points.append(ScalePoint(n, batch, sps, sps / (n * base)))
    return points


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env-id", default="MiniGrid-DoorKey-8x8-v0")
    p.add_argument("--per-device-batch", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # One rank of a group, its spec as JSON (run by measure_scaling).
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(json.loads(args.worker))
        return
    pts = measure_scaling(args.env_id, args.per_device_batch, args.horizon, device=args.device)
    for pt in pts:
        print(json.dumps({
            "n_devices": pt.n_devices,
            "batch": pt.batch,
            "steps_per_s": round(pt.steps_per_s, 1),
            "efficiency": round(pt.efficiency, 4),
        }))


if __name__ == "__main__":
    main()
