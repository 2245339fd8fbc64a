#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one CUDA card: batched
env-steps/s, per family, and layout-sweeps/s of the exact-DP domains.

The counterpart of ``bench.py``, function by function, at its sizes, seeds
(as ``torch.Generator`` seeds), warm-ups and timed counts.  The rollouts
run the lane-major path (``parallel/lanes.py:lane_rollout``): the full
transition, the family's hooks and the egocentric observation every step,
its checksum read on the host, pool auto-reset from pregenerated layouts
(the pool's generation is timed, and the horizon exceeds the step limit,
so resets fire).  The DP rows time the user's call: the plain PyTorch
value iteration (V and policy) on the card, and the CUDA kernels
(``dp/cuda_vi.py``: B1 ``cuda_value_iteration``, B2
``cuda_key_value_iteration``, masks included).

Run from the repository root, on a machine with a card:

    python3 bench_torch.py                        # one JSON line on stdout
    python3 bench_torch.py --learn [--out PATH]   # PPO to mean return 0.90

The line has bench.py's shape: ``metric``, ``value``, ``unit``,
``vs_baseline`` (over the reference's single-env CPU rate, BASELINE.md) and
``extra``, whose keys are bench.py's with ``pallas`` read as ``cuda`` and
``xla`` as ``plain``, plus ``git_rev``, ``timestamp_utc``, ``device`` (the
card's name, power limit, clocks and power draw before and after the run),
``spread`` (``[min, max]`` over the timed runs of each rate timed more
than once), ``launches`` (the kernels' launches during the run, B2's by
route) and ``ppo_graphs`` (the PPO rows' CUDA graphs: captures, capture
ms and pool bytes of the collector and the learner, for the full and the
zero-epoch update).  ``main(sizes, device="cpu")`` runs on the CPU,
without the kernel rows, ``launches`` and ``ppo_graphs``; a failure
raises.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.benchmark import _clock  # waits for the card
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL, OBJ_BOX
from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_obstructed as TO
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_twokey as TT
from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.parallel.lanes import lane_rollout
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

# The reference's single-env CPU rate on DoorKey-8x8 (BASELINE.md).
REFERENCE_STEPS_PER_S = 10_145.0
GAMMA = 0.995
LEARN_THRESHOLD = 0.90
LEARN_OUT = "chiprun_out/LEARN_torch.json"

# bench.py's sizes.  DoorKey-8x8's step limit is 640: the 768-step horizon
# makes every lane reset at least once.
FULL = {
    "batch": 65536, "horizon": 768, "pool_rounds": 4, "warmup": 1, "iters": 3,
    "family_batch": 16384, "family_horizon": 256, "family_rounds": 2,
    "family_warmup": 1, "family_iters": 2,
    "vi_batch": 1024, "vi_sweeps": 128,
    "key_batch": 512, "key_sweeps": 96,
    "obstructed_batch": 4, "obstructed_sweeps": 64,
    "twokey_batch": 2, "twokey_sweeps": 48,
    "dp_runs": 3,  # timed runs of each DP row, after one warm-up
    "ppo_envs": 32768, "ppo_len": 32, "ppo_minibatches": 8, "ppo_warmup": 2, "ppo_timed": 5,
    "learn_envs": 8192, "learn_len": 64, "learn_max_updates": 300, "learn_patience": 3,
}

# One representative of every generation regime, with bench.py's seeds.
FAMILIES = {
    "babyai_gotolocal": ("BabyAI-GoToLocal-v0", 1),
    "dynamicobstacles_8x8": ("MiniGrid-Dynamic-Obstacles-8x8-v0", 2),
    "obstructedmaze_full_v1": ("MiniGrid-ObstructedMaze-Full-v1", 3),
    "keycorridor_s6r3": ("MiniGrid-KeyCorridorS6R3-v0", 4),
    "multiroom_n6": ("MiniGrid-MultiRoom-N6-v0", 5),
    "memory_s17": ("MiniGrid-MemoryS17Random-v0", 6),
    "babyai_bosslevel": ("BabyAI-BossLevel-v0", 7),
    "fetch_8x8_n3": ("MiniGrid-Fetch-8x8-N3-v0", 8),
}

SMI_QUERY = "name,power.limit,clocks.sm,clocks.mem,power.draw"


def _gen(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _spread(rates) -> list:
    return [round(min(rates), 1), round(max(rates), 1)]


def _lane_steps_per_s(env_id, batch, horizon, warmup, iters, seed, rounds, dev):
    """(steps / s over the timed runs, each run's steps / s)."""
    env = port.make(env_id)
    g = _gen(seed, dev)
    clock = _clock(dev)
    for _ in range(warmup):
        int(lane_rollout(env, g, batch, horizon, "pool", rounds, device=dev).obs_checksum)
    times = []
    for _ in range(iters):
        t0 = clock()
        res = lane_rollout(env, g, batch, horizon, "pool", rounds, device=dev)
        int(res.obs_checksum)  # the observation reaches the host
        times.append(clock() - t0)
    return iters * batch * horizon / sum(times), [batch * horizon / t for t in times]


def _timed_rates(fn, work: int, runs: int, dev) -> list:
    """``work`` / s of ``fn()`` over ``runs`` timed calls after one warm-up."""
    clock = _clock(dev)
    fn()
    rates = []
    for _ in range(runs):
        t0 = clock()
        fn()
        rates.append(work / (clock() - t0))
    return rates


def _doorkey_states(batch, dev, seed=11):
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    return env.generate(_gen(seed, dev), env.params, batch, dev)


def _first_object(states, obj: int):
    """The color of each layout's first ``obj`` in raster order (bench.py's
    ``argmax`` of the mask: the first cell where there is none)."""
    b = states.grid_obj.shape[0]
    flat = (states.grid_obj == obj).reshape(b, -1).to(torch.int8).argmax(dim=1)
    return states.grid_color.reshape(b, -1).gather(1, flat[:, None])[:, 0].to(torch.int32)


def _vi_restricted_pair(sizes, dev) -> dict:
    """B1's domain (door-config, dir, y, x) at DoorKey-8x8's one door slot:
    the rates of the plain VI and, on a card, the kernel, on the same
    layouts, by their keys in the line."""
    b, n, runs = sizes["vi_batch"], sizes["vi_sweeps"], sizes["dp_runs"]
    layouts = T.extract_layout(_doorkey_states(b, dev), max_doors=1)
    out = {"vi_d1_plain_sweeps_per_s": _timed_rates(
        lambda: T.value_iteration(layouts, GAMMA, n), b * n, runs, dev
    )}
    if dev.type == "cuda":
        out["vi_d1_cuda_sweeps_per_s"] = _timed_rates(
            lambda: cuda_vi.cuda_value_iteration(layouts, GAMMA, n), b * n, runs, dev
        )
    return out


def _vi_key_pair(sizes, dev) -> dict:
    """B2's domain (key-loc, door-config, dir, y, x) at one door slot: the
    rates of the plain VI and, on a card, the kernel (the cluster route at
    8x8), by their keys in the line."""
    b, n, runs = sizes["key_batch"], sizes["key_sweeps"], sizes["dp_runs"]
    layouts = TK.extract_key_layout(_doorkey_states(b, dev), max_doors=1)
    out = {"vi_key_sweeps_per_s": _timed_rates(
        lambda: TK.key_value_iteration(layouts, GAMMA, n), b * n, runs, dev
    )}
    if dev.type == "cuda":
        out["vi_key_cuda_sweeps_per_s"] = _timed_rates(
            lambda: cuda_vi.cuda_key_value_iteration(layouts, GAMMA, n), b * n, runs, dev
        )
    return out


def _vi_obstructed(sizes, dev) -> list:
    """The obstructed domain on BlockedUnlockPickup, the target the box in
    the far room (its color varies per layout)."""
    b, n = sizes["obstructed_batch"], sizes["obstructed_sweeps"]
    env = port.make("MiniGrid-BlockedUnlockPickup-v0")
    states = env.generate(_gen(17, dev), env.params, b, dev)
    layouts = TO.extract_obstructed_layout(
        states, max_doors=1, target_type=OBJ_BOX, target_color=_first_object(states, OBJ_BOX)
    )
    return _timed_rates(
        lambda: TO.obstructed_value_iteration(layouts, GAMMA, n), b * n, sizes["dp_runs"], dev
    )


def _vi_twokey(sizes, dev) -> list:
    """The two-key-chain domain on UnlockToUnlock, the target the ball."""
    b, n = sizes["twokey_batch"], sizes["twokey_sweeps"]
    env = port.make("BabyAI-UnlockToUnlock-v0")
    states = env.generate(_gen(23, dev), env.params, b, dev)
    layouts = TT.extract_twokey_layout(
        states, max_doors=2, target_type=OBJ_BALL, target_color=_first_object(states, OBJ_BALL)
    )
    return _timed_rates(
        lambda: TT.twokey_value_iteration(layouts, GAMMA, n), b * n, sizes["dp_runs"], dev
    )


def _ppo_steps_per_s(sizes, dev):
    """BabyAI-GoToDoor feeding the PPO learner: (env-steps/s of the full
    update, the rollout's mean seconds, the learner's, each full update's
    env-steps/s, the graphs' captures, capture ms and pool bytes of the
    full and the zero-epoch PPO).  The rollout is timed by a zero-epoch
    update (rollout and GAE only)."""
    env = port.make("BabyAI-GoToDoor-v0")
    clock = _clock(dev)

    def timed(epochs: int) -> list:
        cfg = PPOConfig(
            num_envs=sizes["ppo_envs"], rollout_len=sizes["ppo_len"], epochs=epochs,
            num_minibatches=sizes["ppo_minibatches"],
        )
        ppo = PPO(env, cfg, device=dev)
        ts = ppo.init(3)
        for _ in range(sizes["ppo_warmup"]):
            ts, _ = ppo.update(ts)
        times = []
        for _ in range(sizes["ppo_timed"]):
            t0 = clock()
            ts, _ = ppo.update(ts)
            times.append(clock() - t0)
        graphs[f"epochs_{epochs}"] = {
            "captures": ppo.captures, "capture_ms": ppo.capture_ms, "pool_bytes": ppo.pool_bytes,
        }
        return times

    graphs = {}
    full, roll = timed(2), timed(0)
    steps = sizes["ppo_envs"] * sizes["ppo_len"]
    f, r = statistics.mean(full), statistics.mean(roll)
    return steps / f, r, max(f - r, 0.0), [steps / t for t in full], graphs


def _ppo_learning_curve(env_id, threshold, sizes, dev, seed=0) -> dict:
    """Train PPO on ``env_id`` and record the return curve; stops once the
    mean terminal reward holds ``threshold`` over at least ``num_envs // 8``
    episodes for ``learn_patience`` updates in a row."""
    num_envs, rollout_len = sizes["learn_envs"], sizes["learn_len"]
    cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout_len, epochs=2, num_minibatches=8)
    ppo = PPO(port.make(env_id), cfg, device=dev)
    ts = ppo.init(seed)
    clock = _clock(dev)
    curve, hits, solved_at = [], 0, None
    t0 = clock()
    for u in range(sizes["learn_max_updates"]):
        ts, m = ppo.update(ts)
        ret, eps = float(m.mean_return), int(m.episodes)
        curve.append({
            "update": u + 1,
            "env_steps": (u + 1) * num_envs * rollout_len,
            "mean_return": round(ret, 4),
            "episodes": eps,
            "entropy": round(float(m.entropy), 4),
            "wall_s": round(clock() - t0, 2),
        })
        # An update with few finished episodes says little about the policy.
        hits = hits + 1 if (ret >= threshold and eps >= num_envs // 8) else 0
        if hits >= sizes["learn_patience"]:
            solved_at = curve[-1]
            break
    return {
        "env_id": env_id,
        "threshold": threshold,
        "num_envs": num_envs,
        "rollout_len": rollout_len,
        "seed": seed,
        "solved": solved_at is not None,
        "solved_at": solved_at,
        "wall_s": round(clock() - t0, 2),
        "final_return": curve[-1]["mean_return"] if curve else None,
        "curve": curve if len(curve) <= 400 else curve[::2],
    }


def _git_rev() -> str:
    """HEAD of the checkout this file lies in; "unknown" outside git."""
    if shutil.which("git") is None:
        return "unknown"
    out = subprocess.run(
        ["git", "rev-parse", "HEAD"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=10,
    )
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds")


def _smi() -> dict:
    """The card's name, power limit, clocks and power draw, by nvidia-smi."""
    line = subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]
    return dict(zip(SMI_QUERY.split(","), (v.strip() for v in line.split(","))))


def _launches() -> dict:
    return {
        "vi": profiling.counter("vi.launches"),
        "key_vi": {r: profiling.counter(f"key_vi.launches.{r}") for r in cuda_vi.ROUTES},
    }


def main(sizes: dict = FULL, device="cuda") -> dict:
    """Run every row, print the JSON line and return it as a dict."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        smi_before, launches_before = _smi(), _launches()
    spread = {}

    # Headline: DoorKey-8x8, hook-free.
    headline, spread["env_steps_per_s"] = _lane_steps_per_s(
        "MiniGrid-DoorKey-8x8-v0", sizes["batch"], sizes["horizon"], sizes["warmup"],
        sizes["iters"], 0, sizes["pool_rounds"], dev,
    )

    extra = {}
    for name, (env_id, seed) in FAMILIES.items():
        key = f"{name}_steps_per_s"
        rate, spread[key] = _lane_steps_per_s(
            env_id, sizes["family_batch"], sizes["family_horizon"], sizes["family_warmup"],
            sizes["family_iters"], seed, sizes["family_rounds"], dev,
        )
        extra[key] = round(rate, 1)

    rows = _vi_key_pair(sizes, dev)  # each DP row's rates, in bench.py's order
    rows["vi_obstructed_sweeps_per_s"] = _vi_obstructed(sizes, dev)
    rows["vi_twokey_sweeps_per_s"] = _vi_twokey(sizes, dev)
    rows.update(_vi_restricted_pair(sizes, dev))
    for key, rates in rows.items():
        extra[key] = round(statistics.median(rates), 1)

    sps, t_roll, t_learn, spread["ppo_steps_per_s"], ppo_graphs = _ppo_steps_per_s(sizes, dev)
    extra["ppo_steps_per_s"] = round(sps, 1)
    extra["ppo_rollout_s"] = round(t_roll, 3)
    extra["ppo_learner_s"] = round(t_learn, 3)

    extra["git_rev"] = _git_rev()
    extra["timestamp_utc"] = _utc_now()
    if on_card:
        extra["device"] = {
            "name": torch.cuda.get_device_name(dev), "nvidia_smi_before": smi_before,
            "nvidia_smi_after": _smi(),
        }
    else:
        extra["device"] = {"name": "cpu"}
    spread.update(rows)
    extra["spread"] = {k: _spread(v) for k, v in spread.items() if len(v) > 1}
    if on_card:
        after = _launches()
        extra["launches"] = {
            "vi": after["vi"] - launches_before["vi"],
            "key_vi": {r: n - launches_before["key_vi"][r] for r, n in after["key_vi"].items()},
        }
        extra["ppo_graphs"] = ppo_graphs

    line = {
        "metric": "env_steps_per_s",
        "value": round(headline, 1),
        "unit": "steps/s",
        "vs_baseline": round(headline / REFERENCE_STEPS_PER_S, 2),
        "extra": extra,
    }
    print(json.dumps(line), flush=True)
    return line


def learn_main(out_path: str = LEARN_OUT, sizes: dict = FULL, device="cuda") -> dict:
    """Train DoorKey-5x5 (pickup, then toggle) and GoToDoor (conditioned on
    the mission) to mean return 0.90 and write their curves to
    ``out_path`` as JSON, in bench.py's ``--learn`` artifact's shape."""
    dev = resolve_device(device)
    runs = [
        _ppo_learning_curve("MiniGrid-DoorKey-5x5-v0", LEARN_THRESHOLD, sizes, dev),
        _ppo_learning_curve("BabyAI-GoToDoor-v0", LEARN_THRESHOLD, sizes, dev),
    ]
    artifact = {
        "metric": "ppo_learning",
        "git_rev": _git_rev(),
        "timestamp_utc": _utc_now(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "runs": runs,
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    for r in runs:
        s = r["solved_at"]
        print(
            f"{r['env_id']}: solved={r['solved']} "
            + (
                f"return {s['mean_return']} at update {s['update']}, "
                f"{s['env_steps'] / 1e6:.1f}M steps / {s['wall_s']}s"
                if s else f"final return {r['final_return']}"
            )
        )
    print(f"wrote {out_path}")
    return artifact


def cli(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--learn", action="store_true", help="train PPO to mean return 0.90")
    parser.add_argument("--out", default=LEARN_OUT, help="where --learn writes its JSON")
    args = parser.parse_args(argv)
    if args.learn:
        learn_main(args.out)
    else:
        main()


if __name__ == "__main__":
    cli()
