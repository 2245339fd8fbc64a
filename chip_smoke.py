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
   max_doors 1 and 2; the kernel's V must equal the plain version's
   exactly.  Then the kernel's other two ways of holding walkability, also
   exactly: a 64-bit mask (DoorKey-8x8, max_doors 3) and bytes in shared
   memory (DoorKey-5x5, max_doors 4).
4. B2: ``cuda_key_value_iteration`` on 512 DoorKey-8x8 layouts, 96
   sweeps, within 1e-6 of the plain version, on the cluster route (V in a
   thread-block cluster's shared memory), at one door slot (a cluster of
   4) and two (a cluster of 8); then on 32 DoorKey-16x16 layouts, 24
   sweeps, on the global route (V in device memory), the route for V too
   large for a cluster of 8.  The global route is also timed at the 8x8
   shape, as the yardstick of the cluster route.
5. greedy solve: the max_doors=1 policy of phase 3, stepped by the port's
   ``step_lanes`` on the card, reaches the goal in every layout in exactly
   ``steps_to_go`` steps with the closed-form return.
6. families: ``lane_rollout`` with pool autoreset on every other
   MiniGrid id but the RoomGrid families of phase 8, layouts generated
   on the card: LavaCrossingS9N2 and
   Dynamic-Obstacles-8x8 at B=32768, T=400, two pool rounds (both step
   limits are below T, so every lane resets); Fetch-8x8-N3 and
   MemoryS17Random at B=16384, T=256; Empty-8x8 and FourRooms at B=4096,
   T=256; every other id at B=4096, T=64.  Each prints its env-steps/s.
   For every id whose hooks draw nothing, the rollout's first CPU_LANES
   lanes are replayed on the CPU (the path the CPU tests hold against
   JAX) from the same pool with the same actions, in worker processes
   while the card goes on: final state, its observation and resets per
   lane must equal the card's.  DynamicObstacles keeps
   exactly its ball count per lane, with aux naming each ball, and pays
   only -1 or a reward in (0, 1].
7. B1 on the families' layouts: ``tabular.solve`` (max_doors=1) on 1024
   layouts of LavaGapS7 (7x7) and LavaCrossingS9N2 (9x9), 128 sweeps, and
   FourRooms (19x19), 256 sweeps: the kernel's instance for sizes given at
   run time, and its lava flag.  V must equal the plain version's exactly;
   the greedy policy, stepped by ``step_lanes_env``, must reach the goal
   in exactly ``steps_to_go`` steps with the closed-form return on every
   layout whose start has V > 0 and ``steps_to_go <= max_steps``; the
   other layouts are counted.
8. RoomGrid families: the same on the 26 ids of KeyCorridor, MultiRoom,
   ObstructedMaze, Unlock, UnlockPickup, BlockedUnlockPickup and
   Playground: KeyCorridorS6R3, MultiRoom-N6 and ObstructedMaze-Full-v1 at
   B=16384, T=256, two pool rounds (the JAX bench's per-family sweep), the
   others at B=4096, T=64.  No hook of theirs draws, so each replays on the
   CPU as in phase 6.  MultiRoom's pooled generator must chain every room
   in at least as many attempts as it has layouts to give.
9. B2 on the families' layouts: ``cuda_key_value_iteration`` (128 sweeps)
   on 512 KeyCorridorS3R2 layouts at six door slots (C = 64, the global
   route) and 512 ObstructedMaze-1Dl layouts at one (11 wide and 6 high,
   the cluster route), the target named by aux slots 0-1; every layout has
   at most that many doors.  V within 1e-6 of the plain version; the
   greedy policy, stepped by ``step_lanes_env`` with the family's hook,
   picks up the target in exactly ``key_steps_to_go`` steps with the
   closed-form return on every layout whose start has V > 0 and
   ``steps_to_go <= max_steps``; the other layouts are counted.
10. the obstructed domain, plain PyTorch on the card (it has no kernel):
   ``obstructed_value_iteration`` (128 sweeps) on 64 BlockedUnlockPickup
   layouts (the target the box, as the JAX bench picks it) and 64
   ObstructedMaze-1Dlhb layouts (the target from aux), with the same
   greedy check; layout-sweeps/s and peak memory; V on the card equal to
   V on the CPU within 1e-6 on the first two layouts at 16 sweeps.
11. BabyAI: the same on all 96 BabyAI ids, the verifier as the post-step
   hook: GoToLocal and BossLevel at B=16384, T=256, two pool rounds (the
   JAX bench's per-family sweep), GoToDoor at B=32768 (the PPO bench's
   per-chip batch), the others at B=4096, T=64.  The verifier draws
   nothing, so each replays on the CPU.  Each prints its env-steps/s, the
   successes and failures the verifier counted (GoToLocal must succeed),
   and how many attempts its pooled generator accepted.
12. the two-key domain, plain PyTorch on the card (it has no kernel):
   ``twokey_value_iteration`` (160 sweeps) on 64 UnlockToUnlock layouts
   (16x6, two locked doors, the target the ball): every start finite, the
   greedy policy, stepped with the verifier, picks up the ball in exactly
   ``twokey_steps_to_go`` steps with the closed-form return on all 64;
   layout-sweeps/s and peak memory; V on the card equal to V on the CPU
   within 1e-6 on the first two layouts at 8 sweeps.
13. the environment API: ``reset``, ``step`` and ``observation`` at
   B=4096 on DoorKey-8x8, BabyAI-GoToLocal and MemoryS7 for 64 scripted
   steps on the card, equal at every step (observation, state, flags;
   the reward within 1e-5: the card divides by the step limit as a
   multiply by its reciprocal) to the same calls on the CPU, run in
   worker processes;
   DynamicObstacles' balls kept through ``step``; the same at B=1.
14. PPO throughput at the JAX bench's configuration (BabyAI-GoToDoor,
   32768 envs, T=32, 2 epochs, 8 minibatches): two warm-up updates, then
   five timed ones; the full update's env-steps/s, and the rollout /
   learner split, the rollout timed by a zero-epoch update.
15. PPO learning: MiniGrid-DoorKey-5x5 and BabyAI-GoToDoor at the JAX
   learning bench's configuration (8192 envs, T=64, 2 epochs, 8
   minibatches) must each reach mean return >= 0.90 over >= 1024
   episodes for 3 updates in a row within 100 updates; each curve is
   printed.
16. rendering and wrappers: ``render_frame`` (tile 32, highlight) on 4096
   DoorKey-8x8 states two steps into their episodes (805 MB of frames) and
   ``render_pov`` (tile 8) on 32768, each with its ms, frames/s, peak
   memory and bound (bytes over 3.35 TB/s), the first 256 frames equal to
   the CPU's; the pixel observation of pixel-based agents,
   ``ImgObsWrapper(RGBImgPartialObsWrapper(env, 8))``, on DoorKey-8x8 and
   BabyAI-GoToDoor at B=32768 for 32 steps of seeded random actions
   (env-steps/s, peak memory); each of the 15 wrappers at B=256 for 16
   steps, every deterministic one equal on card and CPU at every step
   (rewards within 1e-5, "angle" within 1e-6), StochasticActionWrapper
   (prob=1.0 is the bare step; at 0.5 the replaced share within 4 sigma,
   no replacement 6) and ReseedWrapper (its cycle) by their invariants.
17. the BabyAI bot: four envs of each of the 92 solvable BabyAI ids, one
   ``BabyAIBot`` per env over one batch-first ``step`` (``run_bots``), up
   to 240 steps; an id that solves none gets four more episodes.  Every
   id solved at least once, with a positive reward, and the solve share
   >= 0.90; per-id counts, episodes/s and the phase's seconds.
18. the kernels line: for each kernel, its launches on the main path (each
   part of it driven with the counts set to 0 just before and read just
   after), its largest difference from the plain version, the times of
   kernel, plain version and bound, its design and route, and the
   registers and shared memory the compiler gave it.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

DEVICE = "cuda"
ENV_ID = "MiniGrid-DoorKey-8x8-v0"
GAMMA = 0.995
ROLLOUT_B, ROLLOUT_T, POOL_ROUNDS = 65536, 768, 4
VI_B, VI_SWEEPS = 1024, 128
KEY_B, KEY_SWEEPS = 512, 96
KEY16_ENV, KEY16_B, KEY16_SWEEPS = "MiniGrid-DoorKey-16x16-v0", 32, 24
# B1 at more door slots: (env, max_doors) for the 64-bit walk mask and for
# walkability bytes in shared memory.
VI_MANY_DOORS = (("MiniGrid-DoorKey-8x8-v0", 3), ("MiniGrid-DoorKey-5x5-v0", 4))
KEY_ATOL = 1e-6
RETURN_ATOL = 1e-5
# Family rollouts, (B, T, pool rounds): BASELINE.json config 4 (LavaCrossing
# and DynamicObstacles), the JAX bench's per-family sweep (Fetch, Memory),
# BASELINE.json config 2 (Empty, FourRooms); every other id at FAMILY_OTHER.
FAMILY_RUNS = {
    "MiniGrid-LavaCrossingS9N2-v0": (32768, 400, 2),
    "MiniGrid-Dynamic-Obstacles-8x8-v0": (32768, 400, 2),
    "MiniGrid-Fetch-8x8-N3-v0": (16384, 256, 2),
    "MiniGrid-MemoryS17Random-v0": (16384, 256, 2),
    "MiniGrid-Empty-8x8-v0": (4096, 256, 2),
    "MiniGrid-FourRooms-v0": (4096, 256, 2),
}
FAMILY_OTHER = (4096, 64, 2)
CPU_LANES = 256  # lanes of each family's rollout replayed on the CPU
REPLAY_WORKERS = 5  # processes for the replays
DYN_OBS_STEPS = 64  # steps of the DynamicObstacles reward and ball checks
# The RoomGrid families (phase 8), by id prefix; (B, T, pool rounds) of the
# JAX bench's per-family sweep (bench.py:442-459) for three of them, every
# other id at FAMILY_OTHER.
ROOMGRID_PREFIXES = tuple(f"MiniGrid-{f}" for f in (
    "KeyCorridor", "MultiRoom", "ObstructedMaze", "Unlock", "BlockedUnlockPickup", "Playground",
))
ROOMGRID_RUNS = {
    "MiniGrid-KeyCorridorS6R3-v0": (16384, 256, 2),
    "MiniGrid-MultiRoom-N6-v0": (16384, 256, 2),
    "MiniGrid-ObstructedMaze-Full-v1": (16384, 256, 2),
}
# B2 on the families' layouts (phase 9): (env, max_doors), at the JAX key
# bench's batch (bench.py:141).
KEY_FAMILIES = (("MiniGrid-KeyCorridorS3R2-v0", 6), ("MiniGrid-ObstructedMaze-1Dl-v0", 1))
KEY_FAMILY_B, KEY_FAMILY_SWEEPS = 512, 128
# The obstructed domain (phase 10), one door slot; V is 9.77 MB a layout at
# 11x6, so 64 layouts hold 625 MB.  Card against CPU on the first layouts.
OBSTRUCTED = ("MiniGrid-BlockedUnlockPickup-v0", "MiniGrid-ObstructedMaze-1Dlhb-v0")
OBS_B, OBS_SWEEPS = 64, 128
OBS_CPU_LAYOUTS, OBS_CPU_SWEEPS = 2, 16
# The BabyAI ids (phase 11): the JAX bench's per-family sweep (bench.py:442-459)
# for GoToLocal and BossLevel, the PPO bench's per-chip batch for GoToDoor
# (bench.py:258-281); every other id at FAMILY_OTHER.
BABYAI_RUNS = {
    "BabyAI-GoToLocal-v0": (16384, 256, 2),
    "BabyAI-BossLevel-v0": (16384, 256, 2),
    "BabyAI-GoToDoor-v0": (32768, 256, 2),
}
# The two-key domain (phase 12): registered UnlockToUnlock layouts (16x6, two
# doors), V 59.0 MB a layout.  Card against CPU on the first layouts.
TWOKEY_ENV, TWOKEY_B, TWOKEY_SWEEPS = "BabyAI-UnlockToUnlock-v0", 64, 160
TWOKEY_CPU_LAYOUTS, TWOKEY_CPU_SWEEPS = 2, 8
# The environment API (phase 13): ids, batch, scripted steps; the
# DynamicObstacles id; steps of the B=1 call.
ENV_API_IDS = ("MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToLocal-v0", "MiniGrid-MemoryS7-v0")
ENV_API_B, ENV_API_STEPS = 4096, 64
ENV_API_DYN = "MiniGrid-Dynamic-Obstacles-8x8-v0"
ENV_API_SINGLE_STEPS = 32
# left, right, forward, pickup, drop, toggle, done: weighted towards forward
ENV_API_ACTION_P = np.array([0.15, 0.15, 0.3, 0.1, 0.1, 0.1, 0.1])
# PPO (phases 14-15): the JAX bench's throughput configuration
# (bench.py:255-281) and learning configuration (bench.py:310-386).
PPO_ENV, PPO_B, PPO_T, PPO_MB = "BabyAI-GoToDoor-v0", 32768, 32, 8
PPO_WARMUP, PPO_TIMED = 2, 5
LEARN_IDS = ("MiniGrid-DoorKey-5x5-v0", "BabyAI-GoToDoor-v0")
LEARN_B, LEARN_T, LEARN_MB, LEARN_MAX_UPDATES = 8192, 64, 8, 100
LEARN_THRESHOLD, LEARN_MIN_EPISODES, LEARN_PATIENCE = 0.90, 1024, 3
# Rendering and wrappers (phase 16): render_frame at tile 32 on DoorKey-8x8
# (805 MB of frames at B=4096), render_pov at tile 8; the pixel observation
# of pixel-based agents, ImgObs(RGBImgPartialObs(env, 8)) (56x56x3), at the
# PPO bench's per-chip batch; each wrapper at WRAP_B for WRAP_T steps, card
# against CPU.  The first RENDER_CPU_B frames are rendered on the CPU too.
RENDER_B, RENDER_TILE, POV_B, POV_TILE = 4096, 32, 32768, 8
RENDER_CPU_B = 256
PIXEL_IDS = ("MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToDoor-v0")
PIXEL_B, PIXEL_T = 32768, 32
WRAP_B, WRAP_T = 256, 16
# The bot (phase 17): BOT_B envs of every solvable BabyAI id, one bot each,
# up to BOT_STEPS steps; an id that solves none gets one more batch (eight
# episodes in all, as the CPU test's MAX_SEEDS).  BOT_SOLVE_FLOOR is the JAX
# test's SOLVE_FLOOR (tests/test_babyai_bot.py:66).
BOT_BROKEN = ("BabyAI-PutNextS5N2Carrying-v0", "BabyAI-PutNextS6N3Carrying-v0",
              "BabyAI-PutNextS7N4Carrying-v0", "BabyAI-KeyInBox-v0")
BOT_B, BOT_STEPS, BOT_SOLVE_FLOOR = 4, 240, 0.90
# B1 on the families' layouts: (env, sweeps), 1024 layouts each.
VI_FAMILIES = (
    ("MiniGrid-LavaGapS7-v0", 128),
    ("MiniGrid-LavaCrossingS9N2-v0", 128),
    ("MiniGrid-FourRooms-v0", 256),
)

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


def ptxas_report(logs) -> dict:
    """Registers, spills and shared memory of each kernel, from the
    ``-Xptxas -v`` output kept beside each built library: a map from the
    mangled kernel name to its "Used ..." line and spill line."""
    report, name = {}, None
    for log in logs:
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                report[name] = {}
            elif name and "bytes spill stores" in line:
                report[name]["spills"] = line.split(":", 1)[-1].strip()
            elif name and "Used" in line and "registers" in line:
                report[name]["used"] = line.split(":", 1)[-1].strip()
    return report


def compiled(report: dict, kernel: str) -> dict:
    """The ptxas lines of the one kernel whose mangled name holds
    ``kernel``; raises unless exactly one does."""
    hits = [v for k, v in report.items() if kernel in k]
    require(len(hits) == 1, f"one compiled kernel named {kernel}")
    return hits[0]


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


def check_dynamic_obstacles(ls, params, n_obs: int) -> torch.Tensor:
    """A (B,) bool per lane of a lane-major DynamicObstacles state: exactly
    ``n_obs`` blue balls, each named by its aux slots (2i, 2i+1), on n_obs
    distinct cells.  Stays on the card."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import COLOR_BLUE, OBJ_BALL

    w = params.width
    balls = ls.grid_obj == OBJ_BALL
    ok = (balls.sum(dim=0) == n_obs) & ((ls.grid_color == COLOR_BLUE) | ~balls).all(dim=0)
    cells = ls.aux[1:2 * n_obs:2] * w + ls.aux[0:2 * n_obs:2]  # (n_obs, B)
    ok &= balls.gather(0, cells.long()).all(dim=0)
    for i in range(n_obs):
        for j in range(i):
            ok &= cells[i] != cells[j]
    return ok


def replay_summary(L, params, final, resets) -> dict:
    """What the card-against-CPU check compares, as numpy: the final state
    of some lanes, their observation and their resets."""
    out = {n: getattr(final, n).cpu().numpy() for n in L._FIELDS}
    out["observation"] = L.obs_image_lanes(params, final).cpu().numpy()
    out["resets_per_env"] = resets.cpu().numpy()
    return out


def cpu_replay(env_id: str, pool: dict, acts: np.ndarray, rounds: int) -> dict:
    """A replay on the CPU, in a worker process: ``pool`` (numpy planes of a
    lane-major pool) stepped with ``acts``; returns ``replay_summary``."""
    torch.set_num_threads(1)
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    env = make(env_id)
    lanes, steps = acts.shape[1], acts.shape[0]
    sub = L.LaneState(**{n: torch.from_numpy(a) for n, a in pool.items()})
    res = L._lane_scan(env, None, sub, lanes, steps, "pool", rounds, torch.from_numpy(acts))
    return replay_summary(L, env.params, res.final_state, res.resets_per_env)


def family_rollouts(make, L, card: str, ids, runs: dict, seed: int, workers) -> dict:
    """Phases 6, 8 and 11: each id at its ``runs`` size (else FAMILY_OTHER);
    the card-against-CPU check of each id whose hooks draw nothing: the
    rollout's first CPU_LANES lanes, replayed on the CPU from the same pool
    with the same actions by ``workers`` (a process pool) while the card
    goes on to the next id, must end in the same state, observation and
    resets; the DynamicObstacles invariants; the attempts MultiRoom's and
    BabyAI's pooled generators accepted (MultiRoom's must cover its pool);
    the terminations that paid a reward (successes) and the others."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL

    dev = torch.device(DEVICE)
    out, pending = {}, []
    for k, env_id in enumerate(ids):
        env = make(env_id)
        B, T, R = runs.get(env_id, FAMILY_OTHER)
        pooled = env_id.startswith(("MiniGrid-MultiRoom", "BabyAI-"))
        g = gen(seed + k)
        g_again = torch.Generator(device=DEVICE).set_state(g.get_state())
        t0 = time.perf_counter()
        res = L.lane_rollout(env, g, B, T, pool_rounds=R, device=DEVICE)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        require(bool(torch.isfinite(res.total_reward)), f"{env_id}: finite total reward")
        if T > env.params.max_steps:
            require(int(res.resets_per_env.min()) >= 1, f"{env_id}: every lane reset")
        entry = {
            "B": B, "T": T, "pool_rounds": R, "s": s, "env_steps_per_s": B * T / s,
            "episodes": int(res.episodes), "successes": int(res.successes),
            "failures": int(res.failures), "total_reward": float(res.total_reward),
            "card": card,
        }
        # The same pool and the run's actions, drawn again from the
        # generator's state (hooks that draw nothing leave it alone).
        t0 = time.perf_counter()
        hooked = env.pre_step_lanes is not None or env.post_step_lanes is not None
        if pooled:
            flat, accepted = env.generate(g_again, env.params, R * B, DEVICE, return_accepted=True)
            pool = L.stack_rounds(flat, B, R)
            entry["accepted_attempts"] = int(accepted)
            if "MultiRoom" in env_id:
                require(int(accepted) >= R * B, f"{env_id}: {int(accepted)} attempts chained "
                        f"every room, at least the {R * B} layouts of the pool")
            del flat
        else:
            pool = L._lane_pool(env, g_again, B, "pool", R, dev)
        if hooked and env.hook_rng:
            n_obs = int((pool.grid_obj[0, :, 0] == OBJ_BALL).sum())
            require(bool(check_dynamic_obstacles(res.final_state, env.params, n_obs).all()),
                    f"{env_id}: the final state holds {n_obs} balls named by aux")
            entry["dyn_obs"] = dynamic_obstacles_steps(env, L, pool, n_obs, g_again)
        else:
            acts = torch.stack([
                torch.randint(0, env.action_dim, (B,), generator=g_again, device=dev,
                              dtype=torch.int32)
                for _ in range(T)
            ])[:, :CPU_LANES]
            final = L.LaneState(**{n: getattr(res.final_state, n)[..., :CPU_LANES] for n in L._FIELDS})
            on_card = replay_summary(L, env.params, final, res.resets_per_env[:CPU_LANES])
            sub = {n: getattr(pool, n)[..., :CPU_LANES].cpu().numpy() for n in L._FIELDS}
            pending.append((env_id, on_card, workers.submit(cpu_replay, env_id, sub, acts.cpu().numpy(), R)))
            entry["card_equals_cpu"] = {"lanes": CPU_LANES, "steps": T}
        entry["check_s"] = time.perf_counter() - t0
        print(
            f"[family] {env_id} B={B} T={T} pool={R}: {s:.3f} s, {B * T / s:.4g} env-steps/s "
            f"({card}); episodes {entry['episodes']} ({entry['successes']} successes, "
            f"{entry['failures']} failures); "
            + ("replayed" if "card_equals_cpu" in entry else f"dyn_obs {entry['dyn_obs']}")
            + (f"; {entry['accepted_attempts']} attempts accepted for {R * B} layouts"
               if "accepted_attempts" in entry else "")
            + f"; replay queued in {entry['check_s']:.3f} s",
            flush=True,
        )
        out[env_id] = entry
        del res, pool
    t0 = time.perf_counter()
    for env_id, on_card, job in pending:
        on_cpu = job.result()
        for n, want in on_cpu.items():
            require(np.array_equal(on_card[n], want), f"{env_id}: card and CPU agree on {n}")
    print(f"[family] {len(pending)} CPU replays equal to the card's; waited {time.perf_counter() - t0:.3f} s "
          "for the last ones", flush=True)
    return out


def dynamic_obstacles_steps(env, L, pool, n_obs: int, g) -> dict:
    """DYN_OBS_STEPS steps of ``step_lanes_env`` from pool round 0: after
    every step each lane keeps its balls (``check_dynamic_obstacles``) and
    every reward is 0, -1 or in (0, 1]."""
    ls = L.LaneState(**{n: getattr(pool, n)[0] for n in L._FIELDS})
    ok = torch.ones_like(ls.terminated)
    rewards_ok = torch.ones_like(ls.terminated)
    collisions = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for _ in range(DYN_OBS_STEPS):
        act = torch.randint(0, env.action_dim, ls.terminated.shape, generator=g,
                            device=DEVICE, dtype=torch.int32)
        ls, r, _ = L.step_lanes_env(env, ls, act, g)
        ok &= check_dynamic_obstacles(ls, env.params, n_obs)
        rewards_ok &= (r == 0) | (r == -1) | ((r > 0) & (r <= 1))
        collisions += (r == -1).sum()
    require(bool(ok.all()), f"{env.env_id}: {n_obs} balls named by aux after every step")
    require(bool(rewards_ok.all()), f"{env.env_id}: rewards are 0, -1 or in (0, 1]")
    require(int(collisions) > 0, f"{env.env_id}: some lane collided")
    return {"n_obs": n_obs, "steps": DYN_OBS_STEPS, "collisions": int(collisions)}


def greedy_optimal(env, states, vals, dists, act, T, L) -> dict:
    """Step a greedy policy with ``step_lanes_env``: ``vals`` and ``dists``
    are each start's value and steps to go, ``act(state)`` the policy's
    actions for a batch-first state.  On every layout whose start has V > 0
    and ``steps_to_go <= max_steps`` it must reach the goal (or pick up the
    target) in exactly ``steps_to_go`` steps with the closed-form return;
    the other layouts are counted."""
    p = env.params
    b = vals.shape[0]
    dev = vals.device
    solvable = (vals > 0) & (dists <= p.max_steps)
    require(bool(solvable.any()), f"{env.env_id}: some start reaches the goal in time")
    ls = L.to_lanes(states)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    steps = torch.zeros(b, dtype=torch.float32, device=dev)
    rew = torch.zeros(b, dtype=torch.float32, device=dev)
    for t in range(int(dists[solvable].max()) + 1):
        ls, r, term = L.step_lanes_env(env, ls, act(L.from_lanes(p, ls)))
        newly = term & ~done
        rew = torch.where(newly, r, rew)
        steps = torch.where(newly, float(t + 1), steps)
        done |= term
    want_r = T.env_return(vals, GAMMA, 0, p.max_steps)
    require(bool(done[solvable].all()), f"{env.env_id}: every solvable env terminated")
    require(bool((rew[solvable] > 0).all()), f"{env.env_id}: every solvable env reached the goal")
    require(torch.equal(steps[solvable], dists[solvable].to(steps.dtype)),
            f"{env.env_id}: each in exactly steps_to_go steps")
    r_err = float((rew - want_r)[solvable].abs().max())
    require(r_err <= RETURN_ATOL, f"{env.env_id}: returns within {RETURN_ATOL} of env_return")
    return {
        "layouts": b, "solved": int(solvable.sum()),
        "steps": [int(dists[solvable].min()), int(dists[solvable].max())],
        "return_err": r_err, "others": int((~solvable).sum()),
        "others_are": f"V = 0 or steps_to_go > max_steps = {p.max_steps}",
    }


def key_families(make, drive, kernel_row, ptxas) -> list:
    """Phase 9: B2 on the layouts of the families the key domain was
    written for, one part of the main path each."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_DOOR
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    out = []
    for seed, (env_id, doors) in enumerate(KEY_FAMILIES):
        fam = make(env_id)

        def path():
            states = fam.generate(gen(7 + seed), fam.params, KEY_FAMILY_B, device=DEVICE)
            most = int((states.grid_obj == OBJ_DOOR).sum(dim=(1, 2)).max())
            require(most <= doors, f"{env_id}: every layout has at most {doors} doors ({most})")
            layouts = TK.extract_key_layout(states, doors, states.aux[:, 0], states.aux[:, 1])
            return states, layouts, cuda_vi.cuda_key_value_iteration(
                layouts, GAMMA, KEY_FAMILY_SWEEPS
            )

        (states, layouts, v), counts = drive(f"key-domain VI, {env_id}, max_doors={doors}", path)
        _, K, C, _, h, w = v.shape
        route, n = cuda_vi.key_vi_route(K, C, h * w)
        require(counts["key_vi"] == 1 and counts[f"key_vi_{route}"] == 1,
                f"{env_id}: B2 launched once, on the {route} route")
        err = float((v - TK.key_vi_values(layouts, GAMMA, KEY_FAMILY_SWEEPS)).abs().max())
        require(err <= KEY_ATOL, f"B2 within {KEY_ATOL} of its plain version on {env_id}")
        policy = TK.key_greedy_policy(v, layouts, GAMMA)
        vals = TK.key_state_value(v, layouts, states)
        greedy = greedy_optimal(
            fam, states, vals, TK.key_steps_to_go(vals, GAMMA),
            lambda s: TK.key_greedy_action(policy, layouts, s), T, L,
        )
        entry = {"env": env_id, "max_doors": doors, "K": K, "C": C, "grid": f"{w}x{h}",
                 "route": route, "cluster": n, "max_abs_err": err, **greedy}
        print(f"[key_families] {entry}", flush=True)
        out.append(entry)
        del policy
        masks = cuda_vi.key_vi_masks(layouts)
        if route == "cluster":
            G = cuda_vi.key_vi_groups(h * w)
            design = dict(
                design="V split by key row over a thread-block cluster's shared memory; "
                "grid size given at run time",
                cluster=n, groups=G, threads_per_cta=G * h * w,
                active_clusters=cuda_vi.key_vi_active_clusters(C, h, w, n),
                shared_bytes=cuda_vi.key_vi_cluster_shared_bytes(C, h * w, n),
                compiled=compiled(ptxas, "key_vi_cluster_kernelILi0ELi0E"),
            )
        else:
            design = dict(
                design="V double-buffered in device memory, one block per layout",
                cluster=None, active_clusters=None, shared_bytes=(C + 2) * 4 * h * w,
                compiled=compiled(ptxas, "key_vi_global_kernel"),
            )
        kernel_row(
            f"key_vi_{env_id.removeprefix('MiniGrid-').removesuffix('-v0')}",
            f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts["key_vi"], err,
            lambda: cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY_FAMILY_SWEEPS),
            lambda: cuda_vi._key_vi_kernel(masks, GAMMA, KEY_FAMILY_SWEEPS, v.shape),
            lambda: TK.key_vi_values(layouts, GAMMA, KEY_FAMILY_SWEEPS),
            cuda_vi.key_vi_work(layouts, KEY_FAMILY_SWEEPS), reps=5,
            kernel_route=route, route_launches={r: counts[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
            shape=f"{KEY_FAMILY_B} layouts {w}x{h}, {KEY_FAMILY_SWEEPS} sweeps, "
            f"max_doors {doors} (K={K}, C={C})",
            **design,
        )
        del states, layouts, v, masks
    return out


def box_target(states):
    """(type, color) of each layout's first box in raster order, as the JAX
    bench picks BlockedUnlockPickup's target (bench.py:197-203)."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BOX

    b = states.grid_obj.shape[0]
    flat = (states.grid_obj == OBJ_BOX).reshape(b, -1).to(torch.int8).argmax(dim=1)
    color = states.grid_color.reshape(b, -1).gather(1, flat[:, None])[:, 0]
    return torch.full_like(color, OBJ_BOX, dtype=torch.int32), color.to(torch.int32)


def obstructed_families(make) -> list:
    """Phase 10: the obstructed domain on the card, its greedy policy
    stepped, its V held against the CPU's on the first layouts."""
    import dataclasses

    from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_obstructed as TO
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    out = []
    for seed, env_id in enumerate(OBSTRUCTED):
        fam = make(env_id)
        states = fam.generate(gen(9 + seed), fam.params, OBS_B, device=DEVICE)
        if "BlockedUnlockPickup" in env_id:
            t_type, t_color = box_target(states)
        else:
            t_type, t_color = states.aux[:, 0], states.aux[:, 1]
        layouts = TO.extract_obstructed_layout(states, 1, t_type, t_color)
        hw = layouts.base_walk[0].numel()
        require(bool((layouts.target_pos >= 0).all() & (layouts.ball0 < hw).all()),
                f"{env_id}: every layout has its target and a movable ball")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        v, policy = TO.obstructed_value_iteration(layouts, GAMMA, OBS_SWEEPS)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        vals = TO.obstructed_state_value(v, layouts, states)
        greedy = greedy_optimal(
            fam, states, vals, TO.obstructed_steps_to_go(vals, GAMMA),
            lambda st: TO.obstructed_greedy_action(policy, layouts, st), T, L,
        )
        del v, policy
        # The card against the CPU, on the first layouts at a few sweeps.
        head = {f.name: getattr(layouts, f.name)[:OBS_CPU_LAYOUTS]
                for f in dataclasses.fields(layouts)}
        v_card = TO.obstructed_vi_values(TO.ObstructedLayout(**head), GAMMA, OBS_CPU_SWEEPS)
        v_cpu = TO.obstructed_vi_values(
            TO.ObstructedLayout(**{k: t.cpu() for k, t in head.items()}), GAMMA, OBS_CPU_SWEEPS
        )
        cpu_err = float((v_card.cpu() - v_cpu).abs().max())
        require(cpu_err <= KEY_ATOL,
                f"{env_id}: the obstructed V on the card within {KEY_ATOL} of the CPU's")
        require(bool((v_cpu > 0).any()),
                f"{env_id}: some obstructed state pays within {OBS_CPU_SWEEPS} sweeps")
        entry = {
            "env": env_id, "layouts": OBS_B, "sweeps": OBS_SWEEPS, "s": s,
            "layout_sweeps_per_s": OBS_B * OBS_SWEEPS / s,
            "v_bytes_per_layout": v_cpu[0].numel() * 4, "peak_bytes": peak,
            "bytes_before": base, "card_vs_cpu_err": cpu_err, **greedy,
        }
        print(f"[obstructed] {entry}", flush=True)
        out.append(entry)
        del states, layouts, v_card, v_cpu
    return out


def twokey_domain(make) -> dict:
    """Phase 12: the two-key domain on the card on UnlockToUnlock layouts,
    the target the one ball; its greedy policy stepped with the verifier;
    its V held against the CPU's on the first layouts."""
    import dataclasses

    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_twokey as TT
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    env = make(TWOKEY_ENV)
    states = env.generate(gen(11), env.params, TWOKEY_B, device=DEVICE)
    balls = (states.grid_obj == OBJ_BALL).reshape(TWOKEY_B, -1)
    require(bool((balls.sum(dim=1) == 1).all()), f"{TWOKEY_ENV}: one ball a layout")
    color = states.grid_color.reshape(TWOKEY_B, -1).gather(1, balls.to(torch.int8).argmax(1, True))[:, 0]
    layouts = TT.extract_twokey_layout(states, 2, OBJ_BALL, color)
    hw = layouts.base_walk[0].numel()
    require(bool(((layouts.key0 >= 0) & (layouts.key0 < hw)).all()), "two keys on the grid")
    require(bool((layouts.door_unlockable.sum(dim=2) == 1).all()), "each key opens one door")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v, policy = TT.twokey_value_iteration(layouts, GAMMA, TWOKEY_SWEEPS)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    vals = TT.twokey_state_value(v, layouts, states)
    dists = TT.twokey_steps_to_go(vals, GAMMA)
    require(bool(torch.isfinite(dists).all()),
            f"{TWOKEY_ENV}: every start reaches the ball within {TWOKEY_SWEEPS} sweeps")
    greedy = greedy_optimal(
        env, states, vals, dists, lambda st: TT.twokey_greedy_action(policy, layouts, st), T, L,
    )
    require(greedy["solved"] == TWOKEY_B, f"{TWOKEY_ENV}: the greedy policy solves every layout")
    v_bytes = v[0].numel() * 4
    del v, policy
    # The card against the CPU, on the first layouts at a few sweeps.
    head = {f.name: getattr(layouts, f.name)[:TWOKEY_CPU_LAYOUTS] for f in dataclasses.fields(layouts)}
    v_card = TT.twokey_vi_values(TT.TwoKeyLayout(**head), GAMMA, TWOKEY_CPU_SWEEPS)
    t0 = time.perf_counter()
    v_cpu = TT.twokey_vi_values(
        TT.TwoKeyLayout(**{k: t.cpu() for k, t in head.items()}), GAMMA, TWOKEY_CPU_SWEEPS
    )
    cpu_s = time.perf_counter() - t0
    cpu_err = float((v_card.cpu() - v_cpu).abs().max())
    require(cpu_err <= KEY_ATOL, f"{TWOKEY_ENV}: the two-key V on the card within {KEY_ATOL} of the CPU's")
    require(bool((v_cpu > 0).any()), f"{TWOKEY_ENV}: some state pays within {TWOKEY_CPU_SWEEPS} sweeps")
    entry = {
        "env": TWOKEY_ENV, "layouts": TWOKEY_B, "sweeps": TWOKEY_SWEEPS, "s": s,
        "layout_sweeps_per_s": TWOKEY_B * TWOKEY_SWEEPS / s, "v_bytes_per_layout": v_bytes,
        "peak_bytes": peak, "bytes_before": base, "card_vs_cpu_err": cpu_err,
        "card_vs_cpu": {"layouts": TWOKEY_CPU_LAYOUTS, "sweeps": TWOKEY_CPU_SWEEPS, "cpu_s": cpu_s},
        **greedy,
    }
    print(f"[twokey] {entry}", flush=True)
    return entry


def state_numpy(state) -> dict:
    import dataclasses

    return {f.name: getattr(state, f.name).cpu().numpy() for f in dataclasses.fields(state)}


def env_api_steps(env, state, acts, generator=None) -> dict:
    """``env.step`` with each row of ``acts``: every step's observation,
    reward and flags, and the final state, as numpy."""
    dev = state.agent_dir.device
    out = {"image": [], "direction": [], "mission": [], "reward": [], "terminated": [],
           "truncated": []}
    for act in acts:
        obs, state, rew, term, trunc, _ = env.step(state, torch.from_numpy(act).to(dev), generator)
        for k, v in (*obs.items(), ("reward", rew), ("terminated", term), ("truncated", trunc)):
            out[k].append(v)
    steps = {k: torch.stack(v).cpu().numpy() for k, v in out.items()}
    steps.update({f"state.{k}": v for k, v in state_numpy(state).items()})
    return steps


def cpu_env_api(env_id: str, state: dict, acts: np.ndarray) -> dict:
    """The CPU half of phase 13, in a worker process: the observation of
    the numpy ``state`` ("reset.<key>") and ``env_api_steps`` from it."""
    torch.set_num_threads(1)
    from minigrid_dynamicprogramming_tpu_torch import EnvState, make

    env = make(env_id)
    state = EnvState(**{k: torch.from_numpy(v) for k, v in state.items()})
    out = {f"reset.{k}": v.numpy() for k, v in env.observation(state).items()}
    return {**out, **env_api_steps(env, state, acts)}


def env_api(make, workers) -> dict:
    """Phase 13: the batch-first ``Environment`` methods on the card
    against the same calls on the CPU."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    out, pending = {}, []
    rng = np.random.default_rng(13)
    runs = [(i, ENV_API_B, ENV_API_STEPS) for i in ENV_API_IDS]
    runs.append((ENV_API_IDS[0], 1, ENV_API_SINGLE_STEPS))
    for k, (env_id, b, steps) in enumerate(runs):
        env = make(env_id)
        obs, state = env.reset(gen(400 + k), b, device=DEVICE)
        require(obs["image"].shape == (b, 7, 7, 3) and obs["image"].device.type == torch.device(DEVICE).type,
                f"{env_id}: reset's observation on the card")
        acts = rng.choice(7, size=(steps, b), p=ENV_API_ACTION_P).astype(np.int32)
        job = workers.submit(cpu_env_api, env_id, state_numpy(state), acts)
        t0 = time.perf_counter()
        on_card = env_api_steps(env, state, acts)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        on_card.update({f"reset.{k2}": v.cpu().numpy() for k2, v in obs.items()})
        name = f"{env_id} B={b}"
        out[name] = {
            "B": b, "steps": steps, "s": s, "env_steps_per_s": b * steps / s,
            "terminated": int(on_card["terminated"].sum()), "truncated": int(on_card["truncated"].sum()),
            "rewards": float(on_card["reward"].sum()),
        }
        pending.append((name, on_card, job))
    require(sum(e["terminated"] for e in out.values()) > 0, "some env terminated")
    for name, on_card, job in pending:
        on_cpu = job.result()
        require(set(on_cpu) == set(on_card), f"{name}: card and CPU return the same fields")
        for field, want in on_cpu.items():
            if field == "reward":
                err = float(np.abs(on_card[field] - want).max())
                out[name]["reward_card_vs_cpu_err"] = err
                require(err <= RETURN_ATOL, f"{name}: card and CPU rewards within {RETURN_ATOL}")
            else:
                require(np.array_equal(on_card[field], want), f"{name}: card and CPU agree on {field}")
        print(f"[env_api] {name}, card equal to CPU: {out[name]}", flush=True)

    # DynamicObstacles: the hook draws from the generator passed to step.
    env = make(ENV_API_DYN)
    g = gen(430)
    obs, state = env.reset(g, ENV_API_B, device=DEVICE)
    n_obs = int((state.grid_obj[0] == OBJ_BALL).sum())
    try:
        env.step(state, torch.zeros(ENV_API_B, dtype=torch.int32, device=DEVICE))
        raise RuntimeError(f"check failed: {ENV_API_DYN}: step without a generator must raise")
    except ValueError:
        pass
    collisions = 0
    for _ in range(ENV_API_STEPS):
        act = torch.from_numpy(rng.choice(7, size=ENV_API_B, p=ENV_API_ACTION_P).astype(np.int32))
        obs, state, rew, term, trunc, _ = env.step(state, act.to(DEVICE), g)
        require(bool(check_dynamic_obstacles(L.to_lanes(state), env.params, n_obs).all()),
                f"{ENV_API_DYN}: {n_obs} balls named by aux after every step")
        require(bool(((rew == 0) | (rew == -1) | ((rew > 0) & (rew <= 1))).all()),
                f"{ENV_API_DYN}: rewards are 0, -1 or in (0, 1]")
        collisions += int((rew == -1).sum())
    require(collisions > 0, f"{ENV_API_DYN}: some env collided")
    out[ENV_API_DYN] = {"B": ENV_API_B, "steps": ENV_API_STEPS, "n_obs": n_obs, "collisions": collisions}
    print(f"[env_api] {ENV_API_DYN}: {out[ENV_API_DYN]}", flush=True)
    return out


def ppo_throughput(make, card: str) -> dict:
    """Phase 14: the full update's env-steps/s on GoToDoor, and the rollout
    / learner split, the rollout timed by a zero-epoch update."""
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    env = make(PPO_ENV)

    def timed(epochs: int) -> list:
        cfg = PPOConfig(num_envs=PPO_B, rollout_len=PPO_T, epochs=epochs, num_minibatches=PPO_MB)
        ppo = PPO(env, cfg, device=DEVICE)
        ts = ppo.init(3)
        for _ in range(PPO_WARMUP):
            ts, m = ppo.update(ts)
        torch.cuda.synchronize()
        times = []
        for _ in range(PPO_TIMED):
            t0 = time.perf_counter()
            ts, m = ppo.update(ts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        finite = [float(x) for x in m]
        if epochs:
            require(all(np.isfinite(finite)), f"{PPO_ENV}: finite update metrics {finite}")
        return times

    torch.cuda.reset_peak_memory_stats()
    full = timed(2)
    peak = torch.cuda.max_memory_allocated()
    roll = timed(0)
    steps = PPO_B * PPO_T
    out = {
        "env": PPO_ENV, "num_envs": PPO_B, "rollout_len": PPO_T, "epochs": 2,
        "num_minibatches": PPO_MB, "update_s": full, "rollout_s": roll,
        "env_steps_per_s": steps / statistics.mean(full),
        "rollout_mean_s": statistics.mean(roll),
        "learner_mean_s": statistics.mean(full) - statistics.mean(roll),
        "peak_bytes": peak, "card": card,
    }
    print(f"[ppo_throughput] {out}", flush=True)
    return out


def ppo_learning(make, env_id: str) -> dict:
    """Phase 15: train until the mean return holds LEARN_THRESHOLD over at
    least LEARN_MIN_EPISODES episodes for LEARN_PATIENCE updates in a row."""
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    cfg = PPOConfig(num_envs=LEARN_B, rollout_len=LEARN_T, epochs=2, num_minibatches=LEARN_MB)
    ppo = PPO(make(env_id), cfg, device=DEVICE)
    ts = ppo.init(0)
    curve, hits, solved_at = [], 0, None
    t0 = time.perf_counter()
    for u in range(LEARN_MAX_UPDATES):
        ts, m = ppo.update(ts)
        ret, eps = float(m.mean_return), int(m.episodes)
        curve.append({"update": u + 1, "mean_return": ret, "episodes": eps,
                      "entropy": float(m.entropy), "s": time.perf_counter() - t0})
        hits = hits + 1 if ret >= LEARN_THRESHOLD and eps >= LEARN_MIN_EPISODES else 0
        if hits >= LEARN_PATIENCE:
            solved_at = u + 1
            break
    out = {"env": env_id, "solved_at": solved_at, "s": time.perf_counter() - t0, "curve": curve}
    print(f"[ppo_learning] {env_id}: solved at update {solved_at} in {out['s']:.1f} s; curve "
          + " ".join(f"{c['update']}:{c['mean_return']:.4f}/{c['episodes']}" for c in curve), flush=True)
    require(solved_at is not None, f"{env_id}: mean return >= {LEARN_THRESHOLD} over >= "
            f"{LEARN_MIN_EPISODES} episodes for {LEARN_PATIENCE} updates within {LEARN_MAX_UPDATES}")
    return out


def tree_to(x, device):
    """A copy of ``x`` (tensor, dict, ``EnvState`` or ``WrapperState``,
    nested) on ``device``."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: tree_to(getattr(x, f.name), device) for f in dataclasses.fields(x)})
    return x


def tree_equal(card, cpu, what: str, close=None) -> None:
    """``card`` equal to ``cpu`` bit for bit (NaN equal to NaN, dtypes
    equal), but for the fields named in ``close``, each held within its
    tolerance."""
    import dataclasses

    close = close or {}
    if isinstance(cpu, torch.Tensor):
        atol = close.get(what.rsplit(" ", 1)[-1], 0.0)
        try:
            torch.testing.assert_close(card.cpu(), cpu.cpu(), rtol=0, atol=atol, equal_nan=True)
        except AssertionError as e:
            raise RuntimeError(f"check failed: {what}: card and CPU within {atol}: {e}") from None
    elif isinstance(cpu, dict):
        require(set(card) == set(cpu), f"{what}: same keys")
        for k in cpu:
            tree_equal(card[k], cpu[k], f"{what} {k}", close)
    elif dataclasses.is_dataclass(cpu):
        for f in dataclasses.fields(cpu):
            tree_equal(getattr(card, f.name), getattr(cpu, f.name), f"{what} {f.name}", close)
    else:
        require(card == cpu, f"{what}: equal")


def peak_after(fn):
    """(fn's result, the peak bytes it allocated above what was allocated
    before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def render_part(make, card: str, name: str, b: int, render, tile: int) -> dict:
    """One render function on ``b`` DoorKey-8x8 states two steps into
    their episodes: time, frames/s, peak memory and bound, and the first
    RENDER_CPU_B frames against the CPU's."""
    env = make(ENV_ID)
    g = gen(500)
    _, state = env.reset(g, b, device=DEVICE)
    for _ in range(2):
        act = torch.randint(0, 7, (b,), generator=g, device=DEVICE)
        state = env.step(state, act)[1]
    frames, peak = peak_after(lambda: render(env.params, state, tile))
    ms = cuda_ms(lambda: render(env.params, state, tile), reps=5)
    lut = tile * tile * 3 * 1980
    planes = 3 * state.grid_obj.numel() + 4 * (state.agent_pos.numel() + state.agent_dir.numel())
    bound_ms, bound_by = bound(frames.numel() + planes + lut, 0)
    small = tree_to(state, "cpu")
    small = type(small)(**{k: v[:RENDER_CPU_B] for k, v in small.__dict__.items()})
    require(torch.equal(frames[:RENDER_CPU_B].cpu(), render(env.params, small, tile)),
            f"{name}: card frames equal to the CPU's")
    require(frames.dtype == torch.uint8 and frames.shape[0] == b, f"{name}: (B, H, W, 3) uint8")
    out = {
        "env": ENV_ID, "B": b, "tile": tile, "shape": list(frames.shape), "frame_bytes": frames.numel(),
        "ms": ms, "frames_per_s": b / (ms / 1e3), "bound_ms": bound_ms, "bound_by": bound_by,
        "peak_bytes": peak, "card": card,
    }
    print(f"[{name}] {out}", flush=True)
    return out


def pixel_steps(make, card: str, env_id: str) -> dict:
    """ImgObs(RGBImgPartialObs(env, 8)) at PIXEL_B for PIXEL_T batch-first
    steps of seeded random actions: env-steps/s and peak memory."""
    from minigrid_dynamicprogramming_tpu_torch import wrappers as W

    env = W.ImgObsWrapper(W.RGBImgPartialObsWrapper(make(env_id), POV_TILE))
    g = gen(510)
    obs, state = env.reset(g, PIXEL_B, device=DEVICE)
    acts = torch.randint(0, 7, (PIXEL_T + 1, PIXEL_B), generator=g, device=DEVICE)
    obs, state, *_ = env.step(state, acts[0], g)  # warm-up

    def run():
        nonlocal obs, state
        for t in range(1, PIXEL_T + 1):
            obs, state, *_ = env.step(state, acts[t], g)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, peak = peak_after(run)
    s = time.perf_counter() - t0
    v = make(env_id).params.agent_view_size * POV_TILE
    require(obs.shape == (PIXEL_B, v, v, 3) and obs.dtype == torch.uint8, f"{env_id}: pixel observation")
    out = {"env": env_id, "B": PIXEL_B, "T": PIXEL_T, "s": s, "ms_per_step": 1e3 * s / PIXEL_T,
           "env_steps_per_s": PIXEL_B * PIXEL_T / s, "peak_bytes": peak, "obs_shape": list(obs.shape),
           "card": card}
    print(f"[pixel_step] {out}", flush=True)
    return out


class _Record:
    """Wraps an env and remembers the action it was stepped with (the
    StochasticActionWrapper's replacements, seen from below)."""

    def __init__(self, env):
        self.env, self.params, self.action_dim = env, env.params, env.action_dim
        self.seen = []

    def reset(self, *args, **kwargs):
        return self.env.reset(*args, **kwargs)

    def step(self, state, action, generator=None):
        self.seen.append(action)
        return self.env.step(state, action, generator)


def wrapper_suite(make, card: str) -> dict:
    """Each of the 15 wrappers at WRAP_B for WRAP_T steps: the deterministic
    ones card against CPU at every step (observations, flags, states and
    count tables bit for bit, rewards within RETURN_ATOL, "angle" of
    DirectionObsWrapper within 1e-6 since arctan may differ in the last
    ulp); StochasticActionWrapper and ReseedWrapper by their invariants.
    Each prints the card's ms a step, env-steps/s and peak memory."""
    from minigrid_dynamicprogramming_tpu_torch import wrappers as W

    dk, lava, local = make(ENV_ID), make("MiniGrid-LavaCrossingS9N1-v0"), make("BabyAI-GoToLocal-v0")
    deterministic = {
        "ActionBonus": W.ActionBonus(dk),
        "PositionBonus": W.PositionBonus(dk),
        "ImgObsWrapper": W.ImgObsWrapper(dk),
        "OneHotPartialObsWrapper": W.OneHotPartialObsWrapper(dk),
        "RGBImgObsWrapper": W.RGBImgObsWrapper(dk, 8),
        "RGBImgPartialObsWrapper": W.RGBImgPartialObsWrapper(dk, 8),
        "FullyObsWrapper": W.FullyObsWrapper(dk),
        "DictObservationSpaceWrapper": W.DictObservationSpaceWrapper(local),
        "FlatObsWrapper": W.FlatObsWrapper(local),
        "ViewSizeWrapper": W.ViewSizeWrapper(dk, 9),
        "DirectionObsWrapper slope": W.DirectionObsWrapper(dk, type="slope"),
        "DirectionObsWrapper angle": W.DirectionObsWrapper(dk, type="angle"),
        "SymbolicObsWrapper": W.SymbolicObsWrapper(dk),
        "NoDeath": W.NoDeath(lava, no_death_types=("lava",), death_cost=-1.0),
    }
    rng = np.random.default_rng(16)
    out = {}
    for k, (name, w) in enumerate(deterministic.items()):
        obs, on_card = w.reset(gen(520 + k), WRAP_B, device=DEVICE)
        cpu = tree_to(on_card, "cpu")
        close = {"goal_direction": 1e-6} if name.endswith("angle") else {}
        cpu_obs = w.unwrapped.observation(W.core_state(cpu))
        if isinstance(w, W.ObservationWrapper):
            cpu_obs = w.observation(cpu_obs, cpu)
        tree_equal(obs, cpu_obs, f"{name} reset", close)
        card_s, rewards, negative = 0.0, 0.0, 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for t in range(WRAP_T):
            act = torch.from_numpy(rng.choice(7, size=WRAP_B, p=ENV_API_ACTION_P).astype(np.int32))
            t0 = time.perf_counter()
            c_out = w.step(on_card, act.to(DEVICE))
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t0
            p_out = w.step(cpu, act)
            on_card, cpu = c_out[1], p_out[1]
            what = f"{name} t={t}"
            tree_equal(c_out[0], p_out[0], f"{what} obs", close)
            tree_equal(c_out[2], p_out[2], f"{what} reward", {"reward": RETURN_ATOL})
            tree_equal(c_out[3], p_out[3], f"{what} terminated")
            tree_equal(c_out[4], p_out[4], f"{what} truncated")
            tree_equal(on_card, cpu, f"{what} state")
            rewards += float(c_out[2].sum())
            negative += int((c_out[2] < 0).sum())
        out[name] = {"steps": WRAP_T, "B": WRAP_B, "ms_per_step": 1e3 * card_s / WRAP_T,
                     "env_steps_per_s": WRAP_B * WRAP_T / card_s,
                     "peak_bytes": torch.cuda.max_memory_allocated() - base, "rewards": rewards,
                     "negative_rewards": negative, "card_equals_cpu": True, "card": card}
        print(f"[wrapper] {name}: card equal to CPU at every step; {out[name]}", flush=True)
    require(out["NoDeath"]["negative_rewards"] > 0, "NoDeath paid death costs")

    # StochasticActionWrapper: prob=1.0 is the bare step; at 0.5 done (6) is
    # replaced in half the envs by a draw over 0..5.
    obs, state = dk.reset(gen(540), WRAP_B, device=DEVICE)
    g = gen(541)
    act = torch.randint(0, 7, (WRAP_B,), generator=g, device=DEVICE)
    tree_equal(W.StochasticActionWrapper(dk, prob=1.0).step(state, act, g)[0], dk.step(state, act)[0],
               "StochasticActionWrapper prob=1.0")
    rec = _Record(dk)
    w = W.StochasticActionWrapper(rec, prob=0.5)
    for _ in range(WRAP_T):
        state = w.step(state, 6, g)[1]
    seen = torch.cat(rec.seen).cpu().numpy()
    share = float((seen != 6).mean())
    sigma = (0.25 / seen.size) ** 0.5
    require(abs(share - 0.5) <= 4 * sigma, f"StochasticActionWrapper replaced share {share} within 4 sigma of 0.5")
    require(set(np.unique(seen[seen != 6]).tolist()) == set(range(6)), "replacements cover 0..5 and never 6")
    out["StochasticActionWrapper"] = {"draws": int(seen.size), "replaced_share": share, "sigma": sigma}

    # ReseedWrapper: two seeds cycle, so resets 1 and 3 are equal.
    w = W.ReseedWrapper(dk, seeds=[7, 9])
    (o1, s1), (_, s2), (o3, s3) = [w.reset(batch_size=WRAP_B, device=DEVICE) for _ in range(3)]
    require(torch.equal(s1.grid_obj, s3.grid_obj) and torch.equal(o1["image"], o3["image"]),
            "ReseedWrapper: resets 1 and 3 equal")
    require(not torch.equal(s1.grid_obj, s2.grid_obj), "ReseedWrapper: resets 1 and 2 differ")
    out["ReseedWrapper"] = {"cycle": [7, 9, 7], "B": WRAP_B}
    require(len(out) == 16, f"all 15 wrappers ran ({sorted(out)})")
    print(f"[wrapper] StochasticActionWrapper: prob=1.0 is the bare step; {out['StochasticActionWrapper']}; "
          f"ReseedWrapper cycles; {card}", flush=True)
    return out


def render_and_wrappers(make, card: str) -> dict:
    """Phase 16: the renderer, the pixel observation and the 15 wrappers on
    the card."""
    from minigrid_dynamicprogramming_tpu_torch.render import render_frame, render_pov

    return {
        "render_frame": render_part(make, card, "render_frame", RENDER_B, render_frame, RENDER_TILE),
        "render_pov": render_part(make, card, "render_pov", POV_B, render_pov, POV_TILE),
        "pixel_step": [pixel_steps(make, card, env_id) for env_id in PIXEL_IDS],
        "wrappers": wrapper_suite(make, card),
    }


def bot_solves(make, ids, card: str) -> dict:
    """Phase 17: BOT_B bots per id over one batch-first ``step`` on the
    card, up to BOT_STEPS steps; one more batch where none solved."""
    from minigrid_dynamicprogramming_tpu_torch.utils.babyai_bot import run_bots

    per_id, episodes, solved = {}, 0, 0
    t0 = time.perf_counter()
    for k, env_id in enumerate(ids):
        env = make(env_id)
        runs = []
        for extra in range(2):
            _, state = env.reset(gen(700 + 2 * k + extra), BOT_B, device=DEVICE)
            runs.append(run_bots(env, state, BOT_STEPS))
            if runs[-1].solved.any():
                break
        n_solved = sum(int(r.solved.sum()) for r in runs)
        require(all((r.reward[r.solved] > 0).all() for r in runs), f"{env_id}: solved episodes pay")
        per_id[env_id] = {
            "episodes": BOT_B * len(runs), "solved": n_solved,
            "steps": [int(x) for r in runs for x in r.steps],
            "errors": [e for r in runs for e in r.errors if e],
        }
        episodes += BOT_B * len(runs)
        solved += n_solved
    s = time.perf_counter() - t0
    share = solved / episodes
    out = {"ids": len(ids), "episodes": episodes, "solved": solved, "share": share, "s": s,
           "episodes_per_s": episodes / s, "per_id": per_id, "card": card}
    print(f"[bot] {card}: {len(ids)} ids, {solved}/{episodes} episodes solved (share {share:.4f}), "
          f"{episodes / s:.3f} episodes/s, {s:.1f} s; per id "
          + " ".join(f"{i.removeprefix('BabyAI-')}:{e['solved']}/{e['episodes']}" for i, e in per_id.items()),
          flush=True)
    unsolved = [i for i, e in per_id.items() if e["solved"] == 0]
    require(not unsolved, f"every id solved at least once (not {unsolved})")
    require(share >= BOT_SOLVE_FLOOR, f"solve share {share:.4f} >= {BOT_SOLVE_FLOOR}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON to this file")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    try:
        import minigrid_dynamicprogramming_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    # Processes for the CPU halves of the card-against-CPU replays; the
    # block ends them, whatever the run's outcome.
    with ProcessPoolExecutor(REPLAY_WORKERS, mp_context=multiprocessing.get_context("spawn")) as workers:
        return run(args, t_start, workers)


def run(args, t_start: float, workers) -> int:
    from minigrid_dynamicprogramming_tpu_torch import _kernels, make, registered_ids
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    counters = {"vi": cuda_vi.cuda_value_iteration, "key_vi": cuda_vi.cuda_key_value_iteration}
    key_routes = cuda_vi.cuda_key_value_iteration.route_launches

    def drive(part, fn):
        """Run one part of the main path with every launch count set to 0
        just before it; returns (fn's result, the counts just after), the
        key-domain kernel's split by route as "key_vi_<route>"."""
        for c in counters.values():
            c.launches = 0
        for r in key_routes:
            key_routes[r] = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: c.launches for name, c in counters.items()}
        counts.update({f"key_vi_{r}": n for r, n in key_routes.items()})
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
    ptxas = ptxas_report(p.with_suffix(".log") for p in libs.values())
    for name, lines in sorted(ptxas.items()):
        print(f"[ptxas] {name}: {lines.get('used')}; {lines.get('spills')}", flush=True)
    results["ptxas"] = ptxas

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

    def kernel_row(name, source, replaces, launches, err, call, kernel_only, plain, work, reps, **design):
        ms = cuda_ms(call, reps)
        kernel_ms = cuda_ms(kernel_only, reps)
        plain_ms = cuda_ms(plain, 2, warmup=0)  # each phase ran it once already, for err
        bound_ms, bound_by = bound(*work)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_only_ms": kernel_ms, **design,
        }
        print(
            f"[{name}] max|kernel - plain| {err:.3g}; kernel {ms:.4f} ms "
            f"(the launch alone {kernel_ms:.4f} ms), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}; main-path launches {launches}; "
            f"{json.dumps(design)}",
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
        C, D = v.shape[1], layouts.n_doors
        lpb, G = cuda_vi.vi_plan(C, D, h * w)
        kernel_row(
            f"vi_max_doors{doors}", f"{CSRC}/vi.cu", f"{PALLAS_VI}:201", counts["vi"], err,
            lambda: cuda_vi.cuda_value_iteration(layouts, GAMMA, VI_SWEEPS),
            lambda: cuda_vi._vi_kernel(masks, GAMMA, VI_SWEEPS, v.shape),
            lambda: T.vi_values(layouts, GAMMA, VI_SWEEPS),
            cuda_vi.vi_work(layouts, VI_SWEEPS), reps=10,
            design="a thread per (cell, config group) with its 4 directions and per-cell data "
            "in registers; V in shared memory",
            kernel_route="shared", route_launches={"shared": counts["vi"]},
            layouts_per_block=lpb, config_groups=G, threads_per_block=lpb * G * h * w,
            walk_bits=cuda_vi.vi_walk_bits(C),
            shared_bytes=cuda_vi.vi_shared_bytes(C, D, h * w, lpb),
            compiled=compiled(ptxas, f"vi_kernelILi{cuda_vi.vi_walk_bits(C)}ELi{h}ELi{w}E"),
        )
        del v_plain
    require(torch.equal(solved[1][0].grid_obj, solved[2][0].grid_obj), "same layouts at both budgets")
    results["vi_many_doors"] = []
    for env_id, doors in VI_MANY_DOORS:
        e = make(env_id)
        lay = T.extract_layout(e.generate(gen(5), e.params, VI_B, device=DEVICE), doors)
        got = cuda_vi.cuda_value_iteration(lay, GAMMA, VI_SWEEPS)
        C = got.shape[1]
        err = float((got - T.vi_values(lay, GAMMA, VI_SWEEPS)).abs().max())
        require(err == 0.0, f"B1 equals its plain version on {env_id} at max_doors={doors}")
        require(bool((got > 0).any()), "some state reaches the goal")
        hw = e.params.height * e.params.width
        entry = {
            "env": env_id, "max_doors": doors, "C": C, "layouts": VI_B, "sweeps": VI_SWEEPS,
            "walk_bits": cuda_vi.vi_walk_bits(C), "plan": cuda_vi.vi_plan(C, doors, hw),
            "max_abs_err": err,
        }
        print(f"[vi_many_doors] {entry}", flush=True)
        results["vi_many_doors"].append(entry)
        del got, lay

    # 4. B2 on the key-position domain: the cluster route at 8x8, then the
    # global route at 16x16.
    def key_path():
        states = env.generate(gen(3), env.params, KEY_B, device=DEVICE)
        layouts = TK.extract_key_layout(states, max_doors=1)
        return layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY_SWEEPS)

    (key_layouts, kv), counts = drive("key-domain VI, DoorKey-8x8", key_path)
    require(counts["key_vi"] == 1, "the B2 kernel launched once")
    require(counts["key_vi_cluster"] == 1, "B2 took the cluster route at DoorKey-8x8")
    kv_plain = TK.key_vi_values(key_layouts, GAMMA, KEY_SWEEPS)
    err = float((kv - kv_plain).abs().max())
    require(err <= KEY_ATOL, f"B2 within {KEY_ATOL} of its plain version")
    require(bool((kv > 0).any()), "some key-domain state reaches the goal")
    key_masks = cuda_vi.key_vi_masks(key_layouts)
    _, K, C, _, _, _ = kv.shape
    route, n = cuda_vi.key_vi_route(K, C, h * w)
    require(route == "cluster", "the 8x8 shape's route is the cluster")
    kv_global = cuda_vi._key_vi_kernel_global(key_masks, GAMMA, KEY_SWEEPS, kv.shape)
    err_global = float((kv_global - kv_plain).abs().max())
    require(err_global <= KEY_ATOL, f"B2's global route within {KEY_ATOL} at 8x8")
    del kv_plain, kv_global
    G = cuda_vi.key_vi_groups(h * w)
    key_work = cuda_vi.key_vi_work(key_layouts, KEY_SWEEPS)
    kernel_row(
        "key_vi", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts["key_vi"], err,
        lambda: cuda_vi.cuda_key_value_iteration(key_layouts, GAMMA, KEY_SWEEPS),
        lambda: cuda_vi._key_vi_kernel(key_masks, GAMMA, KEY_SWEEPS, kv.shape),
        lambda: TK.key_vi_values(key_layouts, GAMMA, KEY_SWEEPS),
        key_work, reps=5,
        design="V split by key row over a thread-block cluster's shared memory",
        kernel_route="cluster",
        route_launches={r: counts[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        cluster=n, groups=G, threads_per_cta=G * h * w,
        active_clusters=cuda_vi.key_vi_active_clusters(C, h, w, n),
        shared_bytes=cuda_vi.key_vi_cluster_shared_bytes(C, h * w, n),
        compiled=compiled(ptxas, f"key_vi_cluster_kernelILi{h}ELi{w}E"),
    )

    # The same layouts at two door slots (C=4), where the route takes a
    # cluster of 8.
    def key2_path():
        states = env.generate(gen(3), env.params, KEY_B, device=DEVICE)
        layouts = TK.extract_key_layout(states, max_doors=2)
        return layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY_SWEEPS)

    (l2, kv2), counts2 = drive("key-domain VI, DoorKey-8x8, max_doors=2", key2_path)
    require(counts2["key_vi_cluster"] == 1, "B2 took the cluster route at two door slots")
    C2 = kv2.shape[2]
    route2, n2 = cuda_vi.key_vi_route(K, C2, h * w)
    require(route2 == "cluster", "the 8x8 shape's route at two door slots is the cluster")
    err2 = float((kv2 - TK.key_vi_values(l2, GAMMA, KEY_SWEEPS)).abs().max())
    require(err2 <= KEY_ATOL, f"B2 within {KEY_ATOL} of its plain version at two door slots")
    m2 = cuda_vi.key_vi_masks(l2)
    kernel_row(
        "key_vi_max_doors2", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts2["key_vi"], err2,
        lambda: cuda_vi.cuda_key_value_iteration(l2, GAMMA, KEY_SWEEPS),
        lambda: cuda_vi._key_vi_kernel(m2, GAMMA, KEY_SWEEPS, kv2.shape),
        lambda: TK.key_vi_values(l2, GAMMA, KEY_SWEEPS),
        cuda_vi.key_vi_work(l2, KEY_SWEEPS), reps=5,
        design="V split by key row over a thread-block cluster's shared memory",
        kernel_route="cluster",
        route_launches={r: counts2[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        cluster=n2, groups=G, threads_per_cta=G * h * w,
        active_clusters=cuda_vi.key_vi_active_clusters(C2, h, w, n2),
        shared_bytes=cuda_vi.key_vi_cluster_shared_bytes(C2, h * w, n2),
        compiled=compiled(ptxas, f"key_vi_cluster_kernelILi{h}ELi{w}E"),
    )
    del l2, kv2, m2

    env16 = make(KEY16_ENV)

    def key16_path():
        states = env16.generate(gen(4), env16.params, KEY16_B, device=DEVICE)
        layouts = TK.extract_key_layout(states, max_doors=1)
        return layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY16_SWEEPS)

    (l16, kv16), counts16 = drive("key-domain VI, DoorKey-16x16", key16_path)
    require(counts16["key_vi_global"] == 1, "B2 took the global route at DoorKey-16x16")
    err16 = float((kv16 - TK.key_vi_values(l16, GAMMA, KEY16_SWEEPS)).abs().max())
    require(err16 <= KEY_ATOL, f"B2's global route within {KEY_ATOL} at DoorKey-16x16")
    print(f"[key_vi 16x16] {KEY16_B} layouts, {KEY16_SWEEPS} sweeps: max|kernel - plain| {err16:.3g}", flush=True)
    del l16, kv16
    # The global route's row is timed at the 8x8 shape, beside the cluster
    # route; its launches are those of the 16x16 part of the main path.
    kernel_row(
        "key_vi_global", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts16["key_vi"], err_global,
        lambda: cuda_vi._key_vi_kernel_global(cuda_vi.key_vi_masks(key_layouts), GAMMA, KEY_SWEEPS, kv.shape),
        lambda: cuda_vi._key_vi_kernel_global(key_masks, GAMMA, KEY_SWEEPS, kv.shape),
        lambda: TK.key_vi_values(key_layouts, GAMMA, KEY_SWEEPS),
        key_work, reps=5,
        design="V double-buffered in device memory, one block per layout",
        kernel_route="global",
        route_launches={r: counts16[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        launches_on=f"{KEY16_ENV}, {KEY16_B} layouts, {KEY16_SWEEPS} sweeps (max|diff| {err16})",
        cluster=None, active_clusters=None,
        shared_bytes=(C + 2) * 4 * h * w,
        compiled=compiled(ptxas, "key_vi_global_kernel"),
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

    # 6. The other families' rollouts; no kernel is on this path.
    ids = [i for i in registered_ids()
           if i.startswith("MiniGrid-") and "DoorKey" not in i and not i.startswith(ROOMGRID_PREFIXES)]
    require(len(ids) == 45, f"45 MiniGrid ids of phase 6 ({len(ids)})")
    results["families"], counts = drive(
        "family rollouts", lambda: family_rollouts(make, L, card, ids, FAMILY_RUNS, 100, workers)
    )
    require(not any(counts.values()), "the family rollouts launch no VI kernel")

    # 7. B1 on the families' layouts: sizes given at run time, and lava.
    results["vi_families"] = []
    for env_id, sweeps in VI_FAMILIES:
        fam = make(env_id)
        (states, layouts, v, policy), counts = drive(
            f"solve {env_id}",
            lambda: T.solve(fam, gen(6), VI_B, GAMMA, sweeps, max_doors=1, device=DEVICE),
        )
        require(counts["vi"] == 1, f"solve launched the B1 kernel once on {env_id}")
        err = float((v - T.vi_values(layouts, GAMMA, sweeps)).abs().max())
        require(err == 0.0, f"B1 equals its plain version on {env_id}")
        vals = T.state_value(v, layouts, states)
        greedy = greedy_optimal(
            fam, states, vals, T.steps_to_go(vals, GAMMA),
            lambda s: T.greedy_action(policy, layouts, s), T, L,
        )
        print(f"[greedy] {env_id}, {sweeps} sweeps: {greedy}", flush=True)
        results["vi_families"].append({"env": env_id, "sweeps": sweeps, **greedy})
        h_f, w_f = fam.params.height, fam.params.width
        masks = cuda_vi.vi_masks(layouts)
        C, D = v.shape[1], layouts.n_doors
        lpb, G = cuda_vi.vi_plan(C, D, h_f * w_f)
        kernel_row(
            f"vi_{env_id.split('-')[1]}", f"{CSRC}/vi.cu", f"{PALLAS_VI}:201", counts["vi"], err,
            lambda: cuda_vi.cuda_value_iteration(layouts, GAMMA, sweeps),
            lambda: cuda_vi._vi_kernel(masks, GAMMA, sweeps, v.shape),
            lambda: T.vi_values(layouts, GAMMA, sweeps),
            cuda_vi.vi_work(layouts, sweeps), reps=10,
            design="a thread per (cell, config group) with its 4 directions and per-cell data "
            "in registers; V in shared memory; grid size given at run time; lava in the mask",
            kernel_route="shared", route_launches={"shared": counts["vi"]},
            shape=f"{VI_B} layouts {h_f}x{w_f}, {sweeps} sweeps, max_doors 1",
            layouts_per_block=lpb, config_groups=G, threads_per_block=lpb * G * h_f * w_f,
            walk_bits=cuda_vi.vi_walk_bits(C),
            shared_bytes=cuda_vi.vi_shared_bytes(C, D, h_f * w_f, lpb),
            compiled=compiled(ptxas, f"vi_kernelILi{cuda_vi.vi_walk_bits(C)}ELi0ELi0E"),
        )
        del states, layouts, v, policy, masks

    # 8. The RoomGrid families' rollouts; no kernel is on this path.
    t0 = time.perf_counter()
    ids = [i for i in registered_ids() if i.startswith(ROOMGRID_PREFIXES)]
    require(len(ids) == 26, f"26 RoomGrid, MultiRoom and Playground ids ({len(ids)})")
    results["roomgrid_families"], counts = drive(
        "RoomGrid family rollouts",
        lambda: family_rollouts(make, L, card, ids, ROOMGRID_RUNS, 200, workers),
    )
    require(not any(counts.values()), "the RoomGrid family rollouts launch no VI kernel")
    phase_s = {"roomgrid_rollouts": time.perf_counter() - t0}

    # 9. B2 on KeyCorridor and ObstructedMaze-1Dl layouts.
    t0 = time.perf_counter()
    results["key_families"] = key_families(make, drive, kernel_row, ptxas)
    phase_s["key_families"] = time.perf_counter() - t0

    # 10. The obstructed domain, plain PyTorch on the card.
    t0 = time.perf_counter()
    results["obstructed"], counts = drive("obstructed domain", lambda: obstructed_families(make))
    require(not any(counts.values()), "the obstructed domain launches no VI kernel")
    phase_s["obstructed"] = time.perf_counter() - t0
    # 11. The BabyAI ids' rollouts; no kernel is on this path.
    t0 = time.perf_counter()
    ids = [i for i in registered_ids() if i.startswith("BabyAI-")]
    require(len(ids) == 96, f"96 BabyAI ids ({len(ids)})")
    results["babyai"], counts = drive(
        "BabyAI rollouts", lambda: family_rollouts(make, L, card, ids, BABYAI_RUNS, 300, workers)
    )
    require(not any(counts.values()), "the BabyAI rollouts launch no VI kernel")
    require(results["babyai"]["BabyAI-GoToLocal-v0"]["successes"] > 0,
            "the verifier counted successes on GoToLocal")
    phase_s["babyai_rollouts"] = time.perf_counter() - t0

    # 12. The two-key domain, plain PyTorch on the card.
    t0 = time.perf_counter()
    results["twokey"], counts = drive("two-key domain", lambda: twokey_domain(make))
    require(not any(counts.values()), "the two-key domain launches no VI kernel")
    phase_s["twokey"] = time.perf_counter() - t0

    # 13. The environment API, card against CPU.
    t0 = time.perf_counter()
    results["env_api"], counts = drive("environment API", lambda: env_api(make, workers))
    require(not any(counts.values()), "the environment API launches no VI kernel")
    phase_s["env_api"] = time.perf_counter() - t0

    # 14. PPO throughput, rollout / learner split.
    t0 = time.perf_counter()
    results["ppo_throughput"], counts = drive("PPO throughput", lambda: ppo_throughput(make, card))
    require(not any(counts.values()), "PPO launches no VI kernel")
    phase_s["ppo_throughput"] = time.perf_counter() - t0

    # 15. PPO learning.
    results["ppo_learning"] = []
    for env_id in LEARN_IDS:
        t0 = time.perf_counter()
        run, counts = drive(f"PPO learning {env_id}", lambda: ppo_learning(make, env_id))
        require(not any(counts.values()), "PPO launches no VI kernel")
        results["ppo_learning"].append(run)
        phase_s[f"ppo_learning {env_id}"] = time.perf_counter() - t0

    # 16. The renderer, the pixel observation and the wrappers.
    t0 = time.perf_counter()
    results["render_wrappers"], counts = drive("render and wrappers", lambda: render_and_wrappers(make, card))
    require(not any(counts.values()), "rendering and the wrappers launch no VI kernel")
    phase_s["render_wrappers"] = time.perf_counter() - t0

    # 17. The BabyAI bot, one per env, over the batch-first step.
    t0 = time.perf_counter()
    ids = [i for i in registered_ids() if i.startswith("BabyAI-") and i not in BOT_BROKEN]
    require(len(ids) == 92, f"92 solvable BabyAI ids ({len(ids)})")
    results["bot"], counts = drive("BabyAI bot", lambda: bot_solves(make, ids, card))
    require(not any(counts.values()), "the bot launches no VI kernel")
    phase_s["bot"] = time.perf_counter() - t0
    print(f"[phases 8-17] seconds {phase_s}", flush=True)
    results["phase_s"] = phase_s

    # 18. Kernels line, card, ok.
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    print(f"[chip_smoke] {results['total_s']:.1f} s in all, the build included", flush=True)
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
