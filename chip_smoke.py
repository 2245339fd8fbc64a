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
   The rollout must capture its step as one CUDA graph (it prints the
   capture's ms and its memory pool's bytes).
2a. graph against eager: one pool of that shape stepped T=768 times by
   the graphed scan and by ``_lane_scan_eager`` (the same step in a Python
   loop), graphed then eager, from generators in the same state: every
   result, and each generator's next draw, equal bit for bit; ms a step
   of each run, capture ms, the pool's bytes.
2b. the observation kernel: ``obs_checksum_lanes`` (``csrc/obs.cu``, the
   rollout step's observation and checksum in one launch) on DoorKey-8x8
   states of the headline's shape, 65536 lanes stepped by random actions,
   against the plain ``obs_lanes`` and its sum every few steps (difference
   0); the kernel's ms (100 launches captured in a CUDA graph and
   replayed, as the rollout runs it), its bound by bytes, the plain
   version's ms eager and captured the same way; its launches in phase
   2's rollout (the capture's warm-up and the capture: 2).
2c. the step kernel: ``step_lanes_kernel`` (``csrc/step.cu``, the rollout
   step's transition, autoreset and write-back in one launch, in place) at
   the pool cell's shape (DoorKey-8x8, 65536 lanes, four pool rounds) and
   at the regen cell's (a fresh generated batch, batch-first), the lanes'
   step counts spread over the limit: STEP_CHECK_STEPS steps by the kernel
   step and by the plain step on the same carry, every carry and
   generator state equal bit for bit; the kernel alone (100 launches in a
   CUDA graph) beside its bound by bytes (``step_bytes``); in the pool
   mode the whole step, kernel path and plain path, in a graph; its
   launches in phase 2's rollout (2).
2d. the generator kernel: DoorKey's ``generate`` on the card (five draws,
   then ``csrc/doorkey_gen.cu``) against the plain generator
   (``generate_plain``) at DoorKey-5x5, 6x6, 8x8 and 16x16, from the same
   generator state, every field and the generator's next draw equal bit
   for bit; then at DoorKey-8x8 at 65536 and 262144 layouts the kernel
   alone, the whole ``generate`` and the plain generator, each in a CUDA
   graph, beside the kernel's bound by bytes (``gen_bytes``: every field
   written), each timed batch held against the plain generator first; its
   launches in phase 2's rollout (2) and in a short regen rollout.
3. B1: ``tabular.solve`` on 1024 DoorKey-8x8 layouts, 128 sweeps, at
   max_doors 1 and 2; the kernel's V must equal the plain version's
   exactly.  Then the kernel's other two ways of holding walkability, also
   exactly: a 64-bit mask (DoorKey-8x8, max_doors 3) and bytes in shared
   memory (DoorKey-5x5, max_doors 4).
4. B2: ``cuda_key_value_iteration`` on 512 DoorKey-8x8 layouts, 96
   sweeps, within 1e-6 of the plain version, on the cluster route (V in a
   thread-block cluster's shared memory), at one door slot (a cluster of
   4) and two (a cluster of 8); then on 32 DoorKey-16x16 layouts, 24
   sweeps, on the wide route (V in the shared memory of a cluster of 16,
   swept in place), the route for V too large for a cluster of 8; and on
   512 DoorKey-16x16 layouts at 96 sweeps, the B2 bench's size (the
   user's call and the plain version timed, V within 1e-6).  Then the
   same 32 layouts at two door slots, where V (4.2 MB a layout) is too
   large for 16 CTAs: the grid route through the wrapper (groups of 20
   CTAs, V resident in their shared memory).  Then 64 DoorKey-8x8 layouts
   at the default max_doors of ``extract_key_layout`` (seven: V 8.5 MB a
   layout), the grid route.
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
   Each rollout equals ``_lane_scan_eager`` on the same pool from the same
   generator state bit for bit, the generators' next draws too; each
   prints the ms a step of both, its capture's ms and its pool's bytes.
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
   on 512 KeyCorridorS3R2 layouts at six door slots (C = 64, the wide
   route, double-buffered), 512 ObstructedMaze-1Dl layouts at one (11 wide and
   6 high, the cluster route), the target named by aux slots 0-1, the
   KeyCorridorS3R3 layouts of 512 that have at most seven doors (C = 128,
   the grid route, resident), and 4
   LockedRoom layouts at six door slots (19x19, V 134 MB a layout, the
   grid route streamed); every
   other family's layouts have at most that many doors.  V within 1e-6 of the plain version; the
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
   steps on the card, equal at every step (observation, state, flags,
   reward, bit for bit) to the same calls on the CPU, run in worker
   processes;
   DynamicObstacles' balls kept through ``step``; the same at B=1.
14. PPO throughput at the JAX bench's configuration (BabyAI-GoToDoor,
   32768 envs, T=32, 2 epochs, 8 minibatches), the collector's and the
   minibatch's step each replayed as a CUDA graph: two warm-up updates,
   then five timed ones; the full update's env-steps/s, and the rollout /
   learner split, the rollout timed by a zero-epoch update; each PPO
   captured its collector once and its learner once (none at zero
   epochs).
14a. PPO graphed against eager at that size: two updates graphed
   (``update``) and, from the same seed, eager (``_update_eager``, both
   steps in Python loops) twice; the first update's trajectory
   (every buffer), final state, reset counts and the collector
   generator's next draw equal bit for bit; after the second, the
   parameters and Adam's state of the graphed run within twice the
   eager runs' spread, by the mean difference over every element (the
   embeddings' backward sums with atomics; max and mean printed).  Then
   the same with PyTorch's deterministic algorithms, graphed and eager:
   everything, parameters and Adam's state included, bit for bit.  Then
   ``profile_torch.profile_ppo``: ms, kernels, graph launches and busy
   share of the collector (a step), graphed and eager; the learner, the
   whole update and the eager remainder on the host clock
   (``profile_torch.py`` traces them); each graph's capture ms and pool
   bytes.
15. PPO learning (graphed): MiniGrid-DoorKey-5x5 and BabyAI-GoToDoor at
   the JAX learning bench's configuration (8192 envs, T=64, 2 epochs, 8
   minibatches) must each reach mean return >= 0.90 over >= 1024
   episodes for 3 updates in a row within 100 updates, each graph
   captured once; each curve is printed.
16. rendering and wrappers: ``render_frame`` (tile 32, highlight) on 4096
   DoorKey-8x8 states two steps into their episodes (805 MB of frames) and
   ``render_pov`` (tile 8) on 32768, each with its ms, frames/s, peak
   memory and bound (bytes over 3.35 TB/s), the first 256 frames equal to
   the CPU's; the pixel observation of pixel-based agents,
   ``ImgObsWrapper(RGBImgPartialObsWrapper(env, 8))``, on DoorKey-8x8 and
   BabyAI-GoToDoor at B=32768 for 32 steps of seeded random actions
   (env-steps/s, peak memory); each of the 15 wrappers at B=256 for 16
   steps, every deterministic one equal on card and CPU at every step
   ("angle" within 1e-6, all else bit for bit), StochasticActionWrapper
   (prob=1.0 is the bare step; at 0.5 the replaced share within 4 sigma,
   no replacement 6) and ReseedWrapper (its cycle) by their invariants.
17. the BabyAI bot: four envs of each of the 92 solvable BabyAI ids, one
   ``BabyAIBot`` per env over one batch-first ``step`` (``run_bots``), up
   to 240 steps; an id that solves none gets four more episodes.  Every
   id solved at least once, with a positive reward, and the solve share
   >= 0.90; per-id counts, episodes/s and the phase's seconds.
18. multi-device on one card (NCCL takes one rank a card): a one-rank NCCL
   group's sharded ``lane_rollout`` on DoorKey-8x8 at B=65536, T=256, four
   pool rounds (grouped, ungrouped, grouped, each timed) equals the
   ungrouped run from the same seed bit for bit;
   one sharded PPO update at BASELINE config 5's width (GoToDoor, 65536
   envs, T=32, 2 epochs x 8 minibatches; the trajectory all-gathered, the
   learner's all-reduces inside its graph, each graph captured once)
   equals an ungrouped update from the same seed bit for bit, both with
   PyTorch's deterministic algorithms; each learner's ms an update (CUDA
   events, on the next rollout), the all-gather's bytes and each run's
   peak memory printed.  Then
   two gloo ranks spawned on the one card: the sharded rollout on a fixed
   pool and action script (Empty-5x5, B=4096, T=256, four rounds) equals
   the one-process run's slices bit for bit, the all-reduced scalars equal
   on both ranks; one sharded PPO update (GoToDoor, two envs a rank, T=8)
   gives finite metrics and parameters equal on both ranks; ``_learn`` on
   one fixed numpy trajectory (Empty-5x5, 12 envs, T=8, minibatches of
   three: a share of two rows, one padded; f32 compute) within 1e-5 of the
   one-process ``_learn`` on the card (parameters; metrics relative).
   The gloo learner stays eager by rule: both legs' ``captures`` printed.
   Then ``measure_scaling`` at one rank: steps/s only.
19. host tools: ``checked_step`` over 64 steps at B=4096 on DoorKey-8x8,
   a corrupted state caught; ``debug_mode`` trips on a NaN made on the
   card; a PPO train state on the card through a checkpoint round trip
   (parameters, optimizer, env state, pool, generators equal, then the
   same actions collected); ``generation_acceptance`` at n=4096 on
   DoorKey-8x8 (structural), MultiRoom-N6 and GoToLocal (pooled
   attempts); ``state_hash`` and ``pprint_state`` of card states equal to
   those of their CPU copies.
20. the CLI's ``--dp`` (``benchmark.main``), inside its ``--trace``: the
   plain value iteration, then B1, at JAX's sizes (1024 DoorKey-8x8
   layouts from seed 7, two door slots, 128 sweeps); B1's V equal to the
   plain V exactly; the Chrome trace holds B1's kernel and the CLI's
   ``span`` ranges, and ``spans.json`` their records and each rollout's
   in-graph step; the CLI's two rates printed, JAX's
   ``batched_env_steps_per_s`` from the "regen" rollout and
   ``lane_env_steps_per_s`` from the "pool" one.
21. the headline bench: ``bench_torch.main`` in-process, its rollouts and
   PPO at BENCH_SIZES, its DP rows at full size: one JSON line holding
   every key, every rate finite and positive, B1 and B2's cluster route
   launched (a warm-up and each timed run) and counted in its
   ``launches``, each PPO row's graphs captured once (``ppo_graphs``);
   B1 and B2 held against their plain versions on the bench's layouts.
22. the "regen" autoreset graphed: (a) every registered id's ``generate``
   at B=256 captured once as a CUDA graph and replayed, equal bit for bit
   to an eager call from the same generator state (capture ms and pool
   bytes per id), and six ids' generate at B=4096 timed graphed and
   eager; the BabyAI flood fill at its fixed bound (244 sweeps) on 4096
   BossLevel layouts, graphed and eager, against the loop it replaced
   (a host check every 16 sweeps): ms, that loop's sweeps, equal
   answers; (b) the regen ``lane_rollout`` graphed against
   ``_lane_scan_eager`` bit for bit (final lanes, sums, the generator's
   next draw) on DoorKey-8x8 at B=65536, T=768, LavaGapS7 at 4096 x 256
   (the CLI's size) and BabyAI-BossLevel at 4096 x 64 (the heaviest
   generator): ms a step of each, capture ms, pool bytes, and
   ``profile_torch.profile_regen``'s kernels a step and busy share;
   (c) PPO's regen collector on GoToDoor at 8192 envs, T=64, 2 x 8
   minibatches, graphed against eager: the first update's trajectory,
   state, resets and next draw bit for bit; a second update of each timed;
   the collector's ms a step graphed (kernels and busy share under the
   profiler) and eager.
23. the kernels line: for each kernel, its launches on the main path (each
   part of it driven with the counts set to 0 just before and read just
   after), its largest difference from the plain version, the times of
   kernel, plain version and bound, its design and route, and the
   registers and shared memory the compiler gave it.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"
ENV_ID = "MiniGrid-DoorKey-8x8-v0"
GAMMA = 0.995
ROLLOUT_B, ROLLOUT_T, POOL_ROUNDS = 65536, 768, 4
VI_B, VI_SWEEPS = 1024, 128
KEY_B, KEY_SWEEPS = 512, 96
KEY16_ENV, KEY16_B, KEY16_SWEEPS = "MiniGrid-DoorKey-16x16-v0", 32, 24
# The B2 bench's size (bench.py:141), where the wide route is timed on
# DoorKey-16x16 (1.08 GB of V).
KEY16_BENCH_B, KEY16_BENCH_SWEEPS = 512, 96
# B1 at more door slots: (env, max_doors) for the 64-bit walk mask and for
# walkability bytes in shared memory.
VI_MANY_DOORS = (("MiniGrid-DoorKey-8x8-v0", 3), ("MiniGrid-DoorKey-5x5-v0", 4))
KEY_ATOL = 1e-6
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
VIEW_STEPS, VIEW_CHECK_EVERY = 40, 5  # phase 2b: steps taken, and how often checked
STEP_CHECK_STEPS = 40  # phase 2c: steps held against the plain step
# Phase 2d: DoorKey sizes whose generator kernel is held against the plain
# generator, at each batch; the batches it is timed at on DoorKey-8x8 (the
# regen cell's and the pool cell's generate).
GEN_SIZES, GEN_CHECK_B = (5, 6, 8, 16), (4097, 65536)
GEN_TIMED_B = (65536, 262144)
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
# B2 on the families' layouts (phase 9): (env, max_doors, layouts, whether
# the generator may place more doors than that), at the JAX key bench's
# batch (bench.py:141); LockedRoom (six doors in every layout, V 134 MB a
# layout) at 4.  KeyCorridorS3R3 places up to eight doors, one more than the
# domain's seven slots: the phase keeps the layouts with at most seven.
KEY_FAMILIES = (
    ("MiniGrid-KeyCorridorS3R2-v0", 6, 512, False),
    ("MiniGrid-ObstructedMaze-1Dl-v0", 1, 512, False),
    ("MiniGrid-KeyCorridorS3R3-v0", 7, 512, True),
    ("MiniGrid-LockedRoom-v0", 6, 4, False),
)
KEY_FAMILY_SWEEPS = 128
# DoorKey-8x8 at extract_key_layout's default max_doors (7), as a caller who
# keeps the default solves it: V 8.5 MB a layout, the grid route.
KEY_DEFAULT_B = 64
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

# Multi-device (phase 18): the one-rank NCCL rollout at the main path's
# size and PPO update at BASELINE config 5's width (GoToDoor, 65536 envs,
# T=32 as the PPO bench); the two-rank gloo legs at dryrun_multichip's (its
# Empty-5x5 rollout at B=4096 here), and the learner on a fixed trajectory
# at minibatches of three envs (a two-row share, one row padded); the
# scaling harness at one rank.
NCCL_B, NCCL_T = 65536, 256
NCCL_PPO_B = 65536
GLOO_LEARN_B, GLOO_LEARN_T, GLOO_LEARN_MB, GLOO_LEARN_SEED = 12, 8, 4, 3
GLOO_LEARN_ATOL = GLOO_LEARN_RTOL = 1e-5
PPO_SPREAD_RUNS = 2
# The "regen" autoreset (phase 22): every id's generator captured at
# REGEN_GEN_B; six ids' generate timed at REGEN_TIMED_B, graphed and eager;
# the regen rollout at the main path's shape, the CLI's (LavaGapS7) and
# on the heaviest generator (BossLevel); PPO's regen collector at the
# learning size.
REGEN_GEN_B, REGEN_TIMED_B = 256, 4096
REGEN_TIMED_IDS = (
    "MiniGrid-DoorKey-8x8-v0", "MiniGrid-LavaGapS7-v0", "MiniGrid-MultiRoom-N6-v0",
    "MiniGrid-KeyCorridorS6R3-v0", "BabyAI-GoToDoor-v0", "BabyAI-BossLevel-v0",
)
REGEN_ROLLOUTS = (
    (ENV_ID, ROLLOUT_B, ROLLOUT_T),
    ("MiniGrid-LavaGapS7-v0", 4096, 256),
    ("BabyAI-BossLevel-v0", 4096, 64),
)
REGEN_PROFILE_STEPS = 4
GLOO_ENV, GLOO_B, GLOO_T = "MiniGrid-Empty-5x5-v0", 4096, 256
GLOO_TIMEOUT_S = 300
SCALING_B, SCALING_T = 65536, 256
# Host tools (phase 19).
GUARD_B, GUARD_T = 4096, 64
CKPT_B, CKPT_T = 4096, 8
TELEMETRY_N = 4096
TELEMETRY_IDS = ("MiniGrid-DoorKey-8x8-v0", "MiniGrid-MultiRoom-N6-v0", "BabyAI-GoToLocal-v0")
HASH_IDS, HASH_B = ("MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToLocal-v0"), 16
REWARD_RTOL = 1e-6
# The headline bench (phase 21): bench_torch.FULL with its rollouts and PPO
# cut to fit about a minute (the DoorKey horizon still past the step limit);
# the DP rows at full size.
BENCH_SIZES = {
    "batch": 16384, "iters": 2, "family_batch": 4096, "family_horizon": 64,
    "ppo_envs": 4096, "ppo_warmup": 1, "ppo_timed": 2,
}
BENCH_KEYS = {
    *(f"{f}_steps_per_s" for f in (
        "babyai_gotolocal", "dynamicobstacles_8x8", "obstructedmaze_full_v1", "keycorridor_s6r3",
        "multiroom_n6", "memory_s17", "babyai_bosslevel", "fetch_8x8_n3",
    )),
    "vi_key_sweeps_per_s", "vi_key_cuda_sweeps_per_s", "vi_obstructed_sweeps_per_s",
    "vi_twokey_sweeps_per_s", "vi_d1_plain_sweeps_per_s", "vi_d1_cuda_sweeps_per_s",
    "ppo_steps_per_s", "ppo_rollout_s", "ppo_learner_s",
    "git_rev", "timestamp_utc", "device", "spread", "launches", "ppo_graphs",
}

PALLAS_VI = "minigrid_dynamicprogramming_tpu/dp/pallas_vi.py"
GRID_DESIGN = (
    "a cooperative, persistent launch: the resident CTAs form groups of n, one CTA an SM, each "
    "group a layout at a time, one barrier a sweep over the group through a counter in device memory"
)
WIDE_DESIGN = (
    "V in a cluster of 16 CTAs' shared memory, one CTA an SM: the rows other than CARRIED "
    "split over 15, the CARRIED row alone on the last, which sends their pickup values and "
    "takes their drop values by remote stores"
)
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


def grid_design(C: int, h: int, w: int, n: int, ptxas) -> dict:
    """The grid route's plan at this shape, for a kernels-line row: mode,
    CTAs a layout, groups the card holds, threads, shared memory, and the
    compiler's registers and spills."""
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi

    hw = h * w
    resident = cuda_vi.key_vi_grid_resident(hw + 1, C, hw)
    mode = "resident" if resident else "streamed"
    return dict(
        design=GRID_DESIGN + ("; resident: the key rows in the group's shared memory, swept in "
                              "place, pickups and drops through two tables in device memory"
                              if resident else "; streamed: V double-buffered in device memory, "
                              "each layout's (row, config) slabs split over the group"),
        mode=mode, ctas_per_layout=n, rows_per_cta=-(-(hw + 1) // n) if resident else None,
        groups_resident=cuda_vi.key_vi_grid_active_groups(C, h, w, n, resident),
        threads_per_cta=cuda_vi.key_vi_grid_threads(hw),
        shared_bytes=cuda_vi.key_vi_grid_shared_bytes(C, hw, n, resident),
        compiled=compiled(ptxas, f"key_vi_grid_{mode}_kernel"),
    )


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


def rollouts_equal(L, a, b, what: str) -> None:
    """Two rollout results equal bit for bit: every field of the final
    state, the resets per lane and the summed scalars."""
    for n in L._FIELDS:
        require(torch.equal(getattr(a.final_state, n), getattr(b.final_state, n)),
                f"{what}: final {n} equal")
    require(torch.equal(a.resets_per_env, b.resets_per_env), f"{what}: resets per lane equal")
    for n in ("total_reward", "episodes", "successes", "failures", "obs_checksum"):
        require(torch.equal(getattr(a, n), getattr(b, n)), f"{what}: {n} equal")


def next_draw(g: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 1 << 30, (16,), generator=g, device=DEVICE)


def capture_counts() -> dict:
    """The rollout's capture counters (``utils/profiling.py``): captures,
    their host ms and their memory pools' bytes, summed so far."""
    from minigrid_dynamicprogramming_tpu_torch.utils import profiling

    return {k: profiling.counter(f"lanes.{k}") for k in ("captures", "capture_ms", "pool_bytes")}


def captured_since(before: dict) -> dict:
    """The captures since ``before`` (``capture_counts``), their host ms
    and their memory pools' bytes."""
    now = capture_counts()
    return {"captures": now["captures"] - before["captures"],
            "capture_ms": now["capture_ms"] - before["capture_ms"],
            "graph_pool_bytes": now["pool_bytes"] - before["pool_bytes"]}


def scan_graphed_and_eager(env, L, pool, b: int, horizon: int, autoreset: str, rounds: int,
                           start, what: str) -> tuple:
    """``horizon`` steps from ``pool`` by ``_lane_scan`` (the step captured
    once as a CUDA graph, then replayed) and by ``_lane_scan_eager`` (the
    same step in a Python loop), graphed then eager, each drawing from a
    generator in state ``start``: the results equal bit for bit, as do
    the generators' next draws.  Returns (graphed s, eager s, the eager
    result, the graphed run's capture ms and pool bytes) on the host
    clock."""
    runs = []
    for graphed in (True, False):
        g = torch.Generator(device=DEVICE).set_state(start)
        scan = L._lane_scan if graphed else L._lane_scan_eager
        before = capture_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = scan(env, g, pool, b, horizon, autoreset, rounds)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, res, next_draw(g), captured_since(before)))
        require(runs[-1][3]["captures"] == graphed, "one capture a graphed scan")
    (g_s, g_res, g_next, capture), (e_s, e_res, e_next, _) = runs
    rollouts_equal(L, g_res, e_res, f"{what}: graphed against eager")
    require(torch.equal(g_next, e_next), f"{what}: the generator's next draw")
    return g_s, e_s, e_res, {k: capture[k] for k in ("capture_ms", "graph_pool_bytes")}


def graph_against_eager(env, L, card: str) -> dict:
    """Phase 2a: one pool of the headline's shape stepped ROLLOUT_T times,
    graphed and eager (``scan_graphed_and_eager``).  Host seconds and ms
    a step of each run, the capture's ms and its memory pool's bytes."""
    pool = L.lane_pool(env, gen(2), ROLLOUT_B, "pool", POOL_ROUNDS, torch.device(DEVICE))
    g_s, e_s, res, capture = scan_graphed_and_eager(env, L, pool, ROLLOUT_B, ROLLOUT_T, "pool",
                                           POOL_ROUNDS, gen(3).get_state(), "graph")
    require(int(res.resets_per_env.min()) >= 1, "every lane reset")
    runs = [{"graphed": True, "s": g_s, "ms_per_step": 1e3 * g_s / ROLLOUT_T,
             **capture},
            {"graphed": False, "s": e_s, "ms_per_step": 1e3 * e_s / ROLLOUT_T}]
    out = {"B": ROLLOUT_B, "T": ROLLOUT_T, "pool_rounds": POOL_ROUNDS, "card": card, "runs": runs}
    print(
        f"[graph] B={ROLLOUT_B} T={ROLLOUT_T}: graphed and eager equal bit for bit, "
        "generators too; ms a step "
        + ", ".join(f"{run['ms_per_step']:.4f}" for run in out["runs"])
        + "; capture ms "
        + ", ".join(f"{run['capture_ms']:.3f}" for run in out["runs"] if run["graphed"])
        + f"; graph pool {out['runs'][0]['graph_pool_bytes']} bytes ({card})",
        flush=True,
    )
    return out


def graphed_ms(fn, n: int = 100, reps: int = 10) -> float:
    """Device ms of one ``fn()`` as a CUDA graph replays it: ``n`` calls
    captured into one graph, its replay timed ``reps`` times (median)
    over ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    try:
        return cuda_ms(graph.replay, reps) / n
    finally:
        graph.reset()


def obs_kernel(env, L, ptxas, launches: float) -> dict:
    """Phase 2b: ``obs_checksum_lanes`` (``csrc/obs.cu``) against the plain
    ``obs_lanes`` and its sum on VIEW_STEPS stepped DoorKey-8x8 states of
    ROLLOUT_B lanes, then timed beside its bound and the plain version.
    ``launches``: the kernel's launches in phase 2's rollout.  Returns the
    kernels-line row."""
    dev = torch.device(DEVICE)
    params = env.params
    h, w, b = params.height, params.width, ROLLOUT_B
    g = gen(4)
    ls = L.to_lanes(env.generate(g, params, b, dev))
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    t = torch.zeros(1, dtype=torch.int64, device=dev)

    def kernel():
        L.obs_checksum_lanes(params, ls, out, t)

    def plain():
        obj, color, obj_state, vis = L.obs_lanes(params, ls)
        out.index_add_(0, t, ((obj.to(torch.int64) + color + obj_state) * vis).sum().view(1))

    err, carrying = 0, 0
    for step in range(VIEW_STEPS):
        act = torch.randint(0, env.action_dim, (b,), generator=g, device=dev, dtype=torch.int32)
        ls, _, _ = L.step_lanes_env(env, ls, act)
        if step % VIEW_CHECK_EVERY == VIEW_CHECK_EVERY - 1:
            out.zero_()
            kernel()
            got = int(out[0])
            out.zero_()
            plain()
            err = max(err, abs(got - int(out[0])))
            carrying = max(carrying, int((ls.carrying_obj != 1).sum()))  # 1: OBJ_EMPTY
    require(err == 0, "the observation kernel equals the plain checksum")
    require(carrying > 0, "some lanes carry the key")
    kernel_ms = graphed_ms(kernel)
    plain_graph_ms = graphed_ms(plain, n=4)
    plain_ms = cuda_ms(plain, 5)
    # Each plane's byte of every lane and cell once, the agent's five
    # scalars, the step index and the slot.
    nbytes = 3 * h * w * b + b * (3 * 4 + 2) + 2 * 8
    bound_ms, bound_by = bound(nbytes, 0)
    row = {
        "name": "obs", "route": "cuda", "source": f"{CSRC}/obs.cu", "replaces": None,
        "launches": launches, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "plain_graphed_ms": plain_graph_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "kernel_only_ms": kernel_ms, "lanes": b, "checked_states":
        VIEW_STEPS // VIEW_CHECK_EVERY, "lanes_carrying": carrying,
        "design": "a thread a lane, 128 lanes a block; the block's three planes staged in "
        "shared memory as one word a cell and lane; the visibility sweep in 64-bit registers, "
        "row by row; one atomic add a block",
        "compiled": compiled(ptxas, "obs_checksum_kernelILi7ELb1E"),
    }
    print(
        f"[obs] B={b} DoorKey-8x8: max|kernel - plain| {err} over {row['checked_states']} "
        f"stepped states ({carrying} lanes carrying); kernel {kernel_ms:.5f} ms in a graph, "
        f"bound {bound_ms:.5f} ms by {bound_by} ({kernel_ms / bound_ms:.1f}x), plain "
        f"{plain_ms:.4f} ms eager, {plain_graph_ms:.4f} ms in a graph; phase 2's rollout "
        f"launched it {launches:g} times; {row['compiled']}",
        flush=True,
    )
    return row


def step_bytes(params, b: int, resets: float) -> int:
    """The least bytes one kernel step moves at DoorKey's flags (no box,
    mark, aux or mission plane): each lane reads its int32 action, its
    position, direction and step count (int32) and what it carries (two
    u8), and one 32-byte sector of each of the three planes at its front
    cell; it writes its direction, step count, reward (four bytes each) and
    its two done flags.  Each of ``resets`` lanes reads its reset count and
    fresh layout (three u8 planes and its scalars) and writes them.  The
    front cell's rare writes, and a move's position, are left out."""
    hw = params.height * params.width
    lane = 4 + 4 * 4 + 2 + 3 * 32 + 3 * 4 + 2
    # Planes; x, y, dir; carried; its marks; step count; flags; reset count.
    fresh = 3 * hw + 3 * 4 + 4 * 1 + 4 + 4 + 2 + 4
    return int(b * lane + resets * 2 * fresh)


def step_kernel(env, L, ptxas, launches: float) -> list:
    """Phase 2c: ``step_lanes_kernel`` (``csrc/step.cu``) against the plain
    step at ROLLOUT_B lanes of DoorKey-8x8, in "pool" (POOL_ROUNDS rounds)
    and "regen" (this step's generated batch), then timed alone in a CUDA
    graph beside its bound by bytes (``step_bytes``), and, in "pool", the
    whole step of each path in a graph.  ``launches``: its launches in
    phase 2's rollout.  Returns the kernels-line rows."""
    dev = torch.device(DEVICE)
    params, b = env.params, ROLLOUT_B
    rows = []
    for mode in ("pool", "regen"):
        g = gen(6)
        pool = L.lane_pool(env, g, b, mode, POOL_ROUNDS, dev)
        scan = L._Scan(env, g, pool, b, STEP_CHECK_STEPS, mode, POOL_ROUNDS, None)
        require(scan.path == "kernel", "DoorKey-8x8 takes the kernel step on the card")
        c = scan.carry
        # Mid-rollout lanes: about one in max_steps reaches the limit a step.
        c.ls.step_count.copy_(torch.randint(0, params.max_steps, (b,), generator=g, device=dev,
                                            dtype=torch.int32))
        plain, kernel = c.clone(), c.clone()
        for i in range(STEP_CHECK_STEPS):
            start = g.get_state()
            scan.step_plain(plain)
            after = g.get_state()
            g.set_state(start)
            scan.step_kernel(kernel)
            require(torch.equal(g.get_state(), after), f"step {mode} {i}: the generator's state")
            for n in L._FIELDS:
                require(torch.equal(getattr(kernel.ls, n), getattr(plain.ls, n)),
                        f"step {mode} {i}: {n} equal")
            for n in ("reset_count", "t", "dones", "wins", "ends", "checksums"):
                require(torch.equal(getattr(kernel, n), getattr(plain, n)), f"step {mode} {i}: {n}")
            require(torch.equal(kernel.rewards[:i + 1], plain.rewards[:i + 1]),
                    f"step {mode} {i}: reward")
        resets_checked = int(plain.dones.sum())
        require(resets_checked > 0, f"step {mode}: lanes reset")

        # The kernel alone: a fixed fresh source, 100 launches of 100 action
        # draws, one slot; the lanes go on from the checked state, and reset
        # at the checked steps' rate.
        fresh = pool if mode == "pool" else env.generate(g, params, b, dev)
        acts = torch.randint(0, env.action_dim, (100, b), generator=g, device=dev,
                             dtype=torch.int32)
        t = torch.zeros(1, dtype=torch.int64, device=dev)
        counts = torch.zeros(3, 1, dtype=torch.int64, device=dev)
        calls = [0]
        resets = resets_checked / STEP_CHECK_STEPS

        def launch(c=kernel):
            i = calls[0] % len(acts)
            calls[0] += 1
            L.step_lanes_kernel(params, c.ls, c.reset_count, fresh, scan.rounds, acts[i], t,
                                scan.reward, counts[0], counts[1], counts[2], mode)

        kernel_ms = graphed_ms(launch)
        bound_ms, bound_by = bound(step_bytes(params, b, resets), 0)
        row = {
            "name": f"step_{mode}", "route": "cuda", "source": f"{CSRC}/step.cu", "replaces": None,
            "launches": launches if mode == "pool" else None, "max_abs_err": 0, "ms": kernel_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_only_ms": kernel_ms, "lanes": b, "checked_steps": STEP_CHECK_STEPS,
            "checked_resets": resets_checked, "resets_per_step": resets,
            "design": "a thread a lane, 128 lanes a block, lane-major; the step, its autoreset "
            "and its write-back in place; the front cell stored only where it changes; each "
            "warp copies its done lanes' fresh layouts, a round's loads before its stores; one "
            "atomic a block and count",
            "compiled": compiled(ptxas, f"step_kernelILb{int(mode == 'regen')}E"),
        }
        if mode == "pool":
            # Whole steps in a graph, given actions at slot 0: the kernel path
            # and the plain one (transition, select, write-back, four sums).
            timed = L._Scan(env, None, pool, b, 1, mode, POOL_ROUNDS, acts[:1].contiguous())
            tc = kernel.clone()

            def whole(step):
                tc.t.zero_()
                step(tc)

            row["step_ms"] = graphed_ms(lambda: whole(timed.step_kernel))
            row["plain_step_ms"] = graphed_ms(lambda: whole(timed.step_plain), n=4)
            row["plain_ms"] = row["plain_step_ms"]
        print(
            f"[step {mode}] B={b} DoorKey-8x8: kernel equals plain bit for bit over "
            f"{STEP_CHECK_STEPS} steps ({resets_checked} resets); kernel {kernel_ms:.5f} ms in a "
            f"graph ({resets:.1f} resets a launch), bound {bound_ms:.5f} ms by {bound_by} "
            f"({kernel_ms / bound_ms:.1f}x)"
            + (f"; whole step {row['step_ms']:.5f} ms, plain step {row['plain_step_ms']:.5f} ms"
               if mode == "pool" else "")
            + f"; {row['compiled']}",
            flush=True,
        )
        rows.append(row)
        del scan, plain, kernel, pool, fresh
    return rows


def gen_bytes(params, b: int) -> int:
    """The bytes one launch of ``csrc/doorkey_gen.cu`` moves for ``b``
    layouts: it reads the five draws (four bytes each) and writes every
    field of the batch-first state: five u8 and two int32 planes, the
    agent's position and direction, what it carries (four u8 and the int32
    marks), the step count, the two done flags, aux and the mission."""
    from minigrid_dynamicprogramming_tpu_torch.core.state import AUX_SLOTS, MISSION_SLOTS

    hw = params.height * params.width
    layout = 5 * hw + 2 * 4 * hw + 8 + 4 + 4 + 4 + 4 + 2 + 4 * (AUX_SLOTS + MISSION_SLOTS)
    return b * (5 * 4 + layout)


def generator_kernel(make, ptxas, pool_launches: float) -> list:
    """Phase 2d: DoorKey's ``generate`` on the card against the plain
    generator at GEN_SIZES and GEN_CHECK_B, then at DoorKey-8x8 and each of
    GEN_TIMED_B held against it again (the row's ``max_abs_err``) and timed
    in CUDA graphs: the kernel alone from fixed draws (20 launches a
    graph), the whole ``generate`` (the draws and the launch) and the plain
    generator (each captured with the generator registered and replayed),
    beside the kernel's bound by bytes.  A row's ``launches``: at the pool
    rollout's 262144 layouts ``pool_launches``, the kernel's launches in
    phase 2's rollout; at the regen step's 65536 those of a short regen
    rollout at that batch (its start layouts, the capture's warm-up and
    the capture).  Returns the kernels-line rows."""
    from minigrid_dynamicprogramming_tpu_torch.envs import doorkey
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
    from minigrid_dynamicprogramming_tpu_torch.utils import profiling

    dev = torch.device(DEVICE)
    launches = profiling.counter("generator.kernel.launches")
    checked = 0
    for n in GEN_SIZES:
        env = make(f"MiniGrid-DoorKey-{n}x{n}-v0")
        require(doorkey.generate_path(env, dev) == "kernel", f"DoorKey-{n}x{n} takes the kernel")
        for b in GEN_CHECK_B:
            g = gen(70 + n)
            h = torch.Generator(device=DEVICE).set_state(g.get_state())
            tree_equal(env.generate(g, env.params, b, dev),
                       doorkey.generate_plain(h, env.params, b, dev),
                       f"DoorKey-{n}x{n} B={b}: the kernel's layouts against the plain generator")
            require(torch.equal(next_draw(g), next_draw(h)),
                    f"DoorKey-{n}x{n} B={b}: the generator's next draw")
            checked += b
    require(profiling.counter("generator.kernel.launches") - launches == len(GEN_SIZES) * len(
        GEN_CHECK_B), "one launch a generate")

    def replayed_ms(fn, g) -> float:
        graph, _, _ = L.capture_step(fn, fn, dev, g)
        try:
            return cuda_ms(graph.replay, 20)
        finally:
            graph.reset()

    env = make(ENV_ID)
    params, rows = env.params, []
    before = profiling.counter("generator.kernel.launches")
    L.lane_rollout(env, gen(8), ROLLOUT_B, 8, "regen", device=DEVICE)
    torch.cuda.synchronize()
    regen_launches = profiling.counter("generator.kernel.launches") - before
    require(regen_launches == 3, "a regen rollout launches the generator kernel 3 times")
    main_path = {ROLLOUT_B: regen_launches, ROLLOUT_B * POOL_ROUNDS: pool_launches}
    for b in GEN_TIMED_B:
        g = gen(9)
        h = torch.Generator(device=DEVICE).set_state(g.get_state())
        got, want = env.generate(g, params, b, dev), doorkey.generate_plain(h, params, b, dev)
        tree_equal(got, want, f"DoorKey-8x8 B={b}: the kernel's layouts against the plain generator")
        err = max(float((getattr(got, f.name).double() - getattr(want, f.name).double()).abs().max())
                  for f in dataclasses.fields(want))
        require(torch.equal(next_draw(g), next_draw(h)), f"DoorKey-8x8 B={b}: the next draw")
        del got, want
        draws = dict(split=torch.randint(2, params.width - 2, (b,), generator=g, device=dev,
                                         dtype=torch.int32),
                     agent_u=torch.rand(b, generator=g, device=dev),
                     agent_dir=torch.randint(0, 4, (b,), generator=g, device=dev,
                                             dtype=torch.int32),
                     door=torch.randint(1, params.width - 2, (b,), generator=g, device=dev,
                                        dtype=torch.int32),
                     key_u=torch.rand(b, generator=g, device=dev))
        kernel_ms = graphed_ms(lambda: doorkey.layouts_kernel(params, **draws), n=20)
        generate_ms = replayed_ms(lambda: env.generate(g, params, b, dev), g)
        plain_ms = replayed_ms(lambda: doorkey.generate_plain(g, params, b, dev), g)
        bound_ms, bound_by = bound(gen_bytes(params, b), 0)
        rows.append({
            "name": f"doorkey_gen_b{b}", "route": "cuda", "source": f"{CSRC}/doorkey_gen.cu",
            "replaces": None, "launches": main_path.get(b), "max_abs_err": err, "ms": kernel_ms,
            "generate_ms": generate_ms, "plain_ms": plain_ms, "plain_graphed_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_only_ms": kernel_ms, "layouts": b, "checked_layouts": checked,
            "design": "a block of 128 layouts: a thread a layout computes its placements into "
            "shared memory and writes its scalars; then the block writes each field as one "
            "contiguous span in 16-byte words, each word's cells computed from the placements",
            "compiled": compiled(ptxas, "doorkey_gen_kernel"),
        })
        print(
            f"[doorkey_gen] B={b} DoorKey-8x8: equal to the plain generator bit for bit at "
            f"DoorKey {', '.join(map(str, GEN_SIZES))} ({checked} layouts) and here, max|kernel - "
            f"plain| {err:.3g}; main-path launches {main_path.get(b)}; kernel {kernel_ms:.5f} "
            f"ms in a graph, bound {bound_ms:.5f} ms by {bound_by} ({kernel_ms / bound_ms:.2f}x); "
            f"generate {generate_ms:.5f} ms, plain generator {plain_ms:.4f} ms, both graphed; "
            f"{rows[-1]['compiled']}",
            flush=True,
        )
        del draws
    return rows


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


def family_rollouts(make, L, card: str, ids, runs: dict, seed: int, workers,
                    against_eager: bool = False) -> dict:
    """Phases 6, 8 and 11: each id at its ``runs`` size (else FAMILY_OTHER);
    with ``against_eager`` (phase 6), the graphed rollout against
    ``_lane_scan_eager`` on the same pool from the same generator state,
    bit for bit, the generators' next draws too;
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
        before = capture_counts()
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
        capture = captured_since(before)
        entry["capture_ms"], entry["graph_pool_bytes"] = capture["capture_ms"], capture["graph_pool_bytes"]
        before = capture_counts()
        # The same pool and the run's actions, drawn again from the
        # generator's state (hooks that draw nothing leave it alone).
        t0 = time.perf_counter()
        if pooled:
            flat, accepted = env.generate(g_again, env.params, R * B, DEVICE, return_accepted=True)
            pool = L.stack_rounds(flat, B, R)
            entry["accepted_attempts"] = int(accepted)
            if "MultiRoom" in env_id:
                require(int(accepted) >= R * B, f"{env_id}: {int(accepted)} attempts chained "
                        f"every room, at least the {R * B} layouts of the pool")
            del flat
        else:
            pool = L.lane_pool(env, g_again, B, "pool", R, dev)
        if against_eager:
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t0
            g_eager = torch.Generator(device=DEVICE).set_state(g_again.get_state())
            t1 = time.perf_counter()
            eager = L._lane_scan_eager(env, g_eager, pool, B, T, "pool", R)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t1
            require(captured_since(before)["captures"] == 0, f"{env_id}: the eager loop captures nothing")
            rollouts_equal(L, res, eager, f"{env_id}: graphed against eager")
            require(torch.equal(next_draw(g), next_draw(g_eager)),
                    f"{env_id}: the generators' next draws equal")
            entry["graphed_ms_per_step"] = 1e3 * (s - pool_s) / T
            entry["eager_ms_per_step"] = 1e3 * eager_s / T
            del eager
            t0 = time.perf_counter()
        if env.hooks_draw:
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
            final = res.final_state.map(lambda x: x[..., :CPU_LANES])
            on_card = replay_summary(L, env.params, final, res.resets_per_env[:CPU_LANES])
            sub = vars(pool.map(lambda x: x[..., :CPU_LANES].cpu().numpy()))
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
            + f"; replay queued in {entry['check_s']:.3f} s"
            + (f"; equal to the eager loop, ms a step graphed {entry['graphed_ms_per_step']:.4f} "
               f"(capture {entry['capture_ms']:.3f} ms, pool {entry['graph_pool_bytes']} bytes), "
               f"eager {entry['eager_ms_per_step']:.4f}" if against_eager else ""),
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
    ls = pool.round(0)
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
    require(r_err == 0.0, f"{env.env_id}: returns equal to env_return")
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
    for seed, (env_id, doors, batch, more_doors) in enumerate(KEY_FAMILIES):
        fam = make(env_id)

        def path():
            states = fam.generate(gen(7 + seed), fam.params, batch, device=DEVICE)
            fits = (states.grid_obj == OBJ_DOOR).sum(dim=(1, 2)) <= doors
            require(more_doors or bool(fits.all()), f"{env_id}: every layout has at most {doors} doors")
            states = dataclasses.replace(states, **{k: t[fits] for k, t in states.__dict__.items()})
            # The families' hooks name the target in aux slots 0-1; LockedRoom's is its goal.
            target = (-1, -1) if "LockedRoom" in env_id else (states.aux[:, 0], states.aux[:, 1])
            layouts = TK.extract_key_layout(states, doors, *target)
            return states, layouts, cuda_vi.cuda_key_value_iteration(
                layouts, GAMMA, KEY_FAMILY_SWEEPS
            )

        (states, layouts, v), counts = drive(f"key-domain VI, {env_id}, max_doors={doors}", path)
        b, K, C, _, h, w = v.shape
        print(f"[key_families] {env_id}: {b} of {batch} layouts have at most {doors} doors", flush=True)
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
        entry = {"env": env_id, "max_doors": doors, "layouts": b, "generated": batch, "K": K, "C": C,
                 "grid": f"{w}x{h}", "route": route, "cluster": n, "max_abs_err": err, **greedy}
        print(f"[key_families] {entry}", flush=True)
        out.append(entry)
        del policy
        masks = cuda_vi.key_vi_masks(layouts)
        if route == "wide":
            in_place = cuda_vi.key_vi_wide_in_place(C, h * w, n)
            G = cuda_vi.key_vi_wide_groups(h * w)
            design = dict(
                design=WIDE_DESIGN + ("; swept in place" if in_place else "; double-buffered")
                + "; grid size given at run time",
                cluster=n, groups=G, threads_per_cta=G * h * w, in_place=in_place,
                active_clusters=cuda_vi.key_vi_wide_active_clusters(C, h, w, n),
                shared_bytes=cuda_vi.key_vi_wide_shared_bytes(C, h * w, n, in_place),
                compiled=compiled(ptxas, f"key_vi_wide_kernelILb{int(in_place)}E"),
            )
        elif route == "cluster":
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
            design = grid_design(C, h, w, n, ptxas)
        kernel_row(
            f"key_vi_{env_id.removeprefix('MiniGrid-').removesuffix('-v0')}",
            f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts["key_vi"], err,
            lambda: cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY_FAMILY_SWEEPS),
            lambda: cuda_vi._key_vi_kernel(masks, GAMMA, KEY_FAMILY_SWEEPS, v.shape),
            lambda: TK.key_vi_values(layouts, GAMMA, KEY_FAMILY_SWEEPS),
            cuda_vi.key_vi_work(layouts, KEY_FAMILY_SWEEPS), reps=3 if route == "grid" else 5,
            kernel_route=route, route_launches={r: counts[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
            shape=f"{b} layouts {w}x{h}, {KEY_FAMILY_SWEEPS} sweeps, "
            f"max_doors {doors} (K={K}, C={C})",
            **design,
        )
        del states, layouts, v, masks
    return out


def obstructed_families(make) -> list:
    """Phase 10: the obstructed domain on the card, its greedy policy
    stepped, its V held against the CPU's on the first layouts."""
    import dataclasses

    import bench_torch
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BOX
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_obstructed as TO
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    out = []
    for seed, env_id in enumerate(OBSTRUCTED):
        fam = make(env_id)
        states = fam.generate(gen(9 + seed), fam.params, OBS_B, device=DEVICE)
        if "BlockedUnlockPickup" in env_id:  # the box, as the bench picks it
            t_type, t_color = OBJ_BOX, bench_torch._first_object(states, OBJ_BOX)
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

    import bench_torch
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular as T
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_twokey as TT
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    env = make(TWOKEY_ENV)
    states = env.generate(gen(11), env.params, TWOKEY_B, device=DEVICE)
    balls = (states.grid_obj == OBJ_BALL).reshape(TWOKEY_B, -1)
    require(bool((balls.sum(dim=1) == 1).all()), f"{TWOKEY_ENV}: one ball a layout")
    layouts = TT.extract_twokey_layout(states, 2, OBJ_BALL, bench_torch._first_object(states, OBJ_BALL))
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

    graphs = {}

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
        require(ppo.captures == {"collector": 1, "learner": int(epochs > 0)},
                f"one capture of each graph over {PPO_WARMUP + PPO_TIMED} updates: {ppo.captures}")
        graphs[f"epochs_{epochs}"] = {"capture_ms": ppo.capture_ms, "pool_bytes": ppo.pool_bytes}
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
        "peak_bytes": peak, "graphs": graphs, "card": card,
    }
    print(f"[ppo_throughput] {out}", flush=True)
    return out


def ppo_runs(make, ways) -> list:
    """One PPO run at the throughput size from seed 3 for each of
    ``ways`` (True: graphed, ``update``; False: eager, ``_update_eager``),
    two updates each; for each, its seconds of the first update, what the
    first update collected (every trajectory buffer, the final state, the
    reset counts, the generator's next draw) and, after the second, the
    parameters and Adam's state."""
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.models import ppo as P

    cfg = PPOConfig(num_envs=PPO_B, rollout_len=PPO_T, epochs=2, num_minibatches=PPO_MB)
    runs = []
    for graphed in ways:
        ppo = PPO(make(PPO_ENV), cfg, device=DEVICE)
        ts = ppo.init(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = ppo.update(ts) if graphed else ppo._update_eager(ts)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first = [*(x.clone() for x in P._traj_tensors(ppo._traj)),
                 *(torch.from_numpy(v) for v in state_numpy(ts.env_state).values()),
                 ts.reset_count.clone(),
                 next_draw(torch.Generator(device=DEVICE).set_state(ts.generator.get_state()))]
        require(int(ts.reset_count.sum()) > 0, "lanes reset")
        ts, m = ppo.update(ts) if graphed else ppo._update_eager(ts)
        require(all(np.isfinite([float(x) for x in m])), f"finite metrics {[float(x) for x in m]}")
        require(ppo.captures == ({"collector": 1, "learner": 1} if graphed
                                 else {"collector": 0, "learner": 0}), f"captures {ppo.captures}")
        params = list(ts.model.parameters())
        state = [x.detach().clone() for x in
                 (*params, *(v for p in params for v in ts.optimizer.state[p].values()))]
        runs.append((first_s, first, state))
        del ppo, ts
    return runs


def ppo_graph_against_eager(make, card: str) -> dict:
    """Phase 14a: PPO graphed against eager at the throughput size, then
    ``profile_torch.profile_ppo``'s graphed and eager parts."""
    import profile_torch

    def diffs(a, b) -> tuple:
        """max |a - b| and its mean over every element."""
        d = [(x.double() - y.double()).abs() for x, y in zip(a, b)]
        return max(float(x.max()) for x in d), sum(float(x.sum()) for x in d) / sum(x.numel() for x in d)

    # PyTorch's default algorithms, as PPO runs: the embeddings' backward
    # sums with atomics, so the learners of two eager runs differ.
    runs = ppo_runs(make, [True] + [False] * PPO_SPREAD_RUNS)
    (_, g_first, g_state), eager = runs[0], runs[1:]
    for k, (_, e_first, _) in enumerate(eager):
        require(all(torch.equal(x, y) for x, y in zip(g_first, e_first)),
                f"the first update's trajectory, state, resets and next draw, graphed against "
                f"eager run {k + 1}")
    pairs = [diffs(a[2], b[2]) for i, a in enumerate(eager) for b in eager[:i]]
    spread = (max(p[0] for p in pairs), max(p[1] for p in pairs))
    diff = min((diffs(g_state, e[2]) for e in eager), key=lambda d: d[1])
    print(f"[ppo graph] {PPO_B} envs, T={PPO_T}, default algorithms: the first update's "
          f"trajectory, state, resets and next draw equal bit for bit (graphed, then "
          f"{PPO_SPREAD_RUNS} eager); after two updates, params and Adam state, graphed against "
          f"the nearest eager run max {diff[0]:.6g} mean {diff[1]:.6g}, eager against eager max "
          f"{spread[0]:.6g} mean {spread[1]:.6g}; first update s "
          + ", ".join(f"{r[0]:.3f}" for r in runs) + f" ({card})", flush=True)
    require(diff[0] == 0 if spread[0] == 0 else diff[1] <= 2 * spread[1],
            "the graphed learner within the eager runs' spread (mean over every element)")
    out = {"default": {"max_diff": diff[0], "mean_diff": diff[1], "eager_max_spread": spread[0],
                       "eager_mean_spread": spread[1], "first_update_s": [r[0] for r in runs]}}
    del runs, g_state, eager

    # Deterministic algorithms: graphed and eager equal bit for bit.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = ppo_runs(make, [True, False])
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(torch.equal(x, y) for x, y in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2])),
            "with deterministic algorithms, the graphed update equal to the eager one bit for bit "
            "(trajectory, state, resets, next draw; params and Adam state after two updates)")
    print(f"[ppo graph] deterministic algorithms: graphed and eager equal bit for bit, "
          f"params and Adam state after two updates included; first update s "
          + ", ".join(f"{r[0]:.3f}" for r in runs), flush=True)
    out["deterministic_first_update_s"] = [r[0] for r in runs]
    del runs
    # The collector under the profiler; the learner, the update and the
    # eager remainder on the host clock (profile_torch.py traces them).
    out["profile"] = profile_torch.profile_ppo({}, PPO_B, PPO_T, trace_learner=False)
    out["card"] = card
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
    require(ppo.captures == {"collector": 1, "learner": 1}, f"one capture of each graph: {ppo.captures}")
    out = {"env": env_id, "solved_at": solved_at, "s": time.perf_counter() - t0, "curve": curve,
           "capture_ms": ppo.capture_ms, "pool_bytes": ppo.pool_bytes}
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
    count tables and rewards bit for bit, "angle" of
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
            tree_equal(c_out[2], p_out[2], f"{what} reward")
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


def free_address() -> str:
    from minigrid_dynamicprogramming_tpu_torch.parallel.scaling import free_port

    return f"127.0.0.1:{free_port()}"


def params_diff(a, b) -> float:
    """The largest difference between two models' parameters."""
    with torch.no_grad():
        return max(float((p - q).abs().max()) for p, q in zip(a.parameters(), b.parameters()))


def learner_ms(ppo, ts) -> tuple:
    """The learner's part of one more update on the next rollout (GAE,
    the all-gather with a group, the permutations, the minibatch steps,
    the metrics): its ms on CUDA events and its peak device bytes."""
    c = ppo._run_collector(ts, eager=False)
    _, last_obs = ppo._final(c)
    with torch.no_grad():
        _, last_value = ts.model(last_obs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    ppo._learn(ts, c.traj, last_value)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), torch.cuda.max_memory_allocated()


def learn_trajectory(seed: int = 0) -> dict:
    """A ``(T, B)`` trajectory of valid Empty-5x5 observations and random
    outcomes, and its last values, made with numpy (as the CPU tests'
    ``tests/test_torch_ppo_distributed.py`` makes one); each key starts
    with ``traj_``."""
    rng = np.random.default_rng(seed)
    T, B = GLOO_LEARN_T, GLOO_LEARN_B
    image = np.stack([rng.integers(0, 11, (T, B, 7, 7)), rng.integers(0, 6, (T, B, 7, 7)),
                      rng.integers(0, 3, (T, B, 7, 7))], axis=-1).astype(np.uint8)
    data = {
        "obs_image": image,
        "obs_direction": rng.integers(0, 4, (T, B)).astype(np.int32),
        "obs_mission": rng.integers(0, 5, (T, B, 48)).astype(np.int32),
        "actions": rng.integers(0, 7, (T, B)).astype(np.int64),
        "logps": np.log(rng.uniform(0.05, 0.5, (T, B))).astype(np.float32),
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "rewards": (rng.random((T, B)) * (rng.random((T, B)) < 0.3)).astype(np.float32),
        "dones": rng.random((T, B)) < 0.2,
        "last": rng.normal(size=B).astype(np.float32),
    }
    return {"traj_" + k: v for k, v in data.items()}


def learn_on_trajectory(data: dict, group, device):
    """``PPO._learn`` on ``learn_trajectory``'s data at f32 compute (the
    rank's slice of its envs with a ``group``); returns the metrics, the
    flat parameters and the PPO's captures.  The gloo ranks import it.
    The compute is float32 as on the CPU: no TF32 in the convolutions and
    matrix products, and deterministic algorithms (no atomic sums in the
    embeddings' backward), each flag put back after."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
    from minigrid_dynamicprogramming_tpu_torch.models.nets import ActorCritic, init_params

    cfg = PPOConfig(num_envs=GLOO_LEARN_B, rollout_len=GLOO_LEARN_T, epochs=2,
                    num_minibatches=GLOO_LEARN_MB)
    ppo = PPO(make(GLOO_ENV), cfg, device=device, group=group)
    model = init_params(ActorCritic(num_actions=ppo.env.action_dim, compute_dtype=torch.float32),
                        torch.Generator().manual_seed(GLOO_LEARN_SEED)).to(ppo.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5, capturable=True)
    ts = ppo.init(GLOO_LEARN_SEED)._replace(model=model, optimizer=optimizer)
    lanes = slice(None) if group is None else group.slice(cfg.num_envs)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(data["traj_" + name][:, lanes])).to(ppo.device)

    traj = tppo.Trajectory(obs={k: t("obs_" + k) for k in ("image", "direction", "mission")},
                           **{k: t(k) for k in tppo.Trajectory._fields[1:]})
    last = torch.from_numpy(np.ascontiguousarray(data["traj_last"][lanes])).to(ppo.device)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        m = ppo._learn(ts, traj, last)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags[:2]
        torch.use_deterministic_algorithms(flags[2])
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()
    return np.array([float(x) for x in m]), params, dict(ppo.captures)


def one_rank_nccl(make, card: str) -> dict:
    """Phase 18, first leg: a one-rank NCCL group against the ungrouped
    path on the same card."""
    import torch.distributed as dist

    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
    from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import rank_seed, sharded_keys

    distributed.initialize(free_address(), 1, 0, local_device_ids=[0], max_retries=1,
                           backend="nccl", timeout_s=GLOO_TIMEOUT_S)
    try:
        group = distributed.global_env_group()
        print(f"[nccl] {distributed.process_summary()} backend {dist.get_backend()} on {group.device}",
              flush=True)
        env = make(ENV_ID)
        out = {"rollout_s": []}
        runs = []
        # Grouped, ungrouped, grouped: the first run at this size also pays
        # for its allocations, so the times compare from the second on.
        for grouped in (True, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if grouped:
                runs.append(L.lane_rollout(env, sharded_keys(0, group), NCCL_B, NCCL_T, "pool",
                                           POOL_ROUNDS, group=group))
            else:
                runs.append(L.lane_rollout(env, gen(rank_seed(0, 0)), NCCL_B, NCCL_T, "pool",
                                           POOL_ROUNDS, device=DEVICE))
            torch.cuda.synchronize()
            out["rollout_s"].append(time.perf_counter() - t0)
        b = runs[1]
        for a in (runs[0], runs[2]):
            tree_equal(a.final_state, b.final_state, "one-rank NCCL rollout, final state")
            for f in ("resets_per_env", "total_reward", "episodes", "obs_checksum", "successes", "failures"):
                require(torch.equal(getattr(a, f), getattr(b, f)), f"one-rank NCCL rollout: {f} equal")
        require(int(b.episodes) > 0, "the NCCL rollout ended episodes")
        out.update(episodes=int(b.episodes), steps=b.steps)
        del runs, a, b

        # PPO at config 5's width: the grouped update (the trajectory
        # all-gathered, the learner's all-reduces in its graph) equals the
        # ungrouped one from the same seed bit for bit, with deterministic
        # algorithms (the embeddings' backward sums with atomics
        # otherwise).  Then each learner once more, timed.
        cfg = PPOConfig(num_envs=NCCL_PPO_B, rollout_len=PPO_T, epochs=2, num_minibatches=PPO_MB)
        params, metrics, ms, peaks, learn_peaks, gathered, captures = [], [], [], [], [], [], []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for grp in (None, group):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ppo = PPO(make(PPO_ENV), cfg, device=DEVICE, group=grp)
                ts, m = ppo.update(ppo.init(3))
                metrics.append([float(x) for x in m])
                params.append([p.detach().clone() for p in ts.model.parameters()])
                peaks.append(torch.cuda.max_memory_allocated())
                t, peak = learner_ms(ppo, ts)
                ms.append(t)
                learn_peaks.append(peak)
                gathered.append(ppo.gather_bytes)
                captures.append(dict(ppo.captures))
                # Both loops graphed at one rank, the grouped learner's
                # all-reduces captured in its graph.
                require(ppo.captures == {"collector": 1, "learner": 1}, f"PPO captures {ppo.captures}")
                del ppo, ts
        finally:
            torch.use_deterministic_algorithms(False)
        grouped_diff = max(float((p - q).abs().max()) for p, q in zip(params[1], params[0]))
        out.update(ppo_grouped_diff=grouped_diff, ppo_metrics=metrics, ppo_num_envs=NCCL_PPO_B,
                   learner_ms={"ungrouped": ms[0], "grouped": ms[1]},
                   peak_bytes={"ungrouped": peaks[0], "grouped": peaks[1]},
                   learner_peak_bytes={"ungrouped": learn_peaks[0], "grouped": learn_peaks[1]},
                   gather_bytes=gathered[1], ppo_captures=captures)
        print(f"[nccl] PPO update, {NCCL_PPO_B} envs, T={PPO_T}: max|param diff| grouped-ungrouped "
              f"{grouped_diff:.4g}; learner ms an update ungrouped {ms[0]:.4f} grouped {ms[1]:.4f}; "
              f"gathered {gathered[1]} B; peak of the first update {peaks[0]} / {peaks[1]} B, "
              f"of the timed learner {learn_peaks[0]} / {learn_peaks[1]} B; captures {captures}; "
              f"metrics {metrics}", flush=True)
        require(gathered[0] == 0 and gathered[1] > 0, "the grouped learner all-gathers")
        require(all(np.isfinite(metrics[-1])), "finite one-rank NCCL PPO metrics")
        require(grouped_diff == 0, "the one-rank NCCL update equal to the ungrouped one bit for bit")
    finally:
        dist.destroy_process_group()
    print(f"[nccl] {out}", flush=True)
    return out


# One rank of the two-rank gloo group, both on cuda:0 (NCCL refuses two
# ranks on one card); it imports only the port and this script's learner.
GLOO_WORKER = f"""
import sys
sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})
import numpy as np
import torch
from chip_smoke import learn_on_trajectory
from minigrid_dynamicprogramming_tpu_torch import make
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

addr, rank, inputs, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
distributed.initialize(addr, 2, rank, local_device_ids=[0], max_retries=1, backend="gloo",
                       timeout_s={GLOO_TIMEOUT_S})
group = distributed.global_env_group()
assert group.device == torch.device("cuda:0"), group
data = np.load(inputs)
pool = from_numpy(L.LaneState, {{k[5:]: data[k] for k in data.files if k.startswith("pool_")}}, group.device)
actions = torch.from_numpy(data["actions"]).to(group.device)
res = L._lane_scan(make("{GLOO_ENV}"), None, L.shard_lanes(pool, group), {GLOO_B} // 2, {GLOO_T}, "pool",
                   {POOL_ROUNDS}, L.shard_batch(actions, group, axis=1), group)
ppo = PPO(make("{PPO_ENV}"), PPOConfig(num_envs=4, rollout_len=8), group=group)
ts, m = ppo.update(ppo.init(1))
learn_metrics, learn_params, learn_captures = learn_on_trajectory(data, group, None)
np.savez(
    out,
    **{{"final_" + k: v for k, v in to_numpy(res.final_state).items()}},
    resets=res.resets_per_env.cpu().numpy(),
    scalars=np.array([int(res.episodes), int(res.successes), int(res.failures), int(res.obs_checksum)]),
    total_reward=res.total_reward.cpu().numpy(),
    ppo_metrics=np.array([float(x) for x in m]),
    ppo_params=torch.cat([p.detach().reshape(-1).float() for p in ts.model.parameters()]).cpu().numpy(),
    ppo_captures=np.array([ppo.captures["collector"], ppo.captures["learner"]]),
    learn_metrics=learn_metrics, learn_params=learn_params,
    learn_captures=np.array([learn_captures["collector"], learn_captures["learner"]]),
)
torch.distributed.destroy_process_group()
print("gloo rank", rank, "ok", flush=True)
"""


def two_rank_gloo(make) -> dict:
    """Phase 18, second leg: two gloo ranks spawned on the one card,
    against the one-process run on the same pool and action script."""
    import os
    import tempfile

    from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    env = make(GLOO_ENV)
    pool = L.lane_pool(env, gen(11), GLOO_B, "pool", POOL_ROUNDS, torch.device(DEVICE))
    actions = np.random.default_rng(11).integers(0, env.action_dim, (GLOO_T, GLOO_B)).astype(np.int64)
    single = L._lane_scan(env, None, pool, GLOO_B, GLOO_T, "pool", POOL_ROUNDS,
                          torch.from_numpy(actions).to(DEVICE))
    data = learn_trajectory()
    want_metrics, want_params, one_captures = learn_on_trajectory(data, None, DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, actions=actions, **data, **{"pool_" + k: v for k, v in to_numpy(pool).items()})
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        addr = free_address()
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([sys.executable, "-c", GLOO_WORKER, addr, str(r), inputs, outs[r]],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)
        ]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=GLOO_TIMEOUT_S + 60)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for r, (proc, log) in enumerate(zip(procs, logs)):
            require(proc.returncode == 0, f"gloo rank {r} exited {proc.returncode}:\n{log[-4000:]}")
        dumps = [dict(np.load(o)) for o in outs]
    s = time.perf_counter() - t0
    want_final = to_numpy(single.final_state)
    want_scalars = [int(single.episodes), int(single.successes), int(single.failures),
                    int(single.obs_checksum)]
    want_resets = single.resets_per_env.cpu().numpy()
    half = GLOO_B // 2
    for r, d in enumerate(dumps):
        lanes = slice(r * half, (r + 1) * half)
        for name, want in want_final.items():
            require(np.array_equal(d["final_" + name], want[..., lanes]), f"gloo rank {r}: {name} equal")
        require(np.array_equal(d["resets"], want_resets[lanes]), f"gloo rank {r}: resets equal")
        require(d["resets"].sum() > 0, f"gloo rank {r} ended episodes")
        require(d["scalars"].tolist() == want_scalars, f"gloo rank {r}: summed scalars equal")
        rel = abs(float(d["total_reward"]) - float(single.total_reward)) / abs(float(single.total_reward))
        require(rel <= REWARD_RTOL, f"gloo rank {r}: total reward within {REWARD_RTOL} relative")
        require(np.isfinite(d["ppo_metrics"]).all(), f"gloo rank {r}: finite PPO metrics")
    require(np.array_equal(dumps[0]["total_reward"], dumps[1]["total_reward"]), "total reward equal on both ranks")
    require(np.array_equal(dumps[0]["ppo_metrics"], dumps[1]["ppo_metrics"]), "PPO metrics equal on both ranks")
    require(np.array_equal(dumps[0]["ppo_params"], dumps[1]["ppo_params"]), "PPO parameters equal on both ranks")
    # The learner on the fixed trajectory: two eager gloo ranks against the
    # one-process learner on the card (graphed).
    learn_err = max(float(np.abs(d["learn_params"] - want_params).max()) for d in dumps)
    metric_err = max(float((np.abs(d["learn_metrics"] - want_metrics)
                            / np.maximum(np.abs(want_metrics), 1e-7 / GLOO_LEARN_RTOL)).max())
                     for d in dumps)
    captures = {"update": dumps[0]["ppo_captures"].tolist(), "learn": dumps[0]["learn_captures"].tolist(),
                "one_process_learn": [one_captures["collector"], one_captures["learner"]]}
    print(f"[gloo] _learn at {GLOO_LEARN_B} envs, minibatches of {GLOO_LEARN_B // GLOO_LEARN_MB}: "
          f"max|param diff| two ranks - one process {learn_err:.4g}, metrics rel {metric_err:.4g}; "
          f"captures [collector, learner] {captures}", flush=True)
    require(learn_err <= GLOO_LEARN_ATOL, f"gloo _learn parameters within {GLOO_LEARN_ATOL}")
    require(metric_err <= GLOO_LEARN_RTOL, f"gloo _learn metrics within {GLOO_LEARN_RTOL} relative")
    for d in dumps:
        require(d["ppo_captures"].tolist() == [1, 0] and d["learn_captures"].tolist() == [0, 0],
                "gloo: the collector graphed, the learner eager by rule")
    require(one_captures == {"collector": 0, "learner": 1}, "the one-process learner graphed")
    out = {"s": s, "scalars": want_scalars, "total_reward": float(single.total_reward),
           "ppo_metrics": dumps[0]["ppo_metrics"].tolist(), "learn_param_err": learn_err,
           "learn_metric_rel_err": metric_err, "captures": captures}
    print(f"[gloo] two ranks on one card, {GLOO_ENV} B={GLOO_B} T={GLOO_T}: slices equal, {out}", flush=True)
    return out


def multi_device(make, card: str) -> dict:
    """Phase 18."""
    from minigrid_dynamicprogramming_tpu_torch.parallel.scaling import measure_scaling

    out = {"nccl": one_rank_nccl(make, card), "gloo": two_rank_gloo(make)}
    (pt,) = measure_scaling(ENV_ID, SCALING_B, SCALING_T, device_counts=[1], device=DEVICE)
    out["scaling"] = {"n_devices": pt.n_devices, "batch": pt.batch, "horizon": SCALING_T,
                      "steps_per_s": pt.steps_per_s, "card": card}
    print(f"[scaling] one rank: {out['scaling']}", flush=True)
    return out


def host_tools(make, card: str) -> dict:
    """Phase 19."""
    import tempfile

    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.utils import checkpoint as ckpt
    from minigrid_dynamicprogramming_tpu_torch.utils.debug import pprint_state, state_hash
    from minigrid_dynamicprogramming_tpu_torch.utils.guards import checked_step, debug_mode
    from minigrid_dynamicprogramming_tpu_torch.utils.telemetry import generation_acceptance

    out = {}
    env = make(ENV_ID)
    _, state = env.reset(gen(20), GUARD_B, DEVICE)
    step, g = checked_step(env), gen(21)
    t0 = time.perf_counter()
    for _ in range(GUARD_T):
        act = torch.randint(0, env.action_dim, (GUARD_B,), generator=g, device=DEVICE)
        err, (_, state, *_) = step(state, act, g)
        require(err.get() is None, f"checked_step: {err.get()}")
    out["checked_step_ms"] = 1e3 * (time.perf_counter() - t0) / GUARD_T
    pos = state.agent_pos.clone()
    pos[7] = torch.tensor([99, 1], device=DEVICE)
    err, _ = step(state.replace(agent_pos=pos), 0, g)
    require(err.get() == "agent position out of bounds", f"the corrupted state caught ({err.get()})")

    x = torch.zeros(4, device=DEVICE)
    try:
        with debug_mode():
            x / x
        tripped = None
    except FloatingPointError as e:
        tripped = str(e)
    require(tripped is not None and "aten.div" in tripped, f"debug_mode tripped on a NaN ({tripped})")
    out["debug_mode"] = tripped

    ppo = PPO(make(PPO_ENV), PPOConfig(num_envs=CKPT_B, rollout_len=CKPT_T), device=DEVICE)
    ts, _ = ppo.update(ppo.init(0))
    with tempfile.TemporaryDirectory() as tmp:
        meta = ckpt.save(tmp, ts, env_state=ts.env_state)
        restored = ckpt.restore(tmp, ppo.init(1), env_state_of=lambda t: t.env_state)
    require(params_diff(ts.model, restored.model) == 0.0, "checkpoint: parameters equal")
    tree_equal(restored.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"],
               "checkpoint: optimizer state")
    tree_equal(restored.env_state, ts.env_state, "checkpoint: env state")
    tree_equal(restored.pool, ts.pool, "checkpoint: pool")
    for name in ("generator", "learner_generator"):
        require(torch.equal(getattr(restored, name).get_state(), getattr(ts, name).get_state()),
                f"checkpoint: {name} state equal")
    want = ppo._collect(ts)[3].actions
    require(torch.equal(ppo._collect(restored)[3].actions, want), "checkpoint: the next actions equal")
    out["checkpoint_digests"] = meta["env_digests"]
    del ppo, ts, restored

    out["telemetry"] = {}
    for env_id in TELEMETRY_IDS:
        rep = generation_acceptance(make(env_id), TELEMETRY_N, device=DEVICE)
        print(f"[telemetry] {rep}", flush=True)
        require(rep["mode"] == ("structural" if "DoorKey" in env_id else "loop"), f"{env_id}: mode")
        require(rep["accept_rate"] >= (0.99 if "MultiRoom" in env_id else 1.0), f"{env_id}: accept rate")
        out["telemetry"][env_id] = rep

    for env_id in HASH_IDS:
        e = make(env_id)
        st = e.generate(gen(22), e.params, HASH_B, DEVICE)
        cpu = tree_to(st, "cpu")
        for i in range(HASH_B):
            require(state_hash(st, i) == state_hash(cpu, i), f"{env_id}: state_hash card == CPU")
            require(pprint_state(st, i) == pprint_state(cpu, i), f"{env_id}: pprint_state card == CPU")
    print(f"[host tools] {out}", flush=True)
    return out


def cli_dp(card: str) -> tuple:
    """Phase 20: the CLI's --dp inside its --trace; returns (reports, the
    trace's kernel and range names found, the spans' names and counts)."""
    import collections
    import tempfile

    from minigrid_dynamicprogramming_tpu_torch import benchmark
    from minigrid_dynamicprogramming_tpu_torch.utils.profiling import SPANS_FILE, TRACE_FILE

    with tempfile.TemporaryDirectory() as tmp:
        reports = benchmark.main([
            "--env-id", ENV_ID, "--num-resets", "2", "--num-frames", "2", "--batch", "256",
            "--horizon", "8", "--dp", "--trace", tmp,
        ])
        with open(f"{tmp}/{TRACE_FILE}") as f:
            events = json.load(f)["traceEvents"]
        with open(f"{tmp}/{SPANS_FILE}") as f:
            records = json.load(f)["records"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    names = {e.get("name") for e in events}
    vi = sorted(k for k in kernels if "vi_kernel" in k)
    cli_spans = ("dp/layouts", "dp/value_iteration", "reset", "regen_rollout", "lane_rollout")
    ranges = sorted(n for n in cli_spans if n in names)
    spans = collections.Counter(r["name"] for r in records)
    print(f"[cli --dp] {len(events)} trace events, {len(kernels)} kernel names; B1: {vi}; ranges {ranges}; "
          f"spans {dict(spans)}", flush=True)
    require(vi, "the trace holds B1's kernel")
    require(len(ranges) == 5, "the trace holds the CLI's span ranges")
    require(all(spans[n] >= 1 for n in cli_spans), "spans.json holds the CLI's spans")
    # Each rollout (timed and warm-up) replays its stamped step graph.
    graphed = [r for r in records if r["name"] == "lanes.step" and r["attrs"].get("graph")]
    require(graphed and all(r["count"] == 8 and r["device_ms"] > 0 for r in graphed),
            "spans.json holds each rollout's in-graph step, 8 replays a call")
    bench = reports["benchmark"]
    print(f"[cli] batched_env_steps_per_s {bench['batched_env_steps_per_s']} (the regen rollout), "
          f"lane_env_steps_per_s {bench['lane_env_steps_per_s']} (the pool rollout), "
          f"{bench['batch']} envs x {bench['horizon']} steps ({card})", flush=True)
    require(bench["batched_env_steps_per_s"] > 0 and bench["lane_env_steps_per_s"] > 0,
            "the CLI reports both rollouts' rates")
    return reports, {"vi_kernels": vi, "ranges": ranges, "events": len(events), "spans": dict(spans),
                     "card": card}


def bench_line(card: str) -> dict:
    """Phase 21: ``bench_torch.main`` at BENCH_SIZES; its one JSON line,
    every key present, every rate and time finite, every rate positive."""
    import contextlib
    import io
    import math

    import bench_torch

    sizes = {**bench_torch.FULL, **BENCH_SIZES}
    require(sizes["horizon"] > 640, "the bench's DoorKey horizon crosses the step limit")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        line = bench_torch.main(sizes, device=DEVICE)
    lines = printed.getvalue().splitlines()
    require(len(lines) == 1 and json.loads(lines[0]) == line, "bench_torch printed one JSON line")
    extra = line["extra"]
    require(set(extra) == BENCH_KEYS, f"bench_torch's keys: {sorted(set(extra) ^ BENCH_KEYS)} differ")
    numbers = {"value": line["value"], **{k: v for k, v in extra.items() if k.endswith("_s")}}
    require(all(math.isfinite(v) for v in numbers.values()), f"finite bench numbers {numbers}")
    require(all(v > 0 for k, v in numbers.items() if k != "ppo_learner_s"), f"positive rates {numbers}")
    require(extra["device"]["name"] == torch.cuda.get_device_name(0), "the bench names the card")
    require(set(extra["spread"]) >= {"env_steps_per_s", "vi_d1_cuda_sweeps_per_s", "vi_key_cuda_sweeps_per_s"},
            "the bench reports the spread of its timed runs")
    require(extra["ppo_graphs"]["epochs_2"]["captures"] == {"collector": 1, "learner": 1}
            and extra["ppo_graphs"]["epochs_0"]["captures"] == {"collector": 1, "learner": 0},
            f"each PPO row captured each graph once: {extra['ppo_graphs']}")
    print(f"[bench_torch] at {BENCH_SIZES} ({card}): {lines[0]}", flush=True)
    return {"sizes": sizes, "line": line}


def generate_graph(env, b: int, seed: int):
    """``env.generate`` at ``b`` captured as a CUDA graph from a generator
    seeded ``seed`` (``lanes.capture_step``, the generator registered):
    returns (graph, the graph's output state, capture ms, pool bytes, the
    generator and its state before the first replay)."""
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    dev = torch.device(DEVICE)
    g = gen(seed)
    start = g.get_state()
    out = {}

    def step():
        out["state"] = env.generate(g, env.params, b, dev)

    graph, capture_ms, pool_bytes = L.capture_step(step, step, dev, g)
    return graph, out, capture_ms, pool_bytes, g, start


def regen_generators(make, ids, card: str) -> dict:
    """Phase 22a: each id's generate at REGEN_GEN_B captured once and
    replayed; the replay equal bit for bit to an eager call from the same
    generator state, and so is the generator's next draw.  Then
    REGEN_TIMED_IDS's generate at REGEN_TIMED_B, the replay and the eager
    call each timed with CUDA events."""
    out = {"B": REGEN_GEN_B, "ids": {}, "timed": {}, "card": card}
    for k, env_id in enumerate(ids):
        env = make(env_id)
        graph, got, capture_ms, pool_bytes, g, start = generate_graph(env, REGEN_GEN_B, 1000 + k)
        graph.replay()
        h = torch.Generator(device=DEVICE).set_state(start)
        tree_equal(got["state"], env.generate(h, env.params, REGEN_GEN_B, DEVICE),
                   f"{env_id}: generate graphed against eager")
        require(torch.equal(next_draw(g), next_draw(h)), f"{env_id}: the generator's next draw")
        graph.reset()
        out["ids"][env_id] = {"capture_ms": capture_ms, "pool_bytes": pool_bytes}
        del graph, got
    caps = [v["capture_ms"] for v in out["ids"].values()]
    pools = [v["pool_bytes"] for v in out["ids"].values()]
    print(f"[regen generate] {len(ids)} ids at B={REGEN_GEN_B}: each captured once, the replay "
          f"equal to eager bit for bit, generators too; capture ms {min(caps):.3f}-{max(caps):.3f} "
          f"(median {statistics.median(caps):.3f}), pool bytes {min(pools)}-{max(pools)} ({card})",
          flush=True)
    for env_id, row in out["ids"].items():
        print(f"[regen generate] {env_id}: capture {row['capture_ms']:.3f} ms, pool "
              f"{row['pool_bytes']} bytes")
    for env_id in REGEN_TIMED_IDS:
        env = make(env_id)
        graph, got, capture_ms, pool_bytes, g, _ = generate_graph(env, REGEN_TIMED_B, 7)
        graphed_ms = cuda_ms(graph.replay, 5)
        h = gen(8)
        eager_ms = cuda_ms(lambda: env.generate(h, env.params, REGEN_TIMED_B, DEVICE), 5)
        graph.reset()
        out["timed"][env_id] = {"graphed_ms": graphed_ms, "eager_ms": eager_ms,
                                "capture_ms": capture_ms, "pool_bytes": pool_bytes}
        print(f"[regen generate] {env_id} at B={REGEN_TIMED_B}: graphed {graphed_ms:.4f} ms, "
              f"eager {eager_ms:.4f} ms (CUDA events); capture {capture_ms:.3f} ms, pool "
              f"{pool_bytes} bytes ({card})", flush=True)
        del graph, got
    out["flood"] = flood_cost(make, card)
    return out


def flood_cost(make, card: str) -> dict:
    """Phase 22a's last row: the BabyAI flood fill (``objs_reachable``) on
    REGEN_TIMED_B BossLevel layouts at its fixed bound of sweeps, as a
    CUDA graph and eager (CUDA events), against the loop it replaced,
    which read a convergence check to the host every 16 sweeps and stopped
    at the first check after the fixed point: that loop's ms and sweeps on
    the same layouts, and its answer equal to the graph's."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_DOOR, OBJ_EMPTY, OBJ_WALL
    from minigrid_dynamicprogramming_tpu_torch.envs.babyai import level as BL
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    env = make("BabyAI-BossLevel-v0")
    states = env.generate(gen(11), env.params, REGEN_TIMED_B, DEVICE)
    obj = states.grid_obj
    b, h, w = obj.shape
    bound = (h * w) // 2 + 2
    got = {}

    def fixed():
        got["ok"] = BL.objs_reachable(states)

    def checked():
        """The replaced loop: ``objs_reachable`` with a check every 16
        sweeps; returns (its answer, the sweeps it ran)."""
        passable = (obj == OBJ_EMPTY) | (obj == OBJ_DOOR)
        ys = torch.arange(h, device=obj.device)[:, None]
        xs = torch.arange(w, device=obj.device)[None, :]
        reach = (xs == states.agent_pos[:, 0, None, None]) & (ys == states.agent_pos[:, 1, None, None])
        done = 0
        while done < bound:
            before = reach
            for _ in range(min(16, bound - done)):
                reach = reach | BL._adjacent(reach & passable)
            done = min(done + 16, bound)
            if torch.equal(reach, before):
                break
        is_obj = (obj != OBJ_EMPTY) & (obj != OBJ_WALL)
        return (~is_obj | reach).reshape(b, -1).all(dim=1), done

    graph, capture_ms, pool_bytes = L.capture_step(fixed, fixed, torch.device(DEVICE))
    row = {"env": "BabyAI-BossLevel-v0", "B": b, "grid": f"{w}x{h}", "sweeps": bound,
           "graphed_ms": cuda_ms(graph.replay, 5), "eager_ms": cuda_ms(fixed, 5),
           "checked_ms": cuda_ms(checked, 5), "capture_ms": capture_ms, "pool_bytes": pool_bytes,
           "card": card}
    want, row["checked_sweeps"] = checked()
    graph.replay()
    require(torch.equal(got["ok"], want), "the fixed-bound flood equal to the checked loop's")
    graph.reset()
    print(f"[regen flood] BossLevel {b} layouts {w}x{h}: {bound} sweeps graphed "
          f"{row['graphed_ms']:.4f} ms, eager {row['eager_ms']:.4f} ms; the replaced loop (a host "
          f"check every 16 sweeps) {row['checked_sweeps']} sweeps, {row['checked_ms']:.4f} ms "
          f"(CUDA events); equal answers ({card})", flush=True)
    return row


def regen_rollouts(make, card: str) -> list:
    """Phase 22b: each of REGEN_ROLLOUTS's regen rollouts, graphed and
    eager (``scan_graphed_and_eager``): ms a step of each (host clock, the
    capture included), the capture's ms and pool bytes; then
    ``profile_torch.profile_regen``'s kernels a step and busy share."""
    import profile_torch

    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    rows = []
    for k, (env_id, b, horizon) in enumerate(REGEN_ROLLOUTS):
        env = make(env_id)
        pool = L.lane_pool(env, gen(40 + k), b, "regen", 1, torch.device(DEVICE))
        g_s, e_s, e_res, capture = scan_graphed_and_eager(env, L, pool, b, horizon, "regen", 1,
                                                 gen(50 + k).get_state(), f"regen {env_id}")
        require(int(e_res.episodes) > 0, f"regen {env_id}: episodes")
        row = {"env": env_id, "B": b, "T": horizon, "graphed_ms_per_step": 1e3 * g_s / horizon,
               "eager_ms_per_step": 1e3 * e_s / horizon, **capture, "episodes": int(e_res.episodes),
               "min_resets": int(e_res.resets_per_env.min()), "card": card}
        print(f"[regen rollout] {env_id} B={b} T={horizon}: graphed and eager equal bit for bit, "
              f"generators too; ms a step graphed {row['graphed_ms_per_step']:.4f} (capture "
              f"included), eager {row['eager_ms_per_step']:.4f}; capture {row['capture_ms']:.3f} ms, "
              f"pool {row['graph_pool_bytes']} bytes; episodes {row['episodes']}, resets per lane "
              f">= {row['min_resets']} ({card})", flush=True)
        del pool, e_res
        row["profile"] = profile_torch.profile_regen({}, env_id, b, REGEN_PROFILE_STEPS,
                                                     trace_eager=False)
        rows.append(row)
    require(rows[0]["min_resets"] >= 1, "every lane of the main path's regen rollout reset")
    return rows


def regen_ppo(make, card: str) -> dict:
    """Phase 22c: PPO's regen collector on GoToDoor at the learning size,
    graphed (``update``) against eager (``_update_eager``) from the same
    seed: the first update's trajectory, final state, resets and the
    generator's next draw equal bit for bit.  Then a second update of
    each, timed on the host clock, and the graphed PPO's collector, per
    step, graphed (under the profiler: kernels, busy share) and eager."""
    import profile_torch

    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.models import ppo as P

    cfg = PPOConfig(num_envs=LEARN_B, rollout_len=LEARN_T, epochs=2, num_minibatches=PPO_MB,
                    autoreset="regen")
    runs, out = [], {"env": PPO_ENV, "num_envs": LEARN_B, "rollout_len": LEARN_T, "card": card}
    for graphed in (True, False):
        ppo = PPO(make(PPO_ENV), cfg, device=DEVICE)
        ts = ppo.init(3)
        update = ppo.update if graphed else ppo._update_eager
        seconds = []
        for k in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = update(ts)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if not k:
                first = [*(x.clone() for x in P._traj_tensors(ppo._traj)),
                         *(torch.from_numpy(v) for v in state_numpy(ts.env_state).values()),
                         ts.reset_count.clone(),
                         next_draw(torch.Generator(device=DEVICE).set_state(ts.generator.get_state()))]
        require(all(np.isfinite([float(x) for x in m])), f"finite metrics {[float(x) for x in m]}")
        require(int(ts.reset_count.sum()) > 0, "lanes reset")
        require(ppo.captures == ({"collector": 1, "learner": 1} if graphed
                                 else {"collector": 0, "learner": 0}), f"captures {ppo.captures}")
        way = "graphed" if graphed else "eager"
        out[f"update_s_{way}"] = seconds
        runs.append(first)
        if graphed:
            out.update(capture_ms=dict(ppo.capture_ms), pool_bytes=dict(ppo.pool_bytes))
            kept = ppo, ts
    require(all(torch.equal(x, y) for x, y in zip(*runs)),
            "PPO regen: the graphed first update's trajectory, state, resets and next draw equal "
            "to the eager one's bit for bit")
    ppo, ts = kept
    for eager in (False, True):
        way = "eager" if eager else "graphed"
        profile_torch.profiled(lambda: ppo._run_collector(ts, eager),
                               f"ppo regen collector {way}, per step", LEARN_T, out, not eager)
    print(f"[ppo regen] {PPO_ENV}, {LEARN_B} envs, T={LEARN_T}, 2 x {PPO_MB}: the first update "
          f"graphed and eager equal bit for bit (trajectory, state, resets, next draw); update s "
          f"graphed {out['update_s_graphed']} (the first captures), eager {out['update_s_eager']}; "
          f"captures ms {out['capture_ms']}, pools {out['pool_bytes']} bytes ({card})", flush=True)
    return out


def regen_phase(make, ids, card: str) -> dict:
    """Phase 22: the "regen" autoreset graphed (a, b, c above), with each
    part's seconds."""
    out, seconds = {}, {}
    for name, part in (("generators", lambda: regen_generators(make, ids, card)),
                       ("rollouts", lambda: regen_rollouts(make, card)),
                       ("ppo", lambda: regen_ppo(make, card))):
        t0 = time.perf_counter()
        out[name] = part()
        seconds[name] = time.perf_counter() - t0
    print(f"[regen] seconds {seconds}", flush=True)
    out["seconds"] = seconds
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
    from minigrid_dynamicprogramming_tpu_torch.utils import profiling

    counters = {"vi": "vi.launches", "key_vi": "key_vi.launches",
                **{f"key_vi_{r}": f"key_vi.launches.{r}" for r in cuda_vi.ROUTES}}

    def drive(part, fn):
        """Run one part of the main path; returns (fn's result, the launches
        it added to ``utils/profiling.py``'s counters), the key-domain
        kernel's split by route as "key_vi_<route>"."""
        before = {name: profiling.counter(c) for name, c in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        counts = {name: profiling.counter(c) - before[name] for name, c in counters.items()}
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
    before = capture_counts()
    obs_before = profiling.counter("obs.launches")
    step_before = profiling.counter("lanes.step_kernel.launches")
    gen_before = profiling.counter("generator.kernel.launches")
    t0 = time.perf_counter()
    res, _ = drive(
        "rollout",
        lambda: L.lane_rollout(
            env, g, ROLLOUT_B, ROLLOUT_T, pool_rounds=POOL_ROUNDS, device=DEVICE
        ),
    )
    rollout_s = time.perf_counter() - t0
    obs_launches = profiling.counter("obs.launches") - obs_before
    require(obs_launches == 2, "the rollout launched the observation kernel in its capture")
    step_launches = profiling.counter("lanes.step_kernel.launches") - step_before
    require(step_launches == 2, "the rollout launched the step kernel in its capture")
    gen_launches = profiling.counter("generator.kernel.launches") - gen_before
    require(gen_launches == 1, "the rollout launched the generator kernel for its pool")
    capture = captured_since(before)
    require(capture["captures"] == 1, "the rollout captured its step as one CUDA graph")
    capture_ms, graph_pool_bytes = capture["capture_ms"], capture["graph_pool_bytes"]
    # The same pool again, from the same generator state, timed and checked.
    t0 = time.perf_counter()
    pool = L.lane_pool(env, g_pool, ROLLOUT_B, "pool", POOL_ROUNDS, torch.device(DEVICE))
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
        f"resets per lane >= {int(res.resets_per_env.min())}, {n_layouts} pool layouts valid; "
        f"the step captured as one CUDA graph in {capture_ms:.3f} ms, its pool "
        f"{graph_pool_bytes} bytes",
        flush=True,
    )
    results["rollout"] = {
        "B": ROLLOUT_B, "T": ROLLOUT_T, "pool_rounds": POOL_ROUNDS, "s": rollout_s,
        "env_steps_per_s": steps_per_s, "pool_s": pool_s,
        "steps_per_s_after_pool": ROLLOUT_B * ROLLOUT_T / (rollout_s - pool_s),
        "episodes": episodes, "total_reward": float(res.total_reward),
        "capture_ms": capture_ms, "graph_pool_bytes": graph_pool_bytes,
    }
    del res, pool

    # 2a. The graphed step against the eager loop, on the headline's shape.
    results["graph_against_eager"] = graph_against_eager(env, L, card)

    kernels = []

    def kernel_row(name, source, replaces, launches, err, call, kernel_only, plain, work, reps, **design):
        ms = cuda_ms(call, reps)
        kernel_ms = cuda_ms(kernel_only, reps)
        plain_ms = cuda_ms(plain, 1, warmup=0)  # each phase ran it once already, for err
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

    # 2b. The observation kernel at the headline's shape.
    kernels.append(obs_kernel(env, L, ptxas, obs_launches))
    # 2c. The step kernel at the rollout cells' shapes.
    kernels.extend(step_kernel(env, L, ptxas, step_launches))
    # 2d. The generator kernel at every DoorKey size, timed at both rollout
    # cells' generate.
    kernels.extend(generator_kernel(make, ptxas, gen_launches))

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
    # wide and grid routes at 16x16.
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
    del kv_plain
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
        return states, layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY16_SWEEPS)

    (l16_states, l16, kv16), counts16 = drive("key-domain VI, DoorKey-16x16", key16_path)
    require(counts16["key_vi"] == 1 and counts16["key_vi_wide"] == 1,
            "B2 launched once, on the wide route, at DoorKey-16x16")
    kv16_plain = TK.key_vi_values(l16, GAMMA, KEY16_SWEEPS)
    err16 = float((kv16 - kv16_plain).abs().max())
    require(err16 <= KEY_ATOL, f"B2's wide route within {KEY_ATOL} at DoorKey-16x16")
    require(bool((kv16 > 0).any()), "some DoorKey-16x16 state reaches the goal")
    m16 = cuda_vi.key_vi_masks(l16)
    print(f"[key_vi 16x16] {KEY16_B} layouts, {KEY16_SWEEPS} sweeps: max|kernel - plain| {err16:.3g}",
          flush=True)
    del kv16_plain
    K16, C16, h16, w16 = kv16.shape[1], kv16.shape[2], env16.params.height, env16.params.width
    n16 = cuda_vi.key_vi_route(K16, C16, h16 * w16)[1]
    in_place16 = cuda_vi.key_vi_wide_in_place(C16, h16 * w16, n16)
    require(in_place16, "DoorKey-16x16 is swept in place")
    G16 = cuda_vi.key_vi_wide_groups(h16 * w16)
    kernel_row(
        "key_vi_wide", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts16["key_vi"], err16,
        lambda: cuda_vi.cuda_key_value_iteration(l16, GAMMA, KEY16_SWEEPS),
        lambda: cuda_vi._key_vi_kernel(m16, GAMMA, KEY16_SWEEPS, kv16.shape),
        lambda: TK.key_vi_values(l16, GAMMA, KEY16_SWEEPS),
        cuda_vi.key_vi_work(l16, KEY16_SWEEPS), reps=5,
        design=WIDE_DESIGN + "; swept in place",
        kernel_route="wide",
        route_launches={r: counts16[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        shape=f"{KEY16_B} layouts 16x16, {KEY16_SWEEPS} sweeps, max_doors 1 (K={K16}, C={C16})",
        cluster=n16, groups=G16, threads_per_cta=G16 * h16 * w16, in_place=in_place16,
        active_clusters=cuda_vi.key_vi_wide_active_clusters(C16, h16, w16, n16),
        shared_bytes=cuda_vi.key_vi_wide_shared_bytes(C16, h16 * w16, n16, in_place16),
        compiled=compiled(ptxas, "key_vi_wide_kernelILb1E"),
    )
    del kv16, m16
    # The B2 bench's size: 512 layouts, 96 sweeps (1.08 GB of V).
    bench16 = TK.extract_key_layout(
        env16.generate(gen(12), env16.params, KEY16_BENCH_B, device=DEVICE), max_doors=1
    )
    pair = {"shape": f"{KEY16_ENV} {KEY16_BENCH_B} layouts, {KEY16_BENCH_SWEEPS} sweeps"}
    pair["bound_ms"], pair["bound_by"] = bound(*cuda_vi.key_vi_work(bench16, KEY16_BENCH_SWEEPS))
    # The user's call (masks, then the wide route) and the plain version.
    pair["wrapper_ms"] = cuda_ms(
        lambda: cuda_vi.cuda_key_value_iteration(bench16, GAMMA, KEY16_BENCH_SWEEPS), 3
    )
    plain = {}
    pair["plain_ms"] = cuda_ms(
        lambda: plain.setdefault("v", TK.key_vi_values(bench16, GAMMA, KEY16_BENCH_SWEEPS)), 1, warmup=0
    )
    pair["max_abs_err"] = float(
        (cuda_vi.cuda_key_value_iteration(bench16, GAMMA, KEY16_BENCH_SWEEPS) - plain.pop("v")).abs().max()
    )
    require(pair["max_abs_err"] <= KEY_ATOL, f"B2's wide route within {KEY_ATOL} at 512 DoorKey-16x16 layouts")
    print(f"[key_vi 16x16, {KEY16_BENCH_B} layouts] wrapper {pair['wrapper_ms']:.4f} ms, plain "
          f"{pair['plain_ms']:.2f} ms, max|kernel - plain| {pair['max_abs_err']:.3g}", flush=True)
    results["key_vi_wide_bench"] = pair
    del bench16

    # The same 32 layouts at two door slots: V is 4.2 MB a layout, too large
    # for 16 CTAs, so the wrapper takes the grid route (resident).
    def key16d2_path():
        layouts = TK.extract_key_layout(l16_states, max_doors=2)
        return layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY16_SWEEPS)

    (l16d2, kv16d2), counts16d2 = drive("key-domain VI, DoorKey-16x16, max_doors=2", key16d2_path)
    require(counts16d2["key_vi"] == 1 and counts16d2["key_vi_grid"] == 1,
            "B2 launched once, on the grid route, at DoorKey-16x16 with two door slots")
    err16d2 = float((kv16d2 - TK.key_vi_values(l16d2, GAMMA, KEY16_SWEEPS)).abs().max())
    require(err16d2 <= KEY_ATOL, f"B2's grid route within {KEY_ATOL} at two door slots")
    m16d2 = cuda_vi.key_vi_masks(l16d2)
    C16d2 = kv16d2.shape[2]
    n16d2 = cuda_vi.key_vi_route(K16, C16d2, h16 * w16)[1]
    kernel_row(
        "key_vi_grid", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts16d2["key_vi"], err16d2,
        lambda: cuda_vi.cuda_key_value_iteration(l16d2, GAMMA, KEY16_SWEEPS),
        lambda: cuda_vi._key_vi_kernel(m16d2, GAMMA, KEY16_SWEEPS, kv16d2.shape),
        lambda: TK.key_vi_values(l16d2, GAMMA, KEY16_SWEEPS),
        cuda_vi.key_vi_work(l16d2, KEY16_SWEEPS), reps=5,
        kernel_route="grid",
        route_launches={r: counts16d2[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        shape=f"{KEY16_B} layouts 16x16, {KEY16_SWEEPS} sweeps, max_doors 2 (K={K16}, C={C16d2})",
        **grid_design(C16d2, h16, w16, n16d2, ptxas),
    )
    del kv16d2, m16d2

    # DoorKey-8x8 at extract_key_layout's default max_doors (7): V 8.5 MB a
    # layout, so even the main env's layouts take the grid route there.
    def key_default_path():
        states = env.generate(gen(3), env.params, KEY_DEFAULT_B, device=DEVICE)
        layouts = TK.extract_key_layout(states)
        return layouts, cuda_vi.cuda_key_value_iteration(layouts, GAMMA, KEY_SWEEPS)

    (l8d7, kv8d7), counts8d7 = drive("key-domain VI, DoorKey-8x8, the default max_doors", key_default_path)
    require(counts8d7["key_vi"] == 1 and counts8d7["key_vi_grid"] == 1,
            "B2 launched once, on the grid route, at DoorKey-8x8 with the default max_doors")
    err8d7 = float((kv8d7 - TK.key_vi_values(l8d7, GAMMA, KEY_SWEEPS)).abs().max())
    require(err8d7 <= KEY_ATOL, f"B2's grid route within {KEY_ATOL} at the default max_doors")
    require(bool((kv8d7 > 0).any()), "some state reaches the goal at the default max_doors")
    m8d7 = cuda_vi.key_vi_masks(l8d7)
    C8d7 = kv8d7.shape[2]
    n8d7 = cuda_vi.key_vi_route(K, C8d7, h * w)[1]
    kernel_row(
        "key_vi_grid_DoorKey-8x8_max_doors7", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452",
        counts8d7["key_vi"], err8d7,
        lambda: cuda_vi.cuda_key_value_iteration(l8d7, GAMMA, KEY_SWEEPS),
        lambda: cuda_vi._key_vi_kernel(m8d7, GAMMA, KEY_SWEEPS, kv8d7.shape),
        lambda: TK.key_vi_values(l8d7, GAMMA, KEY_SWEEPS),
        cuda_vi.key_vi_work(l8d7, KEY_SWEEPS), reps=5,
        kernel_route="grid",
        route_launches={r: counts8d7[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        shape=f"{KEY_DEFAULT_B} layouts 8x8, {KEY_SWEEPS} sweeps, max_doors 7 (K={K}, C={C8d7})",
        **grid_design(C8d7, h, w, n8d7, ptxas),
    )
    del l8d7, kv8d7, m8d7
    del kv, l16, l16d2, l16_states

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
    require(r_err == 0.0, "returns equal to env_return")
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
        "family rollouts",
        lambda: family_rollouts(make, L, card, ids, FAMILY_RUNS, 100, workers, against_eager=True),
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

    # 14a. PPO graphed against eager, and the profile of both.
    t0 = time.perf_counter()
    results["ppo_graph"], counts = drive("PPO graph against eager",
                                         lambda: ppo_graph_against_eager(make, card))
    require(not any(counts.values()), "PPO launches no VI kernel")
    phase_s["ppo_graph"] = time.perf_counter() - t0

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

    # 18. Multi-device on one card.
    t0 = time.perf_counter()
    results["multi_device"], counts = drive("multi-device", lambda: multi_device(make, card))
    require(not any(counts.values()), "the multi-device legs launch no VI kernel")
    phase_s["multi_device"] = time.perf_counter() - t0

    # 19. Host tools.
    t0 = time.perf_counter()
    results["host_tools"], counts = drive("host tools", lambda: host_tools(make, card))
    require(not any(counts.values()), "the host tools launch no VI kernel")
    phase_s["host_tools"] = time.perf_counter() - t0

    # 20. The CLI's --dp: the plain VI, then B1, inside the CLI's trace.
    t0 = time.perf_counter()
    (reports, found), counts = drive("CLI --dp", lambda: cli_dp(card))
    require(counts["vi"] == 2, "the CLI's --dp launched B1 twice (warm-up and timed)")
    require(not counts["key_vi"], "the CLI launches no B2")
    from minigrid_dynamicprogramming_tpu_torch import benchmark

    layouts = benchmark.dp_layouts(batch=VI_B, device=DEVICE)
    v = cuda_vi.cuda_value_iteration(layouts, benchmark.DP_GAMMA, VI_SWEEPS)
    err = float((v - T.vi_values(layouts, benchmark.DP_GAMMA, VI_SWEEPS)).abs().max())
    require(err == 0.0, "B1 equals its plain version at the CLI's shape")
    masks = cuda_vi.vi_masks(layouts)
    C, D = v.shape[1], layouts.n_doors
    lpb, G = cuda_vi.vi_plan(C, D, h * w)
    kernel_row(
        "vi_cli_dp", f"{CSRC}/vi.cu", f"{PALLAS_VI}:201", counts["vi"], err,
        lambda: cuda_vi.cuda_value_iteration(layouts, benchmark.DP_GAMMA, VI_SWEEPS),
        lambda: cuda_vi._vi_kernel(masks, benchmark.DP_GAMMA, VI_SWEEPS, v.shape),
        lambda: T.vi_values(layouts, benchmark.DP_GAMMA, VI_SWEEPS),
        cuda_vi.vi_work(layouts, VI_SWEEPS), reps=10,
        design="a thread per (cell, config group) with its 4 directions and per-cell data "
        "in registers; V in shared memory",
        kernel_route="shared", route_launches={"shared": counts["vi"]},
        launcher="benchmark.py --dp", shape=f"{VI_B} DoorKey-8x8 layouts (seed 7), {VI_SWEEPS} sweeps, "
        f"max_doors {D} (C={C})",
        cli_layout_sweeps_per_s={k: reports[k]["vi_sweeps_per_s"] for k in ("dp_torch", "dp_cuda")},
        layouts_per_block=lpb, config_groups=G, threads_per_block=lpb * G * h * w,
        walk_bits=cuda_vi.vi_walk_bits(C), shared_bytes=cuda_vi.vi_shared_bytes(C, D, h * w, lpb),
        compiled=compiled(ptxas, f"vi_kernelILi{cuda_vi.vi_walk_bits(C)}ELi{h}ELi{w}E"),
    )
    results["cli_dp"] = {"reports": reports, "trace": found}
    del layouts, v, masks
    phase_s["cli_dp"] = time.perf_counter() - t0

    # 21. The headline bench, then B1 and B2 on its layouts.
    t0 = time.perf_counter()
    import bench_torch

    results["bench_torch"], counts = drive("bench_torch", lambda: bench_line(card))
    sizes = results["bench_torch"]["sizes"]
    runs = 1 + sizes["dp_runs"]  # a warm-up and the timed runs
    require(counts["vi"] == runs, f"the bench launched B1 {runs} times")
    require(counts["key_vi"] == runs and counts["key_vi_cluster"] == runs,
            f"the bench launched B2 {runs} times, on the cluster route")
    require(results["bench_torch"]["line"]["extra"]["launches"]
            == {"vi": counts["vi"], "key_vi": {r: counts[f"key_vi_{r}"] for r in cuda_vi.ROUTES}},
            "the bench's launches are the counts")
    states = bench_torch._doorkey_states(sizes["vi_batch"], torch.device(DEVICE))
    layouts = T.extract_layout(states, max_doors=1)
    n = sizes["vi_sweeps"]
    v = cuda_vi.cuda_value_iteration(layouts, bench_torch.GAMMA, n)
    err = float((v - T.vi_values(layouts, bench_torch.GAMMA, n)).abs().max())
    require(err == 0.0, "B1 equals its plain version on the bench's layouts")
    masks = cuda_vi.vi_masks(layouts)
    kernel_row(
        "vi_bench_torch", f"{CSRC}/vi.cu", f"{PALLAS_VI}:201", counts["vi"], err,
        lambda: cuda_vi.cuda_value_iteration(layouts, bench_torch.GAMMA, n),
        lambda: cuda_vi._vi_kernel(masks, bench_torch.GAMMA, n, v.shape),
        lambda: T.vi_values(layouts, bench_torch.GAMMA, n),
        cuda_vi.vi_work(layouts, n), reps=10,
        kernel_route="shared", route_launches={"shared": counts["vi"]}, launcher="bench_torch.py",
        shape=f"{sizes['vi_batch']} DoorKey-8x8 layouts (seed 11), {n} sweeps, max_doors 1",
    )
    states = bench_torch._doorkey_states(sizes["key_batch"], torch.device(DEVICE))
    key_layouts = TK.extract_key_layout(states, max_doors=1)
    n = sizes["key_sweeps"]
    kv = cuda_vi.cuda_key_value_iteration(key_layouts, bench_torch.GAMMA, n)
    err = float((kv - TK.key_vi_values(key_layouts, bench_torch.GAMMA, n)).abs().max())
    require(err <= KEY_ATOL, f"B2 within {KEY_ATOL} of its plain version on the bench's layouts")
    key_masks = cuda_vi.key_vi_masks(key_layouts)
    kernel_row(
        "key_vi_bench_torch", f"{CSRC}/key_vi.cu", f"{PALLAS_VI}:452", counts["key_vi"], err,
        lambda: cuda_vi.cuda_key_value_iteration(key_layouts, bench_torch.GAMMA, n),
        lambda: cuda_vi._key_vi_kernel(key_masks, bench_torch.GAMMA, n, kv.shape),
        lambda: TK.key_vi_values(key_layouts, bench_torch.GAMMA, n),
        cuda_vi.key_vi_work(key_layouts, n), reps=5,
        kernel_route="cluster", route_launches={r: counts[f"key_vi_{r}"] for r in cuda_vi.ROUTES},
        launcher="bench_torch.py",
        shape=f"{sizes['key_batch']} DoorKey-8x8 layouts (seed 11), {n} sweeps, max_doors 1",
    )
    del states, layouts, v, masks, key_layouts, kv, key_masks
    phase_s["bench_torch"] = time.perf_counter() - t0
    # 22. The "regen" autoreset graphed: every id's generate, three regen
    # rollouts and PPO's regen collector, each against its eager run.
    t0 = time.perf_counter()
    results["regen"], counts = drive("regen", lambda: regen_phase(make, registered_ids(), card))
    require(not any(counts.values()), "the regen phase launches no VI kernel")
    phase_s["regen"] = time.perf_counter() - t0
    print(f"[phases 8-22] seconds {phase_s}", flush=True)
    results["phase_s"] = phase_s

    # 23. Kernels line, card, ok.
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
