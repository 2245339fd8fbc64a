#!/usr/bin/env python3
"""Where a step of the PyTorch port's DoorKey-8x8 rollout, and a PPO
update, spend their time, on one CUDA card.

Run from the repository root, on a machine with a card:

    python3 profile_torch.py [--tracing-cost] [--out results.json]

It works at the rollout's batch, B=65536, with four pool rounds, and prints
the card's name and power limit, then:

* the device time of each part of a rollout step (transition, autoreset
  select, observation and checksum: the plain ``obs_lanes`` and its sum,
  and ``obs_checksum_lanes``, the one kernel that the step launches on a
  card; and ``step_lanes_kernel``, the one kernel that takes the plain
  transition's, select's and write-back's place on a card, on a copy of
  the state), each timed alone with CUDA events on the same state, over 32
  repetitions;
* for 32 steps of the rollout loop, eager (``lanes._lane_scan_eager``) and
  as the rollout runs on a card (the step captured once as a CUDA graph,
  then replayed a step at a time): the wall time per step without the
  profiler, and under ``torch.profiler`` the kernel time, kernels and
  graph launches per step and the ten kernels that take the most device
  time; and the capture's host time and its memory pool's bytes.  The
  device's busy share is the profiler's kernel time over the wall time
  of the same loop run without the profiler.
* the same for the "regen" rollout (a fresh batch of layouts generated
  every step, ``env.generate`` inside the step's graph) on DoorKey-8x8 at
  B=65536 (``profile_regen``; ``chip_smoke.py`` phase 22 also runs it on
  LavaGapS7 and BabyAI-BossLevel at B=4096);
* for one PPO update at ``chip_smoke.py``'s throughput configuration
  (BabyAI-GoToDoor, 32768 envs, T=32, 2 epochs x 8 minibatches, bf16) and
  at its learning configuration (8192 envs, T=64): the same for the
  collector (per step), the learner (GAE and the 16 minibatch steps) and
  the whole update, each graphed (the collector's and the minibatch's
  step each replayed as a CUDA graph, as ``PPO.update`` runs on a card)
  and eager (``PPO._update_eager``), and for the eager remainder; each
  graph's capture ms and memory pool bytes; and the same at the learning
  configuration with the "regen" collector;
* the same for ``chip_smoke.py``'s rendering: ``render_frame`` (tile 32,
  highlight) of 4096 DoorKey-8x8 states, and a step of the pixel
  observation ``ImgObs(RGBImgPartialObs(env, 8))`` on BabyAI-GoToDoor at
  32768 envs;
* the frame's row gather alone, the renderer's largest kernel, at those
  4096 frames: tile rows moved as bytes against the same rows moved as
  int64 words, CUDA-event means over 10 calls, timed bytes, words, words,
  bytes, three times over.

With ``--tracing-cost`` it does one thing only: tracing off against on
(``profile_tracing``), a rollout call and a key-domain solve in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

from minigrid_dynamicprogramming_tpu_torch.utils import profiling

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
BATCH, STEPS, POOL_ROUNDS = 65536, 32, 4
PPO_ENV, PPO_B, PPO_T, PPO_MB = "BabyAI-GoToDoor-v0", 32768, 32, 8
LEARN_B, LEARN_T = 8192, 64
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


def profiled(fn, label: str, per: int, results: dict, trace: bool = True) -> None:
    """Time ``fn()`` on the host clock, then (``trace``) under
    ``torch.profiler``: kernel time, kernels launched and the ten
    costliest kernels, each divided by ``per`` (steps or updates); adds
    them to ``results``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    if not trace:
        results[label] = dict(wall_ms=wall_ms / per)
        print(f"[{label}] {wall_ms / per:.4f} ms on the host clock", flush=True)
        return
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
    graphs = sum(e.count for e in prof.key_averages() if e.key == "cudaGraphLaunch")
    out = results[label] = dict(
        wall_ms=wall_ms / per,
        profiled_wall_ms=profiled_ms / per,
        device_ms=device_ms / per,
        busy_share=device_ms / wall_ms,
        kernels=launches / per,
        graph_launches=graphs / per,
        top_kernels=[],
    )
    print(
        f"[{label}] {wall_ms / per:.4f} ms on the host clock ({profiled_ms / per:.4f} ms under "
        f"the profiler), {device_ms / per:.4f} ms of kernels, busy share "
        f"{device_ms / wall_ms:.4f}, {launches / per:.1f} kernels, "
        f"{graphs / per:.1f} graph launches",
        flush=True,
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        share = e.self_device_time_total / 1e3 / device_ms
        out["top_kernels"].append({"name": e.key[:120], "count": e.count, "share": share})
        print(f"[kernel] {share:6.3f} x{e.count:6d} {e.key[:100]}")


def profile_regen(results: dict, env_id: str = ENV_ID, b: int = BATCH, steps: int = STEPS,
                  label: str = "regen", trace_eager: bool = True) -> dict:
    """``steps`` steps of the "regen" rollout on ``env_id`` at ``b`` lanes,
    eager (``_lane_scan_eager``; under the profiler too where
    ``trace_eager``) and graphed (the step captured once, then replayed a
    step at a time); the capture's ms and its pool's bytes."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    dev = torch.device("cuda")
    env = make(env_id)
    g = torch.Generator(device=dev).manual_seed(0)
    pool = L.lane_pool(env, g, b, "regen", 1, dev)
    out = results[label] = {"env": env_id, "B": b, "steps": steps}
    L._lane_scan_eager(env, g, pool, b, 2, "regen", 1)  # warm-up
    profiled(lambda: L._lane_scan_eager(env, g, pool, b, steps, "regen", 1),
             f"{label} eager rollout loop, {env_id}, B={b}, per step", steps, out, trace_eager)
    scan = L._Scan(env, g, pool, b, 2 * steps, "regen", 1, None)
    ms0 = profiling.counter("lanes.capture_ms")
    graph, pool_bytes = scan.capture()
    capture_ms = profiling.counter("lanes.capture_ms") - ms0
    out.update(capture_ms=capture_ms, graph_pool_bytes=pool_bytes)
    print(f"[{label} graph] captured in {capture_ms:.3f} ms, its memory pool "
          f"{pool_bytes} bytes", flush=True)

    def replay():
        for _ in range(steps):
            graph.replay()

    profiled(replay, f"{label} graphed rollout loop, {env_id}, B={b}, per step", steps, out)
    graph.reset()
    return out


def profile_ppo(results: dict, num_envs: int = PPO_B, rollout_len: int = PPO_T,
                label: str = "ppo", autoreset: str = "pool", trace_learner: bool = True) -> dict:
    """One PPO update's parts on BabyAI-GoToDoor (2 epochs x 8
    minibatches), each graphed (as ``update`` runs it on the card) and
    eager (``_update_eager``'s Python loops): the collector per step, the
    learner per update, the whole update; the eager remainder (the last
    observation and value, GAE, the permutations, the metrics); each
    graph's captures, capture ms and memory pool bytes.  After one
    update that captures both graphs and one eager one.  Without
    ``trace_learner`` the learner, the update and the remainder are timed
    on the host clock only."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout_len, epochs=2, num_minibatches=PPO_MB,
                    autoreset=autoreset)
    ppo = PPO(make(PPO_ENV), cfg)
    ts, _ = ppo.update(ppo.init(3))
    ts, _ = ppo._update_eager(ts)
    out = results[label] = {"env": PPO_ENV, "num_envs": num_envs, "rollout_len": rollout_len,
                            "epochs": 2, "num_minibatches": PPO_MB, "autoreset": autoreset}
    for eager in (False, True):
        way = "eager" if eager else "graphed"
        profiled(lambda: ppo._run_collector(ts, eager), f"{label} collector {way}, per step",
                 rollout_len, out)
        c = ppo._rollout
        with torch.no_grad():
            _, last_value = ts.model(ppo._final(c)[1])
        profiled(lambda: ppo._learn(ts, c.traj, last_value, eager),
                 f"{label} learner {way}, per update", 1, out, trace_learner)
        profiled(lambda: ppo._update(ts, eager), f"{label} update {way}", 1, out, trace_learner)

    def remainder():
        _, last_obs = ppo._final(c)
        with torch.no_grad():
            _, value = ts.model(last_obs)
        ppo._metrics(c.traj, ppo._minibatch_carry(ts, c.traj, value))

    profiled(remainder, f"{label} eager remainder, per update", 1, out, trace_learner)
    out.update(captures=dict(ppo.captures), capture_ms=dict(ppo.capture_ms),
               pool_bytes=dict(ppo.pool_bytes))
    print(f"[{label} graphs] captures {ppo.captures}, capture ms {ppo.capture_ms}, "
          f"pool bytes {ppo.pool_bytes}", flush=True)
    return out


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


def profile_tracing(results: dict, calls: int = 4) -> None:
    """What ``utils/profiling.py``'s tracing costs on the benchmark's
    paths: a DoorKey-8x8 ``lane_rollout`` call (B=65536, T=768, given
    actions; "pool" and "regen") and a DoorKey-16x16 key-domain solve (256
    states, 256 sweeps, ``max_doors=1``: extraction, VI, policy), each
    called ``calls`` times with ``tracing()`` off and as often on, in turns
    (off, on, on, off, ...), host ms to a synchronised end; the stamps a
    traced step's graph holds, the stamped step's device ms, and each
    span's device ms and count in the last traced call (no profiler)."""
    from minigrid_dynamicprogramming_tpu_torch import make
    from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as TK
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    dev = torch.device("cuda")
    env = make(ENV_ID)
    horizon = 768
    acts = torch.randint(0, env.action_dim, (horizon, BATCH), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    env16 = make("MiniGrid-DoorKey-16x16-v0")
    states = env16.generate(torch.Generator(device=dev).manual_seed(2), env16.params, 256, dev)

    def rollout(mode):
        g = torch.Generator(device=dev).manual_seed(3)
        return lambda: L.lane_rollout(env, g, BATCH, horizon, mode, POOL_ROUNDS, actions=acts,
                                      device=dev)

    def solve():
        layout = TK.extract_key_layout(states, max_doors=1)
        v = cuda_vi.cuda_key_value_iteration(layout, 0.995, 256)
        return TK.key_greedy_policy(v, layout, 0.995)

    out = results["tracing"] = {}
    for label, fn in (("rollout pool", rollout("pool")), ("rollout regen", rollout("regen")),
                      ("solve 16x16", solve)):
        ms = {False: [], True: []}
        for i in range(calls + 1):
            for traced in ((False, True) if i % 2 == 0 else (True, False)):
                profiling.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profiling.tracing() if traced else contextlib.nullcontext():
                    fn()
                torch.cuda.synchronize()
                if i:  # the first round warms up (the stamps' build and load)
                    ms[traced].append(1e3 * (time.perf_counter() - t0))
        recs = profiling.records()
        profiling.clear()
        row = out[label] = {
            "off_ms": ms[False], "on_ms": ms[True],
            "off_median_ms": statistics.median(ms[False]),
            "on_median_ms": statistics.median(ms[True]),
        }
        spans = row["spans"] = {}  # name: [device ms, count] in the last traced call
        for r in recs:
            total = spans.setdefault(r["name"] + (" (graph)" if r["attrs"].get("graph") else ""), [0.0, 0])
            total[0] += r["device_ms"]
            total[1] += r["count"]
            if r["name"] == "lanes.capture":
                row.update(stamp_nodes=r["attrs"]["stamp_nodes"], graph_nodes=r["attrs"]["graph_nodes"])
            if r["name"] == "lanes.step" and r["attrs"].get("graph"):
                row["traced_step_ms"] = r["device_ms"] / r["count"]
        print(f"[tracing] {label}: off {row['off_median_ms']:.3f} ms, on {row['on_median_ms']:.3f} ms "
              f"(medians of {calls}); off {ms[False]}, on {ms[True]}; stamps "
              f"{row.get('stamp_nodes')} beside {row.get('graph_nodes')} nodes, the traced step "
              f"{row.get('traced_step_ms')} ms; spans {spans}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON to this file")
    parser.add_argument("--tracing-cost", action="store_true",
                        help="only time tracing off against on (profile_tracing)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA card is available", file=sys.stderr)
        return 1
    if args.tracing_cost:
        results = {}
        profile_tracing(results)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        return 0
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
    pool = L.lane_pool(env, g, b, "pool", POOL_ROUNDS, dev)
    plain = L.AutoresetStep(env, "pool", POOL_ROUNDS, pool, g, b, dev)
    ls = pool.round(0)
    act = torch.randint(0, env.action_dim, (b,), generator=g, device=dev, dtype=torch.int32)
    done = torch.rand(b, generator=g, device=dev) < 0.01
    resets = torch.randint(0, 8, (b,), generator=g, device=dev, dtype=torch.int32)

    def observe():
        obj, color, obj_state, vis = L.obs_lanes(params, ls)
        return ((obj.to(torch.int64) + color + obj_state) * vis).sum()

    slot = torch.zeros(1, dtype=torch.int64, device=dev)
    # The step kernel writes in place: its own copy of the state and counts.
    kernel_ls, kernel_resets = ls.clone(), resets.clone()
    counts, reward = torch.zeros(3, 1, dtype=torch.int64, device=dev), torch.empty(b, device=dev)

    parts = {
        "transition (step_lanes)": lambda: L.step_lanes_env(env, ls, act),
        "autoreset select": lambda: plain.select(ls, done, resets, None),
        "observation + checksum": observe,
        "observation + checksum (csrc/obs.cu)": lambda: L.obs_checksum_lanes(
            params, ls, slot, slot.new_zeros(1)
        ),
        "transition, select and write-back (csrc/step.cu)": lambda: L.step_lanes_kernel(
            params, kernel_ls, kernel_resets, pool, POOL_ROUNDS, act, slot.new_zeros(1), reward,
            counts[0], counts[1], counts[2], "pool"
        ),
    }
    results = {"card": card, "batch": b, "steps": steps, "parts_ms": {}}
    for name, fn in parts.items():
        ms = part_ms(fn, steps)
        results["parts_ms"][name] = ms
        print(f"[part] {name}: {ms:.4f} ms per step")

    L._lane_scan_eager(env, g, pool, b, 4, "pool", POOL_ROUNDS)  # warm-up
    profiled(lambda: L._lane_scan_eager(env, g, pool, b, steps, "pool", POOL_ROUNDS),
             f"eager rollout loop, B={b}, per step", steps, results)
    # The step as the rollout runs it on the card: captured once, then
    # replayed; profiled() replays it twice over ``steps`` steps.
    scan = L._Scan(env, g, pool, b, 2 * steps, "pool", POOL_ROUNDS, None)
    ms0 = profiling.counter("lanes.capture_ms")
    graph, pool_bytes = scan.capture()
    results["capture_ms"] = profiling.counter("lanes.capture_ms") - ms0
    results["graph_pool_bytes"] = pool_bytes
    print(f"[graph] captured in {results['capture_ms']:.3f} ms, its memory pool "
          f"{pool_bytes} bytes", flush=True)

    def replay():
        for _ in range(steps):
            graph.replay()

    profiled(replay, f"graphed rollout loop, B={b}, per step", steps, results)
    graph.reset()
    del pool, ls, scan, graph
    profile_regen(results)
    profile_ppo(results)
    profile_ppo(results, LEARN_B, LEARN_T, "ppo learning size")
    profile_ppo(results, LEARN_B, LEARN_T, "ppo regen, learning size", "regen")
    profile_render(results)
    profile_render_rows(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
