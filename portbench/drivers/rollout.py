"""Driver of the rollout cells: the port's ``lane_rollout`` called back to
back, each call's observation checksum read on the host, as one training
or evaluation loop would.

Traffic parameters: ``batch`` lanes, ``horizon`` steps a call, the
``autoreset`` mode (``pool`` or ``regen``) and ``pool_rounds``.  The
layouts come from the port's generator, seeded from the run's seed; the
uniform random actions are drawn on the card from a generator of the
benchmark's own and handed to the call, so that the reference can replay
them.

End-to-end: ``env_steps_per_s``, lanes x steps of every call in the
window over the window's time; ``setup_s``.

The check, once the window has closed, on one call drawn from the seed
among the window's first ``check_within``:
its layouts are drawn again from the port's generator at the state the
call found it in (in the order ``lane_rollout`` documents: the pool's
``pool_rounds * batch`` layouts in one ``generate``, then in "regen" one
batch a step) and judged by DoorKey's rules (``reference/doorkey.py``);
the reference replays the call's actions from them and the call's final
state, resets, episodes, successes, failures, view checksum and reward
are compared with the replay's.
"""

from __future__ import annotations

import time

import torch

from portbench import harness
from portbench.reference import doorkey as ref


def _check_params(env, cfg: dict) -> None:
    p = env.params
    got = (p.width, p.height, p.max_steps, p.agent_view_size, p.see_through_walls, env.action_dim)
    want = (cfg["size"], cfg["size"], cfg["max_steps"], cfg["agent_view_size"],
            cfg["see_through_walls"], cfg["actions"])
    if got != want:
        raise ValueError(f"{cfg['env_id']}: the port's parameters {got} differ from the configuration's {want}")


def ref_state(st) -> ref.State:
    """The reference's state of a batch-first ``EnvState`` of the port."""
    return {
        "obj": st.grid_obj, "color": st.grid_color, "state": st.grid_state,
        "ax": st.agent_pos[:, 0].long(), "ay": st.agent_pos[:, 1].long(),
        "adir": st.agent_dir.long(), "carry_obj": st.carrying_obj,
        "carry_color": st.carrying_color, "steps": st.step_count.long(),
        "terminated": st.terminated, "truncated": st.truncated,
    }


def _program_answer(env, res) -> dict:
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    return {
        "state": ref_state(lanes.from_lanes(env.params, res.final_state)),
        "resets": res.resets_per_env.long(), "reward": float(res.total_reward),
        "episodes": int(res.episodes), "successes": int(res.successes),
        "failures": int(res.failures), "checksum": int(res.obs_checksum),
    }


def _layout_source(env, gen, p: dict, dev, stats: dict):
    """(start state, fresh(t, resets)) of the call that found the port's
    generator ``gen`` in its current state; every layout drawn is judged
    by the rules (``stats``: invalid layouts, door positions seen)."""
    b, mode, rounds = p["batch"], p["autoreset"], p.get("pool_rounds", 1)

    def drawn(n):
        s = ref_state(env.generate(gen, env.params, n, dev))
        stats["invalid"] += int(ref.invalid_layouts(s).sum())
        stats["pairs"].append(ref.split_door_pairs(s).unique())
        return s

    if mode == "pool":
        flat = drawn(rounds * b)
        pool = [{k: v[r * b:(r + 1) * b] for k, v in flat.items()} for r in range(rounds)]

        def fresh(t, resets):
            r = resets % rounds
            out = pool[0]
            for k in range(1, rounds):
                out = ref.select(r == k, pool[k], out)
            return out

        return pool[0], fresh
    if mode == "regen":
        return drawn(b), lambda t, resets: drawn(b)
    raise ValueError(f"unknown autoreset mode {mode!r}")


def _compare(got: dict, want: dict) -> dict:
    """The numbers compared: lanes whose final state differs, lanes whose
    resets differ, the gaps in the counts and the checksum (exact), and
    the reward's gap as a share of the reference's total (at least 1)."""
    b = want["resets"].shape[0]
    differs = torch.zeros(b, dtype=torch.bool, device=want["resets"].device)
    for k in ref.FIELDS:
        differs |= (got["state"][k].reshape(b, -1).long() != want["state"][k].reshape(b, -1).long()).any(1)
    return {
        "state_lanes": int(differs.sum()),
        "reset_lanes": int((got["resets"] != want["resets"]).sum()),
        "episodes_gap": abs(got["episodes"] - want["episodes"]),
        "successes_gap": abs(got["successes"] - want["successes"]),
        "failures_gap": abs(got["failures"] - want["failures"]),
        "checksum_gap": abs(got["checksum"] % (1 << 32) - want["checksum"] % (1 << 32)),
        "reward_gap": abs(got["reward"] - want["reward"]) / max(abs(want["reward"]), 1.0),
    }


def _generate_ms(env, p: dict, dev, seed: int) -> float:
    """Device ms of one generation as the cell's rollout runs it: in
    "pool" one eager ``generate`` of the pool's layouts a call, in "regen"
    one ``generate`` of a batch a step, replayed from a CUDA graph."""
    g = torch.Generator(device=dev).manual_seed(seed)
    spans = harness.Spans(dev)
    if p["autoreset"] == "pool":
        n = p.get("pool_rounds", 1) * p["batch"]
        env.generate(g, env.params, n, dev)
        for _ in range(3):
            t = spans.start()
            env.generate(g, env.params, n, dev)
            spans.stop(t)
        return sum(spans.ms()) / 3
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        env.generate(g, env.params, p["batch"], dev)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        env.generate(g, env.params, p["batch"], dev)
    graph.replay()
    reps = 20
    t = spans.start()
    for _ in range(reps):
        graph.replay()
    spans.stop(t)
    ms = spans.ms()[0] / reps
    graph.reset()
    return ms


def run(ctx: harness.Context) -> dict:
    import minigrid_dynamicprogramming_tpu_torch as port
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    cfg, p, dev = ctx.config, ctx.params, torch.device(ctx.device)
    env = port.make(cfg["env_id"])
    _check_params(env, cfg)
    b, horizon, mode, rounds = p["batch"], p["horizon"], p["autoreset"], p.get("pool_rounds", 1)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(0))
    act_gen = torch.Generator(device=dev).manual_seed(ctx.sub_seed(1))

    def actions(g=act_gen):
        return torch.randint(0, env.action_dim, (horizon, b), generator=g, device=dev,
                             dtype=torch.int32)

    def call(acts):
        res = lanes.lane_rollout(env, gen, b, horizon, mode, rounds, actions=acts, device=dev)
        int(res.obs_checksum)  # the observation reaches the host
        return res

    call(actions())  # warm-up: the step's first capture, every allocation
    ctx.setup_done()

    # The call checked: drawn from the seed among the first ``check_within``.
    j = int(ctx.rng(3).integers(p["check_within"]))
    walls, kept = [], None
    t0 = time.perf_counter()
    while True:
        saved = (gen.get_state(), act_gen.get_state()) if len(walls) == j else None
        t = time.perf_counter()
        res = call(actions())
        walls.append(time.perf_counter() - t)
        if saved is not None:
            kept = (saved, res)
        del res
        if time.perf_counter() - t0 >= ctx.seconds and len(walls) > j:
            break
    window_s = time.perf_counter() - t0
    harness.report_window(len(walls), window_s, [1e3 * w for w in walls])
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    trace = None
    if ctx.trace and on_card:
        prof = harness.profile(lambda: call(actions()))
        prof.counters["steps"] = horizon
        trace = {
            "window": prof, "rollout_call": prof, "rollout_call_wall_s": walls,
            "generate_ms": _generate_ms(env, p, dev, ctx.sub_seed(2)),
        }
    elif ctx.trace:
        trace = {}

    (gen_state, act_state), res = kept
    del kept
    got = None if ctx.control else _program_answer(env, res)
    del res
    replay_gen = torch.Generator(device=dev)
    replay_gen.set_state(gen_state)
    replay_act = torch.Generator(device=dev)
    replay_act.set_state(act_state)
    acts = actions(replay_act)
    stats = {"invalid": 0, "pairs": []}
    start, fresh = _layout_source(env, replay_gen, p, dev, stats)
    want = ref.rollout(start, acts, cfg["max_steps"], fresh)
    if ctx.control:
        # The control: the reference with its reward in bfloat16, one step
        # below the configuration's float32, in the program's place.
        replay_gen.set_state(gen_state)
        control_stats = {"invalid": 0, "pairs": []}
        start, fresh = _layout_source(env, replay_gen, p, dev, control_stats)
        got = ref.rollout(start, acts, cfg["max_steps"], fresh, reward_dtype=torch.bfloat16)
    numbers = _compare(got, want)
    numbers["invalid_layouts"] = stats["invalid"]
    numbers["unseen_door_cells"] = ref.unseen_pairs(torch.cat(stats["pairs"]), cfg["size"])
    checks = [(k, v, ctx.limits[k]) for k, v in numbers.items()]
    return {
        "e2e": {"env_steps_per_s": len(walls) * b * horizon / window_s, "setup_s": ctx.setup_s},
        "trace": trace, "checks": checks, "attempted": len(walls),
        "failed": int(any(v > lim for _, v, lim in checks)), "memory_peak_bytes": peak,
    }
