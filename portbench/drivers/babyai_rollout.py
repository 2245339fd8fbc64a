"""Driver of the BabyAI rollout cells: the port's ``lane_rollout`` on a
LevelGen level (BossLevel), called back to back, each call's observation
checksum read on the host, as ``drivers/rollout.py`` runs DoorKey.

Traffic parameters: ``batch`` lanes, ``horizon`` steps a call, the
``autoreset`` mode (``pool`` or ``regen``), ``pool_rounds`` and
``check_within``.  The layouts come from the port's generator, seeded
from the run's seed; the uniform random actions are drawn on the card
from a generator of the benchmark's own and handed to the call, so that
the reference can replay them.

End-to-end: ``env_steps_per_s``, lanes x steps of every call in the
window over the window's time; ``setup_s``.

The check, once the window has closed, on one call drawn from the seed
among the window's first ``check_within``: every layout it consumed is
drawn again from the port's generator at the state the call found it in
(the pool's ``pool_rounds * batch`` layouts in one ``generate``, or in
"regen" one batch a step) and judged by LevelGen's rules
(``reference/babyai_levelgen.py``); the reference replays the call's
actions from them, verifier included, and the call's final state (grid
planes, agent, carrying, step count, done flags, mission codes), its
verifier's progress (``verifier_lanes``: the first clause of a Before or
an After done, each And half done, each leaf's memory of what was
carried, read from the port's verifier slots), resets, episodes,
successes, failures, view checksum and reward are compared with the
replay's.  ``unseen_instruction_shapes`` counts the shapes of
{single, before, after} x {goto, open, pickup, putnext} (clause A's first
leaf) that no judged layout showed.
"""

from __future__ import annotations

import time

import torch

from portbench import harness
from portbench.drivers import rollout as base
from portbench.reference import babyai_levelgen as ref


def _check_params(env, cfg: dict) -> None:
    p = env.params
    got = (p.width, p.height, p.agent_view_size, p.see_through_walls, env.action_dim,
           p.opt("room_size"), p.opt("num_rows"), p.opt("num_cols"), bool(p.opt("done_actions")),
           bool(p.opt("fixed_max_steps")))
    want = (cfg["size"], cfg["size"], cfg["agent_view_size"], cfg["see_through_walls"], cfg["actions"],
            cfg["room_size"], cfg["num_rows"], cfg["num_cols"], cfg["done_actions"], False)
    if got != want:
        raise ValueError(f"{cfg['env_id']}: the port's parameters {got} differ from the configuration's {want}")


def ref_layout(env, st) -> ref.State:
    """The reference's layout of a batch-first ``EnvState`` of the port:
    DoorKey's fields, the box contents, the mission codes and the step
    limit the port keeps for the episode."""
    s = base.ref_state(st)
    s["contains"] = st.contains_obj
    s["codes"] = st.mission.long()
    s["max_steps"] = st.aux[:, env.params.opt("dynamic_max_steps_slot")].long()
    return s


def program_progress(st) -> torch.Tensor:
    """:func:`ref.progress` of a batch-first ``EnvState`` of the port, read
    from the verifier's slots of ``aux`` (``envs/babyai/core.py``): the
    first clause's success (``AUX_A_DONE`` in a Before, ``AUX_B_DONE`` in
    an After), each And half's (``AUX_LEAF_DONE``), each leaf's
    ``preCarrying`` is None (``AUX_PC_NONE``)."""
    from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B

    aux, comb = st.aux.long(), st.mission[:, 0].long()
    first = torch.where(comb == ref.COMB_BEFORE, aux[:, B.AUX_A_DONE] == 1,
                        torch.where(comb == ref.COMB_AFTER, aux[:, B.AUX_B_DONE] == 1, False))
    halves = aux[:, B.AUX_LEAF_DONE:B.AUX_LEAF_DONE + 4] == 1
    return torch.cat([first[:, None], halves, aux[:, B.AUX_PC_NONE:B.AUX_PC_NONE + 4] == 1], 1)


def _program_answer(env, res) -> dict:
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    st = lanes.from_lanes(env.params, res.final_state)
    return {
        "state": ref_layout(env, st), "progress": program_progress(st),
        "resets": res.resets_per_env.long(), "reward": float(res.total_reward),
        "episodes": int(res.episodes), "successes": int(res.successes),
        "failures": int(res.failures), "checksum": int(res.obs_checksum),
    }


def _layout_source(env, gen, p: dict, dev, stats: dict):
    """(first episodes, fresh(t, resets)) of the call that found the
    port's generator ``gen`` in its current state; every layout drawn is
    judged by the rules (``stats``: invalid layouts, instruction shapes
    seen)."""
    b, mode, rounds = p["batch"], p["autoreset"], p.get("pool_rounds", 1)

    def drawn(n):
        s = ref_layout(env, env.generate(gen, env.params, n, dev))
        stats["invalid"] += int(ref.invalid_layouts(s).sum())
        stats["shapes"].append(ref.instruction_shapes(s["codes"]).unique())
        return ref.start(s)

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
    for k in ref.COMPARED:
        differs |= (got["state"][k].reshape(b, -1).long() != want["state"][k].reshape(b, -1).long()).any(1)
    return {
        "state_lanes": int(differs.sum()),
        "verifier_lanes": int((got["progress"] != ref.progress(want["state"])).any(1).sum()),
        "reset_lanes": int((got["resets"] != want["resets"]).sum()),
        "episodes_gap": abs(got["episodes"] - want["episodes"]),
        "successes_gap": abs(got["successes"] - want["successes"]),
        "failures_gap": abs(got["failures"] - want["failures"]),
        "checksum_gap": abs(got["checksum"] % (1 << 32) - want["checksum"] % (1 << 32)),
        "reward_gap": abs(got["reward"] - want["reward"]) / max(abs(want["reward"]), 1.0),
    }


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
        trace = {"window": prof, "rollout_call": prof, "rollout_call_wall_s": walls}
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
    stats = {"invalid": 0, "shapes": []}
    first, fresh = _layout_source(env, replay_gen, p, dev, stats)
    want = ref.rollout(first, acts, fresh)
    if ctx.control:
        # The control: the reference with its reward in bfloat16, one step
        # below the configuration's float32, in the program's place.
        replay_gen.set_state(gen_state)
        first, fresh = _layout_source(env, replay_gen, p, dev, {"invalid": 0, "shapes": []})
        got = ref.rollout(first, acts, fresh, reward_dtype=torch.bfloat16)
        got["progress"] = ref.progress(got["state"])
    numbers = _compare(got, want)
    numbers["invalid_layouts"] = stats["invalid"]
    numbers["unseen_instruction_shapes"] = ref.unseen_shapes(torch.cat(stats["shapes"]))
    checks = [(k, v, ctx.limits[k]) for k, v in numbers.items()]
    return {
        "e2e": {"env_steps_per_s": len(walls) * b * horizon / window_s, "setup_s": ctx.setup_s},
        "trace": trace, "checks": checks, "attempted": len(walls),
        "failed": int(any(v > lim for _, v, lim in checks)), "memory_peak_bytes": peak,
    }
