"""Driver of the PPO cell: the port's ``PPO.update`` called back to back
on one rank's share of the deployment's envs, each update's
``mean_return`` read on the host, as a training loop's logging does.

Traffic parameters: ``num_envs``, ``rollout_len`` (T), ``epochs``,
``num_minibatches``, the ``autoreset`` mode and ``pool_rounds``;
``check_within`` (the window's first updates, one of which is checked),
``check_block`` (rows the reference's network takes at once),
``rounding_level`` (below) and, for the traced run, ``trace_updates``.
The PPO settings and the network come from the configuration; the
parameters, the layouts and the policy's draws from the port's own
generators, seeded from the run's seed.

End-to-end: ``env_steps_per_s``, ``num_envs x rollout_len`` of every update
in the window over the window's time; ``setup_s`` (it holds one warm-up
update, which captures both graphs).

The check, once the window has closed, on one update drawn from the seed
among the window's first ``check_within``: before it the driver keeps the
parameters and Adam's state (device copies, inside the window) and the
TrainState (the env state, the reset counts, the pool), after it the
trajectory, the permutations, the parameters, Adam's state and the
metrics.  The recorded actions and permutations stand for the
generators' draws, so their states are not kept.  The reference
(``reference/babyai_gotodoor.py``, ``actor_critic.py``, ``ppo_update.py``):

* judges the pool's layouts by GoToDoor's rules and the start state
  against the layout of its episode (``invalid_layouts``);
* replays the recorded actions from the start state, resets drawn from
  the pool by the reset count modulo its rounds, and compares every
  step's observation (``obs_gap``: cells of image, direction and mission),
  done (``done_gap``), the final state (``state_lanes``), the resets
  (``reset_lanes``), the episodes (``episodes_gap``) and the reward
  (``reward_gap``, float32 against float64, relative to the total);
* runs its network at the start's parameters on the observations: the
  widest gap of the behaviour log-probability of the action taken
  (``logp_gap``) and of the value (``value_gap``);
* runs its learner from the start's parameters and Adam's state, on its
  own rollout (rewards, dones, its values and log-probabilities, its
  bootstrap value of the verified final observation) and the program's
  permutations: the widest relative gap of the five loss terms
  (``loss_gap``), Adam's first moment ``|m - m_ref| / |m_ref|`` over all
  parameters (``grad_moment_gap``) and, tensor by tensor, the update's
  change ``d``, ``|d - d_ref| / |d_ref|``, the widest of them
  (``param_update_gap``);
* leaves out of ``param_update_gap`` the tensors whose gradient is at
  rounding level: those whose update the reference itself, run again
  with its work rounded to the program's compute dtype, moves by more
  than ``rounding_level`` (a traffic parameter) of ``|d_ref|``: bfloat16's
  rounding alone then makes up that share of the tensor's update (a
  scalar bias whose gradient changes sign from step to step, or the first
  layers on some seeds).  The rule reads the reference alone, so the
  program cannot move it.  Each tensor's gap and rounding are printed on
  standard error.

The control (``portbench/readings.py``) puts the reference one step below
the configuration's precisions in the program's place: what the program
computes in bfloat16 (the embeddings, the convolutions, the trunk) rounded
through float8 (e4m3), what it computes in float32 (the heads, Adam's
moments and the parameters it writes, the reward) through bfloat16.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import torch

from portbench import harness
from portbench.drivers import rollout
from portbench.reference import actor_critic as ac
from portbench.reference import babyai_gotodoor as ref
from portbench.reference import ppo_update as ref_ppo


def _check_params(env, model, cfg: dict) -> None:
    """The port's level and network against the configuration's sizes."""
    p, net = env.params, cfg["network"]
    enc = model.encoder
    got = (p.width, p.height, p.agent_view_size, p.see_through_walls, env.action_dim,
           p.opt("room_size"), p.opt("num_rows"), p.opt("num_cols"),
           [getattr(enc, f"plane_embed_{c}").weight.shape[0] for c in range(3)],
           enc.plane_embed_0.weight.shape[1], [c.weight.shape[0] for c in enc.convs],
           enc.trunk.weight.shape[0], enc.dir_embed.weight.shape[1], enc.code_embed.weight.shape,
           enc.code_pos.shape[0], str(enc.compute_dtype).replace("torch.", ""),
           bool(p.opt("done_actions", False)))
    want = (cfg["size"], cfg["size"], cfg["agent_view_size"], cfg["see_through_walls"],
            cfg["actions"], cfg["room_size"], cfg["num_rows"], cfg["num_cols"],
            net["plane_vocabs"], net["embed_dim"], net["conv_features"], net["hidden"],
            net["dir_features"], (net["mission_vocab"], net["code_features"]),
            cfg["mission_slots"], net["compute_dtype"], cfg["done_actions"])
    if got != want:
        raise ValueError(f"{cfg['env_id']}: the port's sizes {got} differ from the configuration's {want}")


def ref_state(st) -> ref.State:
    """The reference's state of a batch-first ``EnvState`` of the port."""
    return {**rollout.ref_state(st), "codes": st.mission.long()}


def pool_rounds(env, pool) -> list:
    """Each round of the lane-major pool as a reference state."""
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

    rounds = pool.agent_dir.shape[0]
    return [ref_state(L.from_lanes(env.params, L.LaneState(**{n: getattr(pool, n)[r] for n in L._FIELDS})))
            for r in range(rounds)]


def round_of(layouts: list, r: torch.Tensor) -> ref.State:
    """Each env's layout of pool round ``r`` (B,)."""
    out = layouts[0]
    for k in range(1, len(layouts)):
        out = ref.select(r == k, layouts[k], out)
    return out


def _learner_state(model, optimizer) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of the parameters and of Adam's moments and steps, by name."""
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out["params"][name] = p.detach().clone()
        out["exp_avg"][name] = st["exp_avg"].clone() if st else torch.zeros_like(p)
        out["exp_avg_sq"][name] = st["exp_avg_sq"].clone() if st else torch.zeros_like(p)
        out["step"][name] = int(st["step"]) if st else 0
    return out


def _behaviour(params, obs: dict, actions: torch.Tensor, rnd, rnd_head, block: int):
    """The network's log-probability of each action taken and its value, on
    (T, B, ...) observations, ``block`` rows at a time; each (T, B)."""
    flat = {k: v.flatten(0, 1) for k, v in obs.items()}
    acts = actions.flatten()
    logps, values = [], []
    with torch.no_grad():
        for lo in range(0, acts.shape[0], block):
            logits, value = ac.forward(params, {k: v[lo:lo + block] for k, v in flat.items()}, rnd, rnd_head)
            logps.append(torch.log_softmax(logits, -1).gather(1, acts[lo:lo + block, None])[:, 0])
            values.append(value)
    return torch.cat(logps).view_as(actions), torch.cat(values).view_as(actions)


def _reference_update(start: dict, rep: dict, actions: torch.Tensor, perms: torch.Tensor,
                      s: ref_ppo.Settings, block: int, rnd=ac.identity, rnd_head=ac.identity) -> dict:
    """The reference's behaviour outputs and learner from the kept start,
    on the replay ``rep``."""
    params = start["params"]
    logp, values = _behaviour(params, rep["obs"], actions, rnd, rnd_head, block)
    with torch.no_grad():
        _, last_value = ac.forward(params, rep["last_obs"], rnd, rnd_head)
    adv, ret = ref_ppo.gae(rep["rewards"].float(), values, rep["dones"], last_value,
                           s.gamma, s.gae_lambda)
    adam = ref_ppo.AdamState(start["exp_avg"], start["exp_avg_sq"], start["step"])
    final, adam, terms = ref_ppo.learn(params, adam, (rep["obs"], actions, logp, values, adv, ret),
                                       perms, s, rnd, block, rnd_head)
    return {"logps": logp, "values": values, "params": final, "exp_avg": adam.exp_avg,
            "terms": terms.mean(0)}


def _tensor_gaps(params: dict, want: dict, start: dict) -> Dict[str, float]:
    """Each tensor's ``|d - d_ref| / |d_ref|``, ``d`` the update's change
    of it from ``start``."""
    out = {}
    for k, w in want.items():
        d_ref = (w - start[k]).double()
        d = (params[k] - start[k]).double()
        out[k] = float((d - d_ref).norm() / d_ref.norm().clamp(min=1e-30))
    return out


def _gaps(got: dict, want: dict, start: dict, rounding: Dict[str, float], level: float) -> dict:
    """The bounded numbers: behaviour, loss terms, moments, and the widest
    update gap of the tensors whose ``rounding`` is at most ``level``."""
    def rel(a, b):
        return float((a - b).double().norm() / b.double().norm().clamp(min=1e-30))

    names = list(want["params"])
    tensors = _tensor_gaps(got["params"], want["params"], start["params"])
    kept = [k for k in names if rounding[k] <= level]
    print("portbench: param_update per tensor [gap, rounding]: "
          + json.dumps({k: [round(tensors[k], 6), round(rounding[k], 6)] for k in names}),
          file=sys.stderr, flush=True)
    return {
        "logp_gap": float((got["logps"] - want["logps"]).abs().max()),
        "value_gap": float((got["values"] - want["values"]).abs().max()),
        "loss_gap": max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                        for a, b in zip(got["terms"], want["terms"])),
        "grad_moment_gap": rel(torch.cat([got["exp_avg"][k].flatten() for k in names]),
                               torch.cat([want["exp_avg"][k].flatten() for k in names])),
        "param_update_gap": max((tensors[k] for k in kept), default=0.0),
    }


def run(ctx: harness.Context) -> dict:
    import minigrid_dynamicprogramming_tpu_torch as port
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.utils import profiling

    cfg, p, dev = ctx.config, ctx.params, torch.device(ctx.device)
    h = cfg["ppo"]
    on_card = dev.type == "cuda"
    env = port.make(cfg["env_id"])
    config = PPOConfig(
        num_envs=p["num_envs"], rollout_len=p["rollout_len"], epochs=p["epochs"],
        num_minibatches=p["num_minibatches"], gamma=h["gamma"], gae_lambda=h["gae_lambda"],
        clip_eps=h["clip_eps"], vf_coef=h["vf_coef"], ent_coef=h["ent_coef"], lr=h["lr"],
        max_grad_norm=h["max_grad_norm"], autoreset=p["autoreset"], pool_rounds=p["pool_rounds"],
    )
    ppo = PPO(env, config, device=dev)
    ts = ppo.init(ctx.sub_seed(0))
    _check_params(env, ts.model, cfg)
    group = ts.optimizer.param_groups[0]
    if (group["eps"], tuple(group["betas"])) != (h["adam_eps"], tuple(h["adam_betas"])):
        raise ValueError(f"Adam's eps and betas differ from the configuration's: {group}")
    if ctx.trace and on_card:
        profiling.load_stamps(dev)  # the stamps' build, out of the traced run
    ts, m = ppo.update(ts)  # warm-up: both graphs' captures, every allocation
    float(m.mean_return)
    ctx.setup_done()

    # The update checked: drawn from the seed among the first ``check_within``.
    j = int(ctx.rng(3).integers(p["check_within"]))
    walls, kept = [], None
    t0 = time.perf_counter()
    while True:
        start = None
        if len(walls) == j:
            start = {**_learner_state(ts.model, ts.optimizer), "ts": ts}
        t = time.perf_counter()
        ts, m = ppo.update(ts)
        float(m.mean_return)  # the update's logging reaches the host
        walls.append(time.perf_counter() - t)
        if start is not None:
            traj = ppo._traj
            kept = (start, {
                **_learner_state(ts.model, ts.optimizer), "ts": ts, "metrics": m,
                "obs": {k: v.clone() for k, v in traj.obs.items()},
                **{name: getattr(traj, name).clone() for name in traj._fields[1:]},
                "perms": ppo._minibatches.perms.clone(),
            })
        if time.perf_counter() - t0 >= ctx.seconds and len(walls) > j:
            break
    window_s = time.perf_counter() - t0
    harness.report_window(len(walls), window_s, [1e3 * w for w in walls])
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    trace = None
    if ctx.trace and on_card:
        holder = [ts]

        def updates():
            for _ in range(p["trace_updates"]):
                holder[0], mt = ppo.update(holder[0])
                float(mt.mean_return)

        with profiling.tracing():  # the graphs captured again, with their stamps
            updates()
        prof = harness.profile(updates)
        trace = {"window": prof, "ppo_updates": prof, "updates": p["trace_updates"],
                 "config": cfg, "params": p}
        ts = holder[0]
    elif ctx.trace:
        trace = {}
    del ts

    start, end = kept
    del kept
    numbers = _check(env, cfg, p, start, end, ctx.control)
    checks = [(k, v, ctx.limits[k]) for k, v in numbers.items()]
    return {
        "e2e": {"env_steps_per_s": len(walls) * p["num_envs"] * p["rollout_len"] / window_s,
                "setup_s": ctx.setup_s},
        "trace": trace, "checks": checks, "attempted": len(walls),
        "failed": int(any(v > lim for _, v, lim in checks)), "memory_peak_bytes": peak,
    }


def _check(env, cfg: dict, p: dict, start: dict, end: dict, control: bool) -> dict:
    first, last = start["ts"], end["ts"]
    max_steps, block = cfg["max_steps"], p["check_block"]
    # The layouts: the pool's rounds by the rules, the start against its
    # episode's layout (the pool's round of its reset count).
    layouts = pool_rounds(env, first.pool)
    rounds = len(layouts)
    s0 = ref_state(first.env_state)
    resets0 = first.reset_count.long()
    invalid = sum(int(ref.invalid_layouts(lay).sum()) for lay in layouts)
    invalid += int(ref.inconsistent_states(s0, round_of(layouts, resets0 % rounds), max_steps).sum())

    def fresh(n):
        return round_of(layouts, (resets0 + n) % rounds)

    rep = ref.replay(s0, end["actions"], max_steps, fresh)
    obs_gap = sum(int((end["obs"][k].long() != rep["obs"][k].long()).sum()) for k in rep["obs"])
    final = ref_state(last.env_state)
    b = resets0.shape[0]
    differs = torch.zeros(b, dtype=torch.bool, device=resets0.device)
    for k in ref.FIELDS:
        differs |= (final[k].reshape(b, -1).long() != rep["state"][k].reshape(b, -1).long()).any(1)
    numbers = {
        "invalid_layouts": invalid,
        "obs_gap": obs_gap,
        "done_gap": int((end["dones"] != rep["dones"]).sum()),
        "state_lanes": int(differs.sum()),
        "reset_lanes": int((last.reset_count.long() - resets0 != rep["resets"]).sum()),
        "episodes_gap": abs(int(end["metrics"].episodes) - int(rep["dones"].sum())),
    }

    s = ref_ppo.settings(cfg["ppo"], p["epochs"], p["num_minibatches"])
    want = _reference_update(start, rep, end["actions"], end["perms"], s, block)
    # The reference's own rounding at the program's compute dtype
    # (bfloat16, which ``_check_params`` holds the port to).
    at_program = _reference_update(start, rep, end["actions"], end["perms"], s, block, ac.bf16)
    rounding = _tensor_gaps(at_program["params"], want["params"], start["params"])
    del at_program
    if control:
        rep_c = ref.replay(s0, end["actions"], max_steps, fresh, torch.bfloat16)
        rewards = rep_c["rewards"]
        got = _reference_update(start, rep_c, end["actions"], end["perms"], s, block, ac.fp8, ac.bf16)
    else:
        m = end["metrics"]
        rewards = end["rewards"]
        got = {"logps": end["logps"], "values": end["values"], "params": end["params"],
               "exp_avg": end["exp_avg"],
               "terms": [m.loss, m.policy_loss, m.value_loss, m.entropy, m.approx_kl]}
    ref_reward = float(rep["rewards"].sum())
    numbers["reward_gap"] = abs(float(rewards.double().sum()) - ref_reward) / max(abs(ref_reward), 1.0)
    numbers.update(_gaps(got, want, start, rounding, p["rounding_level"]))
    return numbers
