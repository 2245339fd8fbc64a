#!/usr/bin/env python3
"""How many PyTorch operators a rollout step and a DP sweep of the port
launch, counted on the CPU.

The port's rollouts are bound by the host launching one small kernel per
operator, so the operator count of a step predicts its host time on the
card.  Run from the repository root, on any machine:

    python3 count_ops.py [ENV_ID ...]

For each id (by default DoorKey-8x8, KeyCorridorS3R1, GoToLocal and
BossLevel) it prints the operators of one step of the lane-major rollout
(``lanes._Scan.step``, the step that the card captures as a CUDA graph,
with its writes into the carry; a field's copy onto itself is counted
but launches nothing) and of its parts: the core transition, the id's
post-step hook (the BabyAI verifier), the observation (plain here; on a card
the step launches it and its checksum as one kernel, ``csrc/obs.cu``, so
the step's count there is its count here less ``obs_checksum_lanes``'s,
plus one; for an id with no hook, such as DoorKey, the card's step is
instead ``csrc/step.cu`` in the transition's, select's and write-back's
place: the action draw, that kernel, the observation kernel, the
reward's sum into its slot and the step index, about six launches).  Then those of one sweep of the two-key
domain on an UnlockToUnlock layout, and how many of them write a full
(N, K1, K2, Cd, H, W) block; then PPO's on BabyAI-GoToDoor: the
collector's step and the minibatch step (each one CUDA graph on the
card) and the eager rest of an update.  Views (reshape, select, expand
and the like) launch no kernel and are not counted, but for the sweep's
total with views.
"""

from __future__ import annotations

import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from minigrid_dynamicprogramming_tpu_torch import make
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

IDS = ("MiniGrid-DoorKey-8x8-v0", "MiniGrid-KeyCorridorS3R1-v0",
       "BabyAI-GoToLocal-v0", "BabyAI-BossLevel-v0")
VIEWS = ("view", "reshape", "select", "slice", "expand", "permute", "transpose",
         "unsqueeze", "squeeze", "alias", "detach", "lift_fresh", "as_strided", "t.default")


class Count(TorchDispatchMode):
    """Counts the operators dispatched inside it, views left out; ``big``
    counts those whose output has at least ``big_numel`` elements."""

    def __init__(self, big_numel: int = 0):
        super().__init__()
        self.ops, self.big, self.big_numel, self.with_views = Counter(), 0, big_numel, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        self.with_views += 1
        if not any(v in name for v in VIEWS):
            self.ops[name] += 1
            if self.big_numel and isinstance(out, torch.Tensor) and out.numel() >= self.big_numel:
                self.big += 1
        return out

    @property
    def total(self) -> int:
        return sum(self.ops.values())


def count(fn, big_numel: int = 0) -> Count:
    with Count(big_numel) as c:
        fn()
    return c


def step_counts(env_id: str) -> dict:
    env = make(env_id)
    g = torch.Generator().manual_seed(0)
    pool = L.lane_pool(env, g, 64, "pool", 2, "cpu")
    ls = pool.round(0)
    act = torch.randint(0, env.action_dim, (64,), generator=g, dtype=torch.int32)
    new, reward, term = L.step_lanes(env.params, ls, act)
    scan = L._Scan(env, g, pool, 64, 1, "pool", 2, None)
    out = {
        "rollout step": count(lambda: scan.step(scan.carry)).total,
        "core transition": count(lambda: L.step_lanes(env.params, ls, act)).total,
        "observation": count(lambda: L.obs_lanes(env.params, ls)).total,
    }
    slot = torch.zeros(1, dtype=torch.int64)
    checksum = count(lambda: L.obs_checksum_lanes(env.params, ls, slot, slot.new_zeros(1))).total
    out["rollout step on a card"] = out["rollout step"] - checksum + 1
    if env.post_step_lanes is not None:
        hook = env.post_step_lanes
        out["post-step hook"] = count(lambda: hook(env.params, None, ls, new, act, reward, term)).total
    return out


def ppo_counts(env_id: str = "BabyAI-GoToDoor-v0") -> dict:
    """The operators of PPO's collector step and minibatch step (the two
    steps the card replays as CUDA graphs; the minibatch step's Adam on
    the CPU is PyTorch's loop over parameters, a few fused calls on the
    card) and of the update's eager remainder: the last observation and
    value, GAE over T=8, the permutations and the metrics."""
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    ppo = PPO(make(env_id), PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2), device="cpu")
    ts = ppo.init(0)
    c = ppo._rollout_carry(ts)
    ppo._load(c, ts)
    collector = count(lambda: ppo._collect_step(c, ts.model, ts.pool, ts.generator)).total
    for _ in range(ppo.config.rollout_len - 1):
        ppo._collect_step(c, ts.model, ts.pool, ts.generator)
    with torch.no_grad():
        _, value = ts.model(ppo._final(c)[1])
    mb = ppo._minibatch_carry(ts, c.traj, value)
    ppo._learn_step(mb, ts.model, ts.optimizer)  # Adam's state made
    minibatch = count(lambda: ppo._learn_step(mb, ts.model, ts.optimizer)).total

    def remainder():
        _, last_obs = ppo._final(c)
        with torch.no_grad():
            _, v = ts.model(last_obs)
        ppo._metrics(c.traj, ppo._minibatch_carry(ts, c.traj, v))

    return {"collector step": collector, "minibatch step": minibatch,
            "eager remainder (T=8)": count(remainder).total}


def twokey_sweep_counts() -> dict:
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_twokey as TT

    env = make("BabyAI-UnlockToUnlock-v0")
    states = env.generate(torch.Generator().manual_seed(0), env.params, 1, device="cpu")
    ball = (states.grid_obj == OBJ_BALL).reshape(1, -1).to(torch.int8).argmax(1, True)
    color = states.grid_color.reshape(1, -1).gather(1, ball)[:, 0]
    layout = TT.extract_twokey_layout(states, 2, OBJ_BALL, color)
    v = TT._empty_v(layout)
    tables = TT._tables(layout, v.shape[1])

    def sweep():
        nxt = torch.empty_like(v)
        for d, t in enumerate(tables):
            best = None
            for q in TT._action_values(v, t, d, layout.box_idx, 0.995):
                best = q if best is None else torch.maximum(best, q)
            nxt[:, :, :, :, d] = best

    c = count(sweep, big_numel=v[:, :, :, :, 0].numel())
    return {"operators": c.total, "with views": c.with_views, "full-block outputs": c.big,
            "V shape": tuple(v.shape)}


def main(argv) -> int:
    torch.set_num_threads(1)
    for env_id in argv or IDS:
        print(env_id, step_counts(env_id), flush=True)
    print("two-key sweep", twokey_sweep_counts(), flush=True)
    print("PPO on BabyAI-GoToDoor", ppo_counts(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
