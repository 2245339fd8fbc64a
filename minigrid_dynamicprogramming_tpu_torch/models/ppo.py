"""PPO over a batch of environments, on one device or data-parallel over
the ranks of a process group.

Counterpart of ``minigrid_dynamicprogramming_tpu/models/ppo.py``.  One
update:

* collects a ``(T, B)`` rollout on the lane engine (``parallel/lanes.py``):
  each step encodes the observation from the lanes, samples the policy,
  steps with the env's hooks and auto-resets finished envs (``"pool"``:
  the k-th reset of a slot takes pool round ``k % pool_rounds``;
  ``"cached"``: the slot's first layout; ``"regen"``: a fresh layout
  generated every step);
* computes generalized advantage estimates (a reverse loop over T);
* runs ``epochs`` x ``num_minibatches`` clipped-surrogate steps.
  Minibatches permute the env axis only, so each env's time steps stay
  together; the advantage is normalized per minibatch; the value loss is
  clipped; gradients are clipped to a global norm as optax does (scaled
  only when the norm exceeds it), then Adam with ``eps=1e-5``.

With a ``group`` (``parallel/sharding.py``), as under JAX's mesh, the
envs are split over the ranks (``num_envs`` stays the global count), the
parameters are replicated, and an update computes what the one-process
update computes:

* the minibatches are global: every rank draws the same permutation of
  all ``num_envs`` from the learner generator, seeded alike on every rank,
  and takes the members it holds (their count varies and may be 0; such a
  rank still joins every collective);
* the advantage is normalized by the minibatch's global mean and
  standard deviation (summed over the ranks);
* each loss term is the rank's sum over its rows divided by the global
  minibatch size, so the summed gradients are those of the global mean;
  they are summed in one flat buffer before the global-norm clip;
* the metrics are global.

The collector's draws (the policy's actions, the pool or the regenerated
layouts, the hooks') come from the rank's generator, seeded from ``(seed,
rank)`` (``sharding.sharded_keys``; an ungrouped PPO is rank 0 of one);
the minibatch permutations from the learner generator; the parameters are
drawn on the CPU from the seed, so they are the same on any device.

Run from the repository root (on the card by default)::

    python -m minigrid_dynamicprogramming_tpu_torch.models.ppo --env-id MiniGrid-Empty-8x8-v0
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState, resolve_device
from minigrid_dynamicprogramming_tpu_torch.models.nets import ActorCritic, init_params
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import (
    EnvGroup,
    all_reduce,
    rank_seed,
    replicated,
)

AUTORESETS = ("pool", "cached", "regen")
# One lane engine serves both of JAX's collectors.
COLLECTORS = ("lanes", "vmap")


@dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 4096
    rollout_len: int = 64
    epochs: int = 2
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 2.5e-4
    max_grad_norm: float = 0.5
    autoreset: str = "pool"
    pool_rounds: int = 4
    collector: str = "lanes"


class TrainState(NamedTuple):
    model: ActorCritic
    optimizer: torch.optim.Optimizer
    env_state: EnvState  # batch-first, this rank's envs
    obs: Dict[str, torch.Tensor]  # the observation of env_state
    generator: torch.Generator  # the collector's, this rank's own
    update_idx: int
    pool: Optional[L.LaneState]  # (R, ..., B) layouts; None for "regen"
    reset_count: torch.Tensor  # (B,) i32 per-slot episode counter
    learner_generator: torch.Generator  # the permutations', alike on every rank


class UpdateMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    mean_reward: torch.Tensor
    episodes: torch.Tensor
    mean_return: torch.Tensor  # mean terminal reward over finished episodes


class Trajectory(NamedTuple):
    """A ``(T, B, ...)`` rollout, obs the model's inputs at each step."""

    obs: Dict[str, torch.Tensor]
    actions: torch.Tensor  # (T, B) i64
    logps: torch.Tensor  # (T, B) f32
    values: torch.Tensor  # (T, B) f32
    rewards: torch.Tensor  # (T, B) f32
    dones: torch.Tensor  # (T, B) bool


def _gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over a ``(T, B)`` rollout; a done
    step zeroes the bootstrap, as auto-reset starts a new episode.
    Returns ``(advantages, returns)``."""
    nonterminal = 1.0 - dones.to(torch.float32)
    advantages = torch.empty_like(values)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        gae = delta + gamma * lam * nonterminal[t] * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, advantages + values


def ppo_loss(
    model: ActorCritic, cfg: PPOConfig, mb, group: Optional[EnvGroup] = None
) -> Tuple[torch.Tensor, Tuple]:
    """The clipped PPO loss of one minibatch ``(obs, action, old_logp,
    old_value, adv, ret)`` (flat leading axis); returns ``(loss,
    (policy_loss, value_loss, entropy, approx_kl))``.

    With a ``group``, ``mb`` is this rank's rows of a global minibatch (any
    number, 0 included): the advantage is normalized by the global mean
    and standard deviation, and each term is the rank's sum over its rows
    divided by the global row count, so the terms and their gradients sum
    over the ranks to the global minibatch's."""
    obs, action, old_logp, old_value, adv, ret = mb
    logits, value = model(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[:, None]).squeeze(-1)
    ratio = torch.exp(logp - old_logp)
    # The minibatch's size, mean and (two-pass, uncorrected) deviation.
    moments = all_reduce(torch.stack([adv.new_tensor(adv.numel()), adv.sum()]), group)
    n = moments[0]
    mean = moments[1] / n
    std = (all_reduce(((adv - mean) ** 2).sum(), group) / n).sqrt()
    adv = (adv - mean) / (std + 1e-8)
    pg1 = ratio * adv
    pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -torch.minimum(pg1, pg2).sum() / n
    v_clipped = old_value + (value - old_value).clamp(-cfg.clip_eps, cfg.clip_eps)
    value_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).sum() / n
    entropy = -(logp_all.exp() * logp_all).sum() / n
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    approx_kl = (old_logp - logp).sum() / n
    return loss, (policy_loss, value_loss, entropy, approx_kl)


def all_reduce_grads_(params, group: EnvGroup) -> None:
    """Sum the gradients of ``params`` over the group's ranks, in one flat
    buffer; a parameter with no gradient counts as zeros."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` by ``max_norm / norm`` where their
    global norm exceeds ``max_norm`` (optax's ``clip_by_global_norm``, with
    no epsilon added to the norm); returns the norm.  No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class PPO:
    """One env id and one :class:`ActorCritic`, trained on ``device``, or
    on each rank's ``group.device`` (``device`` is then not read)."""

    def __init__(
        self,
        env: Environment,
        config: PPOConfig = PPOConfig(),
        device="cuda",
        group: Optional[EnvGroup] = None,
    ):
        if config.autoreset not in AUTORESETS:
            raise ValueError(f"unknown autoreset mode {config.autoreset!r}")
        if config.collector not in COLLECTORS:
            raise ValueError(f"unknown collector {config.collector!r}")
        if config.num_envs % config.num_minibatches:
            raise ValueError("num_envs must be a multiple of num_minibatches")
        if not L.supports_lanes(env):
            raise ValueError(f"{env.env_id}: the lane engine does not cover its hooks")
        self.env = env
        self.config = config
        self.group = group
        if group is None:
            self.device, self.rank, self.world = resolve_device(device), 0, 1
        else:
            self.device, self.rank, self.world = group.device, group.rank, group.world_size
            group.slice(config.num_envs)  # raises unless the envs divide over the ranks
        self.num_envs = config.num_envs // self.world  # this rank's
        self._skip = L._skip_fields(env.params)
        hooked = env.pre_step_lanes is not None or env.post_step_lanes is not None
        self._hook_draws = hooked and env.hook_rng

    # -- initialization ------------------------------------------------------
    def init(self, seed: int = 0) -> TrainState:
        cfg, env, dev, B = self.config, self.env, self.device, self.num_envs
        model = ActorCritic(num_actions=env.action_dim, view=env.params.agent_view_size)
        model = init_params(model, torch.Generator().manual_seed(seed)).to(dev)
        if self.group is not None:
            with torch.no_grad():
                for p, q in zip(model.parameters(), replicated(list(model.parameters()), self.group)):
                    p.copy_(q)
        optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5)
        g = torch.Generator(device=dev).manual_seed(rank_seed(seed, self.rank))
        if cfg.autoreset == "regen":
            pool = None
            env_state = env.generate(g, env.params, B, dev)
        else:
            pool = L._lane_pool(env, g, B, cfg.autoreset, cfg.pool_rounds, dev)
            env_state = L.from_lanes(
                env.params, L.LaneState(**{n: getattr(pool, n)[0] for n in L._FIELDS})
            )
        return TrainState(
            model=model,
            optimizer=optimizer,
            env_state=env_state,
            obs=env.observation(env_state),
            generator=g,
            update_idx=0,
            pool=pool,
            reset_count=torch.zeros(B, dtype=torch.int32, device=dev),
            learner_generator=torch.Generator(device=dev).manual_seed(seed),
        )

    # -- one full PPO update -------------------------------------------------
    def update(self, ts: TrainState) -> Tuple[TrainState, UpdateMetrics]:
        """One rollout and its learner phase; the model and optimizer are
        updated in place.  Nothing waits for the device."""
        env_state, last_obs, reset_count, traj = self._collect(ts)
        with torch.no_grad():
            _, last_value = ts.model(last_obs)
        metrics = self._learn(ts, traj, last_value)
        return (
            ts._replace(
                env_state=env_state,
                obs=last_obs,
                update_idx=ts.update_idx + 1,
                reset_count=reset_count,
            ),
            metrics,
        )

    def _collect(self, ts: TrainState):
        """The ``(T, B)`` rollout on the lane engine with auto-reset;
        returns ``(env_state, last_obs, reset_count, trajectory)``."""
        cfg, env, dev = self.config, self.env, self.device
        p = env.params
        B, T, v = self.num_envs, cfg.rollout_len, p.agent_view_size
        g = ts.generator
        hook_gen = g if self._hook_draws else None
        rounds = ts.pool.agent_dir.shape[0] if ts.pool is not None else 0
        images = torch.empty((T, B, v, v, 3), dtype=torch.uint8, device=dev)
        directions = torch.empty((T, B), dtype=ts.obs["direction"].dtype, device=dev)
        missions = torch.empty((T, *ts.obs["mission"].shape), dtype=torch.int32, device=dev)
        actions = torch.empty((T, B), dtype=torch.int64, device=dev)
        logps, values, rewards = (torch.empty((T, B), device=dev) for _ in range(3))
        dones = torch.empty((T, B), dtype=torch.bool, device=dev)

        ls, obs, reset_count = L.to_lanes(ts.env_state), ts.obs, ts.reset_count
        with torch.no_grad():
            for t in range(T):
                logits, value = ts.model(obs)
                action = torch.multinomial(logits.softmax(-1), 1, generator=g)[:, 0]
                logps[t] = logits.log_softmax(-1).gather(1, action[:, None])[:, 0]
                ls, reward, term = L.step_lanes_env(env, ls, action, hook_gen)
                done = term | ls.truncated
                reset_count = reset_count + done.to(torch.int32)
                if ts.pool is None:
                    fresh = L.to_lanes(env.generate(g, p, B, dev))
                else:
                    fresh = L._select_pool(ts.pool, reset_count % rounds, rounds, self._skip)
                ls = L._select_lanes(done, fresh, ls, self._skip)
                images[t], directions[t], missions[t] = (
                    obs["image"], obs["direction"], obs["mission"]
                )
                actions[t], values[t], rewards[t], dones[t] = action, value, reward, done
                obs = env.observation_lanes(ls)
        traj = Trajectory(
            obs={"image": images, "direction": directions, "mission": missions},
            actions=actions, logps=logps, values=values, rewards=rewards, dones=dones,
        )
        return L.from_lanes(p, ls), obs, reset_count, traj

    def _learn(self, ts: TrainState, traj: Trajectory, last_value: torch.Tensor) -> UpdateMetrics:
        """GAE, then epochs x minibatches of clipped PPO steps on ``traj``
        (this rank's envs, ``(T, B / N, ...)``)."""
        cfg, group = self.config, self.group
        mb_size = cfg.num_envs // cfg.num_minibatches  # global
        lo = self.rank * self.num_envs
        advantages, returns = _gae(
            traj.rewards, traj.values, traj.dones, last_value, cfg.gamma, cfg.gae_lambda
        )
        batch = (traj.obs, traj.actions, traj.logps, traj.values, advantages, returns)
        params = list(ts.model.parameters())

        def take(x, idx):
            # (T, B, ...) -> (T * mb, ...): the minibatch's envs, all steps.
            if isinstance(x, dict):
                return {k: take(a, idx) for k, a in x.items()}
            return x.index_select(1, idx).flatten(0, 1)

        def mine(idx):
            # The members of a global minibatch this rank holds, as its own
            # env indices.
            if self.world == 1:
                return idx
            return idx[(idx >= lo) & (idx < lo + self.num_envs)] - lo

        steps: List[torch.Tensor] = []
        for _ in range(cfg.epochs):
            perm = torch.randperm(cfg.num_envs, generator=ts.learner_generator, device=self.device)
            for i in range(cfg.num_minibatches):
                mb = tuple(take(x, mine(perm[i * mb_size:(i + 1) * mb_size])) for x in batch)
                loss, aux = ppo_loss(ts.model, cfg, mb, group)
                ts.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if group is not None:
                    all_reduce_grads_(params, group)
                clip_by_global_norm_(params, cfg.max_grad_norm)
                ts.optimizer.step()
                steps.append(torch.stack([loss.detach(), *(a.detach() for a in aux)]))
        # One reduction for every metric: each step's terms (the rank's
        # shares), then the rollout's reward sum, reward count, episodes and
        # terminal-reward sum.
        dones = traj.dones.to(torch.float32)
        totals = torch.stack([
            traj.rewards.sum(), traj.rewards.new_tensor(traj.rewards.numel()),
            dones.sum(), (traj.rewards * dones).sum(),
        ])
        flat = all_reduce(torch.cat([torch.stack(steps).flatten(), totals]) if steps else totals, group)
        if steps:
            means = flat[:-4].view(len(steps), 5).mean(0)
        else:
            means = torch.full((5,), float("nan"), device=self.device)
        reward_sum, reward_count, n_done, return_sum = flat[-4:].unbind()
        return UpdateMetrics(
            *means.unbind(),
            mean_reward=reward_sum / reward_count,
            episodes=n_done.to(torch.int32),
            mean_return=torch.where(n_done > 0, return_sum / n_done.clamp(min=1), 0.0),
        )


def train(
    env_id: str,
    config: PPOConfig = PPOConfig(),
    num_updates: int = 50,
    seed: int = 0,
    log_every: int = 10,
    device="cuda",
    group: Optional[EnvGroup] = None,
):
    """Host-side training loop; returns ``(final TrainState, history)``,
    the history a list of :class:`UpdateMetrics` of floats (global over a
    ``group``'s ranks), one each ``log_every`` updates and the last."""
    from minigrid_dynamicprogramming_tpu_torch.registry import make

    ppo = PPO(make(env_id), config, device, group)
    ts = ppo.init(seed)
    history = []
    for u in range(num_updates):
        ts, m = ppo.update(ts)
        if (u + 1) % log_every == 0 or u == num_updates - 1:
            m = UpdateMetrics(*(float(x) for x in m))
            history.append(m)
            steps = (u + 1) * config.num_envs * config.rollout_len
            print(
                f"update {u + 1}/{num_updates} steps={steps} "
                f"loss={m.loss:.4f} return={m.mean_return:.3f} "
                f"episodes={int(m.episodes)} kl={m.approx_kl:.4f}",
                flush=True,
            )
    return ts, history


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="PPO on a Minigrid or BabyAI id")
    p.add_argument("--env-id", default="MiniGrid-Empty-8x8-v0")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default=None,
        help="cuda (the default), cpu, or cuda:N; with --distributed the rank's "
        "cuda:LOCAL_RANK by default",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="join the process group first (torchrun's environment) and train "
        "data-parallel; --num-envs is the global count",
    )
    args = p.parse_args(argv)
    cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout_len)
    group = None
    if args.distributed:
        from minigrid_dynamicprogramming_tpu_torch.parallel import distributed

        distributed.initialize(backend="gloo" if args.device == "cpu" else None)
        group = distributed.global_env_group(args.device)
        print(distributed.process_summary(), flush=True)
    train(args.env_id, cfg, num_updates=args.updates, seed=args.seed,
          device=args.device or "cuda", group=group)


if __name__ == "__main__":
    main()
