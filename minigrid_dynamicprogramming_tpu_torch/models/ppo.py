"""PPO over a batch of environments on one device.

Counterpart of ``minigrid_dynamicprogramming_tpu/models/ppo.py`` (single
device; the mesh and the gradient all-reduce are not ported yet).  One
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

Every draw (the policy's actions, the minibatch permutations, the pool or
the regenerated layouts, the hooks') comes from the train state's
``torch.Generator``; the parameters are drawn on the CPU from the seed, so
they are the same on any device.

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
    env_state: EnvState  # batch-first
    obs: Dict[str, torch.Tensor]  # the observation of env_state
    generator: torch.Generator
    update_idx: int
    pool: Optional[L.LaneState]  # (R, ..., B) layouts; None for "regen"
    reset_count: torch.Tensor  # (B,) i32 per-slot episode counter


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


def ppo_loss(model: ActorCritic, cfg: PPOConfig, mb) -> Tuple[torch.Tensor, Tuple]:
    """The clipped PPO loss of one minibatch ``(obs, action, old_logp,
    old_value, adv, ret)`` (flat leading axis); returns ``(loss,
    (policy_loss, value_loss, entropy, approx_kl))``."""
    obs, action, old_logp, old_value, adv, ret = mb
    logits, value = model(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[:, None]).squeeze(-1)
    ratio = torch.exp(logp - old_logp)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv
    pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -torch.minimum(pg1, pg2).mean()
    v_clipped = old_value + (value - old_value).clamp(-cfg.clip_eps, cfg.clip_eps)
    value_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    entropy = -(logp_all.exp() * logp_all).sum(-1).mean()
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    approx_kl = (old_logp - logp).mean()
    return loss, (policy_loss, value_loss, entropy, approx_kl)


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
    """One env id and one :class:`ActorCritic`, trained on ``device``."""

    def __init__(
        self,
        env: Environment,
        config: PPOConfig = PPOConfig(),
        device="cuda",
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
        self.device = resolve_device(device)
        self._skip = L._skip_fields(env.params)
        hooked = env.pre_step_lanes is not None or env.post_step_lanes is not None
        self._hook_draws = hooked and env.hook_rng

    # -- initialization ------------------------------------------------------
    def init(self, seed: int = 0) -> TrainState:
        cfg, env, dev = self.config, self.env, self.device
        model = ActorCritic(num_actions=env.action_dim, view=env.params.agent_view_size)
        model = init_params(model, torch.Generator().manual_seed(seed)).to(dev)
        optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5)
        g = torch.Generator(device=dev).manual_seed(seed)
        if cfg.autoreset == "regen":
            pool = None
            env_state = env.generate(g, env.params, cfg.num_envs, dev)
        else:
            pool = L._lane_pool(env, g, cfg.num_envs, cfg.autoreset, cfg.pool_rounds, dev)
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
            reset_count=torch.zeros(cfg.num_envs, dtype=torch.int32, device=dev),
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
        B, T, v = cfg.num_envs, cfg.rollout_len, p.agent_view_size
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
        """GAE, then epochs x minibatches of clipped PPO steps on ``traj``."""
        cfg = self.config
        B, T = cfg.num_envs, cfg.rollout_len
        mb_size = B // cfg.num_minibatches
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

        steps: List[torch.Tensor] = []
        for _ in range(cfg.epochs):
            perm = torch.randperm(B, generator=ts.generator, device=self.device)
            for i in range(cfg.num_minibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = tuple(take(x, idx) for x in batch)
                loss, aux = ppo_loss(ts.model, cfg, mb)
                ts.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_(params, cfg.max_grad_norm)
                ts.optimizer.step()
                steps.append(torch.stack([loss.detach(), *(a.detach() for a in aux)]))
        if steps:
            means = torch.stack(steps).mean(0)
        else:
            means = torch.full((5,), float("nan"), device=self.device)
        dones = traj.dones.to(torch.float32)
        n_done = dones.sum()
        return UpdateMetrics(
            *means.unbind(),
            mean_reward=traj.rewards.mean(),
            episodes=n_done.to(torch.int32),
            mean_return=torch.where(
                n_done > 0, (traj.rewards * dones).sum() / n_done.clamp(min=1), 0.0
            ),
        )


def train(
    env_id: str,
    config: PPOConfig = PPOConfig(),
    num_updates: int = 50,
    seed: int = 0,
    log_every: int = 10,
    device="cuda",
):
    """Host-side training loop; returns ``(final TrainState, history)``,
    the history a list of :class:`UpdateMetrics` of floats, one each
    ``log_every`` updates and the last."""
    from minigrid_dynamicprogramming_tpu_torch.registry import make

    ppo = PPO(make(env_id), config, device)
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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout_len)
    train(args.env_id, cfg, num_updates=args.updates, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
