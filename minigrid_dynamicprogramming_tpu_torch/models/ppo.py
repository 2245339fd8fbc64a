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

* after GAE (each rank on its own ``(T, B / N)`` envs), one all-gather
  an update puts the learner's inputs (observation, actions, log-probs,
  values, advantages, returns) of all ``num_envs`` envs on every rank,
  global env ``e = r * B / N + j`` of rank r's column j;
* the minibatches are global: every rank draws the same permutation of
  all ``num_envs`` from the learner generator, seeded alike on every rank;
  minibatch ``i`` of epoch ``e`` is positions ``[i * mb, (i + 1) * mb)`` of
  ``perms[e]``, ``mb = num_envs // num_minibatches``, as in JAX;
* a rank's share of a minibatch has a fixed size, ``S = ceil(mb / N)``
  rows (``minibatch_shares``): rank r takes positions ``r * S`` up to
  ``min((r + 1) * S, mb)`` of the minibatch at weight 1.0, and pads the
  rest of its ``S`` with the minibatch's first row at weight 0.0, so every
  row of the minibatch counts once over the ranks;
* the advantage is normalized by the minibatch's global mean and
  standard deviation (weighted sums over the ranks);
* each loss term is the rank's weighted sum over its rows divided by the
  summed weight (the global minibatch size), so the summed gradients are
  those of the global mean; they are summed in one flat buffer before the
  global-norm clip;
* the metrics are global.

Without a group, or at one rank, no row is padded and every weight is
1.0, so the ungrouped learner runs the same step on its own rows.

The collector's draws (the policy's actions, the pool or the regenerated
layouts, the hooks') come from the rank's generator, seeded from ``(seed,
rank)`` (``sharding.sharded_keys``; an ungrouped PPO is rank 0 of one);
the minibatch permutations from the learner generator; the parameters are
drawn on the CPU from the seed, so they are the same on any device.

JAX compiles the whole update into one program, its collector and its
minibatch loop each a ``lax.scan``.  Here each loop has a step that reads
and writes only tensors of fixed address, its index on the device: the
collector's (``_collect_step``: the observation of the carried lanes, the
policy's draw, the step's row of the trajectory, the env step and
auto-reset through the lane engine's plain step, ``lanes.AutoresetStep``)
and the learner's (``_learn_step``: the rank's share of the minibatch's
envs through the epoch's permutation, the loss, its backward, the clip
and Adam, the step's loss terms).  On a CUDA device each step is captured
once as a CUDA graph (``lanes.capture_step``) and replayed,
``rollout_len`` and ``epochs * num_minibatches`` times an update; on the
CPU the same steps run in Python loops, as they do on any device in
``_update_eager``, the plain version that the graphed update is held to.
GAE, the epochs' permutations (drawn before the first minibatch step) and
the metrics run eagerly.  A ``PPO`` keeps its graphs across updates and
captures one again only when it would read another TrainState's objects:
another model, optimizer, pool or generator, or an optimizer whose state
tensors were replaced (``load_state_dict``).  A failed capture raises.
The collector is graphed in every autoreset mode: in ``"regen"`` its
step generates a fresh batch of layouts with ``env.generate``, which
copies no host data and reads nothing back (its constant tables are made
by the capture's warm-up).  The learner's graph holds its collectives
(the advantage's moments, the flat gradient) where the group's backend
can capture them: without a group and under NCCL it is graphed, at any
number of ranks; under gloo, whose collectives on CUDA tensors go through
the host, it stays eager, by rule (``sharding.captures_collectives``,
decided once in ``__init__``).  Every rank then captures, warms up and
replays in step, each collective of the warm-up run once before the
capture.  The trajectory's all-gather runs in the eager prologue with GAE
and the permutations: it is once an update, where the graph's step is
replayed ``epochs * num_minibatches`` times.  On the card the optimizer
is Adam with ``capturable=True`` (its step count on the device), in the
graphed and the eager update alike.

Spans (``utils/profiling.py``): an update is ``ppo.update``, holding
``ppo.collector``, ``ppo.bootstrap`` (the last observation's value) and
``ppo.learner`` (GAE, the permutations, the minibatch steps and the
metrics); each loop is ``ppo.<loop>.replay`` and each capture
``ppo.<loop>.capture``.  The steps' parts are ``graph_span``s, stamped
into a graph captured while tracing is on; a kept graph is captured again
when tracing has been switched on or off since, so an untraced update
replays no stamp.

Run from the repository root (on the card by default)::

    python -m minigrid_dynamicprogramming_tpu_torch.models.ppo --env-id MiniGrid-Empty-8x8-v0
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState, resolve_device
from minigrid_dynamicprogramming_tpu_torch.models.nets import ActorCritic, init_params
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import (
    EnvGroup,
    all_gather,
    all_reduce,
    captures_collectives,
    rank_seed,
    replicated,
)
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

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


def sample_actions(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One action a row of ``(B, A)`` logits, drawn from their softmax as
    ``torch.multinomial(probs, 1, generator=generator)`` draws it (an
    exponential race, the same draws from the same generator state),
    without the check of its input that ``multinomial`` reads back to the
    host on a CUDA device.  Returns ``(B,)`` int64."""
    probs = logits.softmax(-1)
    return (probs / torch.empty_like(probs).exponential_(generator=generator)).argmax(-1)


def ppo_loss(
    model: ActorCritic,
    cfg: PPOConfig,
    mb,
    group: Optional[EnvGroup] = None,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple]:
    """The clipped PPO loss of one minibatch ``(obs, action, old_logp,
    old_value, adv, ret)`` (flat leading axis); returns ``(loss,
    (policy_loss, value_loss, entropy, approx_kl))``.  Every mean is a sum
    weighted by ``weight`` (1.0 a row by default) over the summed weight.

    With a ``group``, ``mb`` is this rank's share of a global minibatch:
    the count, the advantage's mean and its standard deviation are
    weighted sums over the ranks, and each term is the rank's weighted sum
    divided by the global count, so the terms and their gradients sum over
    the ranks to the global minibatch's.  A row at weight 0 counts
    nowhere."""
    obs, action, old_logp, old_value, adv, ret = mb
    if weight is None:
        weight = torch.ones_like(adv)
    logits, value = model(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action[:, None]).squeeze(-1)
    ratio = torch.exp(logp - old_logp)
    # The minibatch's size, mean and (two-pass, uncorrected) deviation.
    moments = all_reduce(torch.stack([weight.sum(), (weight * adv).sum()]), group)
    n = moments[0]
    mean = moments[1] / n
    std = (all_reduce((weight * (adv - mean) ** 2).sum(), group) / n).sqrt()
    adv = (adv - mean) / (std + 1e-8)
    pg1 = ratio * adv
    pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -(weight * torch.minimum(pg1, pg2)).sum() / n
    v_clipped = old_value + (value - old_value).clamp(-cfg.clip_eps, cfg.clip_eps)
    value_loss = 0.5 * (weight * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2)).sum() / n
    entropy = -(weight * (logp_all.exp() * logp_all).sum(-1)).sum() / n
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    approx_kl = (weight * (old_logp - logp)).sum() / n
    return loss, (policy_loss, value_loss, entropy, approx_kl)


def minibatch_shares(minibatch: int, world: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank's share of a global minibatch of ``minibatch`` rows, of one
    size ``S = ceil(minibatch / world)`` on every rank: rank r takes
    positions ``r * S`` up to ``min((r + 1) * S, minibatch)`` at weight 1.0
    and pads the rest of its ``S`` with position 0 at weight 0.0.  Returns
    ``(positions, weights)``, ``(world, S)`` int64 and float32 on the CPU;
    over the ranks, every position is taken once at weight 1.0."""
    size = -(-minibatch // world)
    positions = torch.arange(world * size).view(world, size)
    real = positions < minibatch
    return torch.where(real, positions, 0), real.to(torch.float32)


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


class _Rollout(NamedTuple):
    """The collector's carry, each tensor at a fixed address: the lanes
    and reset counts it carries, the step index ``t`` on the device, and
    the ``(T, B, ...)`` trajectory that each step writes at ``t``."""

    ls: L.LaneState
    reset_count: torch.Tensor  # (B,) i32
    t: torch.Tensor  # () i64
    traj: Trajectory


class _Minibatches(NamedTuple):
    """The learner's carry, each tensor at a fixed address: this rank's
    advantages and returns, the learner's inputs of all ``num_envs`` envs,
    every epoch's permutation of them, the minibatch step's index ``k`` on
    the device and each step's five loss terms (loss, policy, value,
    entropy, KL).

    ``batch`` is ``(obs, actions, logps, values, advantages, returns)``,
    each flat over its rows ``(N, T, B / N)``: the row of step t of global
    env e is ``(e // (B / N)) * T * B / N + t * B / N + e % (B / N)``.  With
    a group it is the all-gather's buffers; without one (N = 1), the
    trajectory's own tensors and the carry's advantages and returns."""

    advantages: torch.Tensor  # (T, B) f32
    returns: torch.Tensor  # (T, B) f32
    batch: tuple  # (T * num_envs, ...) each
    perms: torch.Tensor  # (epochs, num_envs) i64
    k: torch.Tensor  # () i64
    terms: torch.Tensor  # (epochs * num_minibatches, 5) f32


def _same(a: tuple, b: Optional[tuple]) -> bool:
    return b is not None and len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _map_traj(fn, traj: Trajectory) -> Trajectory:
    return Trajectory(
        obs={k: fn(v) for k, v in traj.obs.items()},
        **{name: fn(getattr(traj, name)) for name in Trajectory._fields[1:]},
    )


def _traj_tensors(traj: Trajectory) -> list:
    return [*traj.obs.values(), *traj[1:]]


def _map_batch(fn, batch: tuple) -> tuple:
    """``fn`` over a learner batch ``(obs, actions, ...)``."""
    return ({k: fn(v) for k, v in batch[0].items()}, *(fn(x) for x in batch[1:]))


def _batch_tensors(batch: tuple) -> list:
    return [*batch[0].values(), *batch[1:]]


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
        L.autoreset_rounds(config.autoreset, config.pool_rounds)  # raises on an unknown mode
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
        # This rank's share of a global minibatch, fixed at construction:
        # its positions in the minibatch and each row's weight, t-major.
        positions, weights = minibatch_shares(config.num_envs // config.num_minibatches, self.world)
        self._share = positions[self.rank].to(self.device)
        self._row_weight = weights[self.rank].repeat(config.rollout_len).to(self.device)
        # Whether an update replays its loops as CUDA graphs: on a CUDA
        # device; the learner only where a graph can hold its collectives.
        self._capture = self.device.type == "cuda"
        self._capture_learner = captures_collectives(group)
        # The carries, made at first use; the trajectory is both's.
        self._traj: Optional[Trajectory] = None
        self._rollout: Optional[_Rollout] = None
        self._minibatches: Optional[_Minibatches] = None
        # Each graph, and what it reads that a TrainState brings.
        self._graphs: Dict[str, Tuple[torch.cuda.CUDAGraph, tuple]] = {}
        self.captures = {"collector": 0, "learner": 0}
        self.capture_ms = {"collector": 0.0, "learner": 0.0}
        self.pool_bytes = {"collector": 0, "learner": 0}
        self.gather_bytes = 0  # the all-gather's buffers, with a group

    # -- initialization ------------------------------------------------------
    def init(self, seed: int = 0) -> TrainState:
        cfg, env, dev, B = self.config, self.env, self.device, self.num_envs
        model = ActorCritic(num_actions=env.action_dim, view=env.params.agent_view_size)
        model = init_params(model, torch.Generator().manual_seed(seed)).to(dev)
        if self.group is not None:
            with torch.no_grad():
                for p, q in zip(model.parameters(), replicated(list(model.parameters()), self.group)):
                    p.copy_(q)
        # On the card Adam keeps its step on the device, as a capture needs.
        optimizer = torch.optim.Adam(
            model.parameters(), lr=cfg.lr, eps=1e-5, capturable=dev.type == "cuda"
        )
        g = torch.Generator(device=dev).manual_seed(rank_seed(seed, self.rank))
        if cfg.autoreset == "regen":
            pool = None
            env_state = env.generate(g, env.params, B, dev)
        else:
            pool = L.lane_pool(env, g, B, cfg.autoreset, cfg.pool_rounds, dev)
            env_state = L.from_lanes(env.params, pool.round(0))
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
        updated in place.  Nothing waits for the device.  Every tensor
        returned is the caller's own: the next update writes none of
        them."""
        return self._update(ts, eager=False)

    def _update_eager(self, ts: TrainState) -> Tuple[TrainState, UpdateMetrics]:
        """:meth:`update` with both steps run in Python loops on any
        device: the plain version that the graphed update is held to."""
        return self._update(ts, eager=True)

    def _update(self, ts: TrainState, eager: bool) -> Tuple[TrainState, UpdateMetrics]:
        with profiling.span("ppo.update"):
            with profiling.span("ppo.collector"):
                c = self._run_collector(ts, eager)
            with profiling.span("ppo.bootstrap"):
                env_state, last_obs = self._final(c)
                with torch.no_grad():
                    _, last_value = ts.model(last_obs)
            with profiling.span("ppo.learner"):
                metrics = self._learn(ts, c.traj, last_value, eager)
        return (
            ts._replace(
                env_state=env_state,
                obs=last_obs,
                update_idx=ts.update_idx + 1,
                reset_count=c.reset_count.clone(),
            ),
            metrics,
        )

    def _final(self, c: _Rollout):
        """The carried lanes as a batch-first state and its observation,
        both copies."""
        ls = c.ls.clone()
        return L.from_lanes(self.env.params, ls), self.env.observation_lanes(ls)

    # -- the collector -------------------------------------------------------
    def _collect(self, ts: TrainState):
        """The ``(T, B)`` rollout on the lane engine with auto-reset;
        returns ``(env_state, last_obs, reset_count, trajectory)``, copies
        of the carry's."""
        c = self._run_collector(ts, eager=False)
        env_state, last_obs = self._final(c)
        return env_state, last_obs, c.reset_count.clone(), _map_traj(torch.clone, c.traj)

    def _rollout_carry(self, ts: TrainState) -> _Rollout:
        if self._rollout is None:
            cfg, dev = self.config, self.device
            ls = L.to_lanes(ts.env_state).clone()
            obs = self.env.observation_lanes(ls)
            T, B = cfg.rollout_len, self.num_envs

            def buf(x, dtype=None):
                return torch.empty((T, *x.shape), dtype=dtype or x.dtype, device=dev)

            if self._traj is None:
                row = torch.empty(B, dtype=torch.float32, device=dev)
                self._traj = Trajectory(
                    obs={k: buf(v) for k, v in obs.items()},
                    actions=buf(row, torch.int64),
                    logps=buf(row),
                    values=buf(row),
                    rewards=buf(row),
                    dones=buf(row, torch.bool),
                )
            self._rollout = _Rollout(
                ls=ls,
                reset_count=torch.zeros(B, dtype=torch.int32, device=dev),
                t=torch.zeros((), dtype=torch.int64, device=dev),
                traj=self._traj,
            )
        return self._rollout

    def _load(self, c: _Rollout, ts: TrainState) -> None:
        """The TrainState's lanes and reset counts into the carry, at step 0."""
        c.ls.copy_(L.to_lanes(ts.env_state))
        c.reset_count.copy_(ts.reset_count)
        c.t.zero_()

    def _collect_step(self, c: _Rollout, model: ActorCritic, pool, g: torch.Generator) -> None:
        """One step of JAX's rollout body, in its order, on the carry
        ``c``: the observation of the carried lanes, the policy's draw, the
        env step and auto-reset (``lanes.AutoresetStep``).  It reads the
        model's parameters in place, the pool and the generator, and
        writes nothing but ``c``.  Its parts are ``graph_span``s:
        ``ppo.collect.step`` holds ``ppo.collect.observation``,
        ``ppo.collect.policy`` (the forward, the draw and its
        log-probability) and ``ppo.collect.env`` (the env step, the
        trajectory's writes and auto-reset)."""
        env, cfg = self.env, self.config
        t = c.t.view(1)
        with torch.no_grad(), profiling.graph_span("ppo.collect.step"):
            with profiling.graph_span("ppo.collect.observation"):
                obs = env.observation_lanes(c.ls)
            with profiling.graph_span("ppo.collect.policy"):
                logits, value = model(obs)
                action = sample_actions(logits, g)
                logp = logits.log_softmax(-1).gather(1, action[:, None])[:, 0]
            with profiling.graph_span("ppo.collect.env"):
                plain = L.AutoresetStep(env, cfg.autoreset, cfg.pool_rounds, pool, g, self.num_envs,
                                        self.device)
                ls, reward, term, done, reset_count = plain.transition(c.ls, c.reset_count, action)
                # The observation reads the carried lanes (its direction is
                # their own tensor): its row is written before the reset.
                for k, x in obs.items():
                    c.traj.obs[k].index_copy_(0, t, x[None])
                for buf, x in zip(c.traj[1:], (action, logp, value, reward, done)):
                    buf.index_copy_(0, t, x[None])
                plain.reset(c.ls, c.reset_count, ls, done, reset_count, plain.generate())
                c.t.add_(1)

    def _run_collector(self, ts: TrainState, eager: bool) -> _Rollout:
        """The rollout from ``ts`` in the carry: its step replayed as a
        CUDA graph ``rollout_len`` times, or, ``eager`` or where the
        collector is not graphed, called in a Python loop."""
        c = self._rollout_carry(ts)
        self._load(c, ts)
        model, pool, g = ts.model, ts.pool, ts.generator

        def step():
            self._collect_step(c, model, pool, g)

        if eager or not self._capture:
            with profiling.span("ppo.collector.replay"):
                for _ in range(self.config.rollout_len):
                    step()
            return c
        # The warm-up steps the carry itself; it is loaded again after.  In
        # "regen" the pool is None.
        self._graph("collector", (model, *model.parameters(), pool, g), step, step, g)
        self._load(c, ts)
        self._replay("collector", self.config.rollout_len)
        return c

    def _graph(self, name: str, reads: tuple, step, warmup, generator=None) -> None:
        """Keeps the graph ``name``, captured anew unless the one kept was
        captured reading the same objects ``reads``, with stamps in it
        while tracing is on and without them while it is off.  A capture is
        the span ``ppo.<name>.capture`` (``lanes.capture_in_span``); it
        counts ``ppo.captures.<name>``."""
        stamped = profiling.is_tracing()
        kept = self._graphs.pop(name, None)
        if kept is not None and _same(reads, kept[1]) and (kept[2] is not None) == stamped:
            self._graphs[name] = kept
            return
        if kept is not None:
            kept[0].reset()
        if stamped:
            profiling.load_stamps(self.device)

        def capture(stamps):
            graph, self.capture_ms[name], self.pool_bytes[name] = L.capture_step(
                step, warmup, self.device, generator, stamps
            )
            return graph, self.pool_bytes[name]

        graph, stamps = L.capture_in_span(f"ppo.{name}.capture", self.device, capture)
        self.captures[name] += 1
        profiling.count(f"ppo.captures.{name}")
        self._graphs[name] = (graph, reads, stamps)

    def _replay(self, name: str, n: int) -> None:
        """The kept graph ``name`` replayed ``n`` times (``ppo.<name>.replay``),
        then its stamps' records, if it holds stamps."""
        graph, _, stamps = self._graphs[name]
        with profiling.span(f"ppo.{name}.replay"):
            for _ in range(n):
                graph.replay()
            if stamps is not None:
                stamps.emit()

    # -- the learner ---------------------------------------------------------
    def _minibatch_carry(self, ts: TrainState, traj: Trajectory,
                         last_value: torch.Tensor) -> _Minibatches:
        """The learner's carry, made at first use, for ``traj``: its GAE,
        the learner's inputs of all envs (all-gathered over a group), the
        epochs' permutations from the learner generator, step 0."""
        cfg, dev, group = self.config, self.device, self.group
        if self._minibatches is None:
            self._minibatches = _Minibatches(
                advantages=torch.empty_like(traj.values),
                returns=torch.empty_like(traj.values),
                batch=None,
                perms=torch.empty((cfg.epochs, cfg.num_envs), dtype=torch.int64, device=dev),
                k=torch.zeros((), dtype=torch.int64, device=dev),
                terms=torch.empty((cfg.epochs * cfg.num_minibatches, 5), device=dev),
            )
        mb = self._minibatches
        advantages, returns = _gae(
            traj.rewards, traj.values, traj.dones, last_value, cfg.gamma, cfg.gae_lambda
        )
        mb.advantages.copy_(advantages)
        mb.returns.copy_(returns)
        local = (traj.obs, traj.actions, traj.logps, traj.values, mb.advantages, mb.returns)
        if group is None:
            # One rank's rows are its own tensors', flat.
            batch = _map_batch(lambda x: x.flatten(0, 1), local)
        else:
            batch = mb.batch
            if batch is None:  # the all-gather's buffers, made at first use
                batch = _map_batch(
                    lambda x: x.new_empty((self.world * x.shape[0] * x.shape[1], *x.shape[2:])), local
                )
                self.gather_bytes = sum(x.nbytes for x in _batch_tensors(batch))
            for out, x in zip(_batch_tensors(batch), _batch_tensors(local)):
                all_gather(out, x, group)
        mb = self._minibatches = mb._replace(batch=batch)
        for e in range(cfg.epochs):
            mb.perms[e] = torch.randperm(cfg.num_envs, generator=ts.learner_generator, device=dev)
        mb.k.zero_()
        return mb

    def _learn_step(self, mb: _Minibatches, model: ActorCritic,
                    optimizer: torch.optim.Optimizer) -> None:
        """Minibatch step ``mb.k``: this rank's share of the global
        minibatch (``S`` envs through the epoch's permutation, all steps,
        with their weights), the clipped loss, its gradients (summed over
        the group's ranks), the global-norm clip and Adam; the loss terms
        written at ``k``.  Every rank runs it alike, on ``T * S`` rows; it
        reads and writes only tensors of fixed address (the model's, the
        optimizer's, the carry's and the share's).  Its parts are
        ``graph_span``s: ``ppo.minibatch`` holds ``ppo.forward`` (the
        gather, the forward and the loss), ``ppo.backward`` (with the
        group's all-reduce) and ``ppo.optimizer`` (the clip and Adam)."""
        cfg, T, per = self.config, self.config.rollout_len, self.num_envs
        k = mb.k.view(1)
        with profiling.graph_span("ppo.minibatch"):
            with profiling.graph_span("ppo.forward"):
                envs = mb.perms.view(-1, cfg.num_envs // cfg.num_minibatches).index_select(0, k)[0]
                envs = envs.index_select(0, self._share)
                # Their rows of the batch, step-major: (T, S) -> (T * S,).
                steps = torch.arange(T, device=envs.device)[:, None] * per
                rows = ((envs // per) * (T * per) + envs % per + steps).flatten()
                batch = _map_batch(lambda x: x.index_select(0, rows), mb.batch)
                loss, aux = ppo_loss(model, cfg, batch, self.group, self._row_weight)
            params = list(model.parameters())
            with profiling.graph_span("ppo.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if self.group is not None:
                    all_reduce_grads_(params, self.group)
            with profiling.graph_span("ppo.optimizer"):
                clip_by_global_norm_(params, cfg.max_grad_norm)
                optimizer.step()
            mb.terms.index_copy_(0, k, torch.stack([loss.detach(), *(a.detach() for a in aux)])[None])
            mb.k.add_(1)

    def _fixed_traj(self, traj: Trajectory) -> Trajectory:
        """The trajectory at the carry's addresses: ``traj`` copied into
        them, unless it is the carry's own."""
        if self._traj is None:
            self._traj = _map_traj(torch.empty_like, traj)
        fixed = self._traj
        for dst, src in zip(_traj_tensors(fixed), _traj_tensors(traj)):
            if dst is not src:
                dst.copy_(src)
        return fixed

    def _learn(self, ts: TrainState, traj: Trajectory, last_value: torch.Tensor,
               eager: bool = False) -> UpdateMetrics:
        """GAE, then epochs x minibatches of clipped PPO steps on ``traj``
        (this rank's envs, ``(T, B / N, ...)``): the minibatch step
        replayed as a CUDA graph, or, ``eager`` or where the learner is not
        graphed (a gloo group's), called in a Python loop."""
        cfg = self.config
        n_steps = cfg.epochs * cfg.num_minibatches
        graphed = self._capture and self._capture_learner and not eager and n_steps > 0
        if graphed:
            traj = self._fixed_traj(traj)
        mb = self._minibatch_carry(ts, traj, last_value)
        model, optimizer = ts.model, ts.optimizer

        def step():
            self._learn_step(mb, model, optimizer)

        if not graphed:
            with profiling.span("ppo.learner.replay"):
                for _ in range(n_steps):
                    step()
        else:
            self._graph("learner", self._learner_reads(model, optimizer), step,
                        lambda: self._warm_up_learner(step, mb, model, optimizer))
            # A first capture made Adam's state, which the graph now reads.
            graph, _, stamps = self._graphs["learner"]
            self._graphs["learner"] = (graph, self._learner_reads(model, optimizer), stamps)
            self._replay("learner", n_steps)
        return self._metrics(traj, mb)

    def _metrics(self, traj: Trajectory, mb: _Minibatches) -> UpdateMetrics:
        """One reduction for every metric (over the group's ranks): each
        minibatch step's terms (the rank's shares), then the rollout's
        reward sum, reward count, episodes and terminal-reward sum."""
        n_steps = mb.terms.shape[0]
        dones = traj.dones.to(torch.float32)
        totals = torch.stack([
            traj.rewards.sum(),
            torch.full((), traj.rewards.numel(), dtype=traj.rewards.dtype, device=self.device),
            dones.sum(),
            (traj.rewards * dones).sum(),
        ])
        flat = all_reduce(torch.cat([mb.terms.flatten(), totals]), self.group)
        if n_steps:
            means = flat[:-4].view(n_steps, 5).mean(0)
        else:
            means = torch.full((5,), float("nan"), device=self.device)
        reward_sum, reward_count, n_done, return_sum = flat[-4:].unbind()
        return UpdateMetrics(
            *means.unbind(),
            mean_reward=reward_sum / reward_count,
            episodes=n_done.to(torch.int32),
            mean_return=torch.where(n_done > 0, return_sum / n_done.clamp(min=1), 0.0),
        )

    @staticmethod
    def _learner_reads(model, optimizer) -> tuple:
        """What the learner's graph reads that is not the PPO's own: the
        model, its parameters, the optimizer and its state's tensors."""
        state = [v for p in model.parameters() for v in optimizer.state.get(p, {}).values()
                 if isinstance(v, torch.Tensor)]
        return (model, *model.parameters(), optimizer, *state)

    @staticmethod
    def _warm_up_learner(step, mb: _Minibatches, model, optimizer) -> None:
        """One minibatch step, then the model, the optimizer's state and
        the step index put back in place (state the step created is
        zeroed, as Adam creates it); the gradients are dropped, so that the
        capture makes them in its pool."""
        params = list(model.parameters())
        saved = [p.detach().clone() for p in params]
        state = {p: {n: v.clone() for n, v in optimizer.state[p].items()}
                 for p in params if optimizer.state.get(p)}
        step()
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
            for p in params:
                for n, v in optimizer.state[p].items():
                    if p in state:
                        v.copy_(state[p][n])
                    else:
                        v.zero_()
        mb.k.zero_()
        optimizer.zero_grad(set_to_none=True)


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
