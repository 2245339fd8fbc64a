"""Plain reference of the learner half of one PPO update as the port runs
it (``models/ppo.py``; CleanRL's PPO, the JAX package's optax chain),
in float32 with autograd:

* generalized advantage estimation over a (T, B) rollout, a done step
  zeroing the bootstrap (``gae``);
* the clipped loss of a minibatch (``loss_and_grads``): the advantage
  normalised over the minibatch by its mean and its two-pass, uncorrected
  deviation (plus 1e-8), the clipped surrogate, the clipped value loss
  (times 0.5), the entropy and the approximate KL ``mean(old_logp -
  logp)``; loss = policy + vf_coef * value - ent_coef * entropy;
* its gradients by autograd, scaled by ``max_norm / norm`` where their
  global norm exceeds ``max_norm`` (optax's ``clip_by_global_norm``);
* Adam with bias correction (``adam_step``: PyTorch's and optax's update,
  ``eps`` added to the corrected root);
* ``learn``: ``epochs x num_minibatches`` such steps, minibatch ``i`` of
  epoch ``e`` the envs at positions ``[i * S, (i + 1) * S)`` of the given
  permutation ``perms[e]``, each through all T steps (T * S rows).

The network is ``reference/actor_critic.py``'s; ``rnd`` and ``rnd_head``
round what it computes in the program's compute dtype and in float32
(``actor_critic.forward``), and ``rnd_head`` also rounds Adam's moments and
the parameters it writes (the identity for the reference, ``bf16`` for the
control, whose optimizer computes one step below float32).  A minibatch's forward
and backward run in blocks of rows, the gradients and the loss terms
summed over the blocks: every term is a sum over rows divided by the
minibatch's size, so the blocks change nothing but the order of the sums.

Departures from the port: none in what is computed; the loss terms are
summed in float64.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from portbench.reference import actor_critic as ac

TERMS = ("loss", "policy_loss", "value_loss", "entropy", "approx_kl")


class Settings(NamedTuple):
    gamma: float
    gae_lambda: float
    clip_eps: float
    vf_coef: float
    ent_coef: float
    lr: float
    adam_eps: float
    adam_betas: Tuple[float, float]
    max_grad_norm: float
    epochs: int
    num_minibatches: int


def settings(ppo: dict, epochs: int, num_minibatches: int) -> Settings:
    """The settings from a configuration's ``ppo`` group and the traffic's
    epochs and minibatches."""
    return Settings(ppo["gamma"], ppo["gae_lambda"], ppo["clip_eps"], ppo["vf_coef"],
                    ppo["ent_coef"], ppo["lr"], ppo["adam_eps"], tuple(ppo["adam_betas"]),
                    ppo["max_grad_norm"], epochs, num_minibatches)


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """``(advantages, returns)`` of a (T, B) rollout."""
    nonterminal = 1.0 - dones.to(torch.float32)
    advantages = torch.empty_like(values)
    running = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        running = delta + gamma * lam * nonterminal[t] * running
        advantages[t] = running
        next_value = values[t]
    return advantages, advantages + values


def loss_and_grads(params: ac.Params, s: Settings, mb: tuple, rnd: Callable = ac.identity,
                   block: Optional[int] = None, rnd_head: Callable = ac.identity):
    """The loss terms (``TERMS``, float64, (5,)) of one minibatch ``(obs,
    action, old_logp, old_value, adv, ret)`` (flat leading axis) and the
    loss's gradient of every parameter, in ``block``-row pieces."""
    obs, action, old_logp, old_value, adv, ret = mb
    n = adv.shape[0]
    mean = adv.sum() / n
    std = (((adv - mean) ** 2).sum() / n).sqrt()
    adv = (adv - mean) / (std + 1e-8)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    terms = torch.zeros(5, dtype=torch.float64, device=adv.device)
    block = block or n
    for lo in range(0, n, block):
        sl = slice(lo, lo + block)
        logits, value = ac.forward(leaves, {k: v[sl] for k, v in obs.items()}, rnd, rnd_head)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, action[sl, None]).squeeze(-1)
        ratio = torch.exp(logp - old_logp[sl])
        a = adv[sl]
        policy = -torch.minimum(ratio * a, ratio.clamp(1 - s.clip_eps, 1 + s.clip_eps) * a).sum() / n
        v_clipped = old_value[sl] + (value - old_value[sl]).clamp(-s.clip_eps, s.clip_eps)
        value_loss = 0.5 * torch.maximum((value - ret[sl]) ** 2, (v_clipped - ret[sl]) ** 2).sum() / n
        entropy = -(logp_all.exp() * logp_all).sum(-1).sum() / n
        loss = policy + s.vf_coef * value_loss - s.ent_coef * entropy
        loss.backward()
        kl = (old_logp[sl] - logp).sum() / n
        terms += torch.stack([loss, policy, value_loss, entropy, kl]).detach().double()
    return terms, {k: v.grad for k, v in leaves.items()}


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {k: g * scale for k, g in grads.items()}


class AdamState(NamedTuple):
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    step: Dict[str, int]


def adam_step(params: ac.Params, grads, state: AdamState, s: Settings,
              rnd: Callable = ac.identity) -> Tuple[ac.Params, AdamState]:
    """One Adam step: ``m`` and ``v`` the moving averages of the gradient
    and its square, corrected by ``1 - beta**step``; ``p -= lr * m_hat /
    (sqrt(v_hat) + eps)``; ``m``, ``v`` and ``p`` stored through ``rnd``.
    Returns new dicts."""
    b1, b2 = s.adam_betas
    new_p, m, v, steps = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        steps[k] = state.step[k] + 1
        m[k] = rnd(b1 * state.exp_avg[k] + (1 - b1) * g)
        v[k] = rnd(b2 * state.exp_avg_sq[k] + (1 - b2) * g * g)
        bc1, bc2 = 1 - b1 ** steps[k], 1 - b2 ** steps[k]
        new_p[k] = rnd(p - (s.lr / bc1) * m[k] / (v[k].sqrt() / math.sqrt(bc2) + s.adam_eps))
    return new_p, AdamState(m, v, steps)


def learn(params: ac.Params, adam: AdamState, batch: tuple, perms: torch.Tensor, s: Settings,
          rnd: Callable = ac.identity, block: Optional[int] = None, rnd_head: Callable = ac.identity):
    """The learner's ``epochs x num_minibatches`` steps on ``batch`` =
    ``(obs, actions, old_logps, old_values, advantages, returns)``, each
    (T, B, ...), from ``params`` and Adam's state ``adam``.  Returns the
    final parameters, Adam's state and the loss terms of every step,
    (steps, 5) float64."""
    per = batch[1].shape[1] // s.num_minibatches
    terms: List[torch.Tensor] = []
    for e in range(s.epochs):
        for i in range(s.num_minibatches):
            envs = perms[e, i * per:(i + 1) * per]

            def rows(x):
                return x[:, envs].flatten(0, 1)  # step-major: (T, S) -> (T * S,)

            obs, *rest = batch
            mb = ({k: rows(v) for k, v in obs.items()}, *(rows(x) for x in rest))
            step_terms, grads = loss_and_grads(params, s, mb, rnd, block, rnd_head)
            grads = clip_by_global_norm(grads, s.max_grad_norm)
            params, adam = adam_step(params, grads, adam, s, rnd_head)
            terms.append(step_terms)
    return params, adam, torch.stack(terms)
