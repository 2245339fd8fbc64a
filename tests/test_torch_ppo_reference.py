"""The benchmark's plain reference of the PPO update on BabyAI-GoToDoor
(``portbench/reference/``) against the port, on the CPU at small sizes:

* the network (``actor_critic.py``) against ``ActorCritic`` at float32
  within 1e-5, and at the port's bfloat16 within bfloat16's rounding;
* the loss terms and gradients (``ppo_update.py``) against ``ppo_loss``
  and its backward at float32, on one minibatch with clipped ratios;
* one clipped Adam step against ``clip_by_global_norm_`` and
  ``torch.optim.Adam(eps=1e-5)``;
* the level (``babyai_gotodoor.py``) replaying the port's eager collector
  (``_update_eager``) exactly: observations, rewards, dones and resets,
  and judging the port's layouts valid and a layout without a door not;
* the update's spans: ``ppo.update`` holding ``ppo.collector``,
  ``ppo.bootstrap`` and ``ppo.learner``.
"""

from __future__ import annotations

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.models import PPO, ActorCritic, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
from minigrid_dynamicprogramming_tpu_torch.models.nets import init_params
from minigrid_dynamicprogramming_tpu_torch.utils import profiling
from portbench.drivers.ppo_update import pool_rounds, round_of, ref_state
from portbench.reference import actor_critic as ac
from portbench.reference import babyai_gotodoor as ref
from portbench.reference import ppo_update as ref_ppo

torch.set_num_threads(1)

ENV = "BabyAI-GoToDoor-v0"
CFG = PPOConfig()
SETTINGS = ref_ppo.Settings(CFG.gamma, CFG.gae_lambda, CFG.clip_eps, CFG.vf_coef, CFG.ent_coef,
                            CFG.lr, 1e-5, (0.9, 0.999), CFG.max_grad_norm, 1, 1)


def _model(dtype=torch.float32, seed: int = 0) -> ActorCritic:
    return init_params(ActorCritic(compute_dtype=dtype), torch.Generator().manual_seed(seed))


def _params(model) -> dict:
    return {k: v.detach() for k, v in model.named_parameters()}


def _obs(b: int, seed: int = 1) -> dict:
    """GoToDoor observations of ``b`` states a few random steps in."""
    env = port.make(ENV)
    g = torch.Generator().manual_seed(seed)
    _, state = env.reset(g, b, "cpu")
    for _ in range(6):
        obs, state, *_ = env.step(state, torch.randint(0, 7, (b,), generator=g))
    return obs


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_network_equals_the_port_at_float32(seed):
    obs = _obs(64, seed)
    model = _model(seed=seed)
    with torch.no_grad():
        logits, value = model(obs)
    want_logits, want_value = ac.forward(_params(model), obs)
    assert _rel(logits, want_logits) <= 1e-5 and _rel(value, want_value) <= 1e-5


def test_network_within_bfloat16_of_the_port():
    """The port computes its embeddings, convolutions and trunk in
    bfloat16 (8 bits of mantissa, 2**-9 relative rounding at each of about
    ten roundings on the way to the heads), so its outputs lie within a
    few percent of the float32 reference's largest, and not within
    float32's 1e-5."""
    obs = _obs(64)
    model = _model(torch.bfloat16)
    with torch.no_grad():
        logits, value = model(obs)
    want_logits, want_value = ac.forward(_params(model), obs)
    for got, want in ((logits, want_logits), (value, want_value)):
        assert 1e-5 < _rel(got, want) <= 3e-2


def _minibatch(model, n: int = 96, seed: int = 2):
    g = torch.Generator().manual_seed(seed)
    obs = _obs(n, seed)
    with torch.no_grad():
        logits, value = model(obs)
    action = torch.randint(0, 7, (n,), generator=g)
    logp = torch.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
    # Old log-probabilities far enough off that some ratios are clipped.
    old_logp = logp + 0.4 * torch.randn(n, generator=g)
    old_value = value + 0.3 * torch.randn(n, generator=g)
    adv = torch.randn(n, generator=g)
    ret = old_value + torch.randn(n, generator=g)
    return obs, action, old_logp, old_value, adv, ret


@pytest.mark.parametrize("block", [None, 32])
def test_loss_and_gradients_equal_ppo_loss(block):
    model = _model()
    mb = _minibatch(model)
    loss, aux = tppo.ppo_loss(model, CFG, mb)
    loss.backward()
    terms, grads = ref_ppo.loss_and_grads(_params(model), SETTINGS, mb, block=block)
    for got, want in zip((loss, *aux), terms):
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-7)
    for name, p in model.named_parameters():
        scale = float(grads[name].abs().max())
        assert scale > 0, name
        assert float((p.grad - grads[name]).abs().max()) <= 1e-5 * scale, name


def test_clipped_adam_step_equals_torch_adam():
    model = _model()
    g = torch.Generator().manual_seed(5)
    grads = {k: 0.3 * torch.randn(p.shape, generator=g) for k, p in model.named_parameters()}
    before = {k: v.clone() for k, v in _params(model).items()}
    opt = torch.optim.Adam(model.parameters(), lr=CFG.lr, eps=1e-5)
    for k, p in model.named_parameters():
        p.grad = grads[k].clone()
    norm = tppo.clip_by_global_norm_(list(model.parameters()), CFG.max_grad_norm)
    assert float(norm) > CFG.max_grad_norm
    opt.step()
    zeros = {k: torch.zeros_like(v) for k, v in before.items()}
    state = ref_ppo.AdamState(zeros, dict(zeros), {k: 0 for k in before})
    clipped = ref_ppo.clip_by_global_norm(grads, SETTINGS.max_grad_norm)
    want, adam = ref_ppo.adam_step(before, clipped, state, SETTINGS)
    for k, p in model.named_parameters():
        assert float((p.detach() - want[k]).abs().max()) <= 1e-3 * CFG.lr, k
        assert torch.allclose(opt.state[p]["exp_avg"], adam.exp_avg[k], rtol=1e-5, atol=1e-9), k


MAX_STEPS = 10  # a short fixed limit, so that every env resets within the rollout


def _ppo(seed: int = 3):
    env = port.make(ENV)
    env.params = env.params.replace(max_steps=MAX_STEPS).with_extra(fixed_max_steps=True)
    ppo = PPO(env, PPOConfig(num_envs=16, rollout_len=24, epochs=1, num_minibatches=2), device="cpu")
    return env, ppo, ppo.init(seed)


def test_level_replays_the_eager_collector():
    env, ppo, ts = _ppo()
    ts, _ = ppo._update_eager(ts)  # a second update starts mid-episode
    layouts = pool_rounds(env, ts.pool)
    start, resets0 = ref_state(ts.env_state), ts.reset_count.long()
    assert all(int(ref.invalid_layouts(lay).sum()) == 0 for lay in layouts)
    episode = round_of(layouts, resets0 % len(layouts))
    assert int(ref.inconsistent_states(start, episode, MAX_STEPS).sum()) == 0
    end, _ = ppo._update_eager(ts)
    traj = ppo._traj
    rep = ref.replay(start, traj.actions, MAX_STEPS,
                     lambda n: round_of(layouts, (resets0 + n) % len(layouts)), torch.float32)
    for k in ("image", "direction", "mission"):
        assert torch.equal(traj.obs[k].long(), rep["obs"][k].long()), k
    assert torch.equal(traj.rewards, rep["rewards"])
    assert torch.equal(traj.dones, rep["dones"]) and bool(rep["dones"].any())
    assert torch.equal(end.reset_count.long() - resets0, rep["resets"])
    final = ref_state(end.env_state)
    for k in ref.FIELDS:
        assert torch.equal(final[k].long(), rep["state"][k].long()), k


def test_a_layout_without_a_door_is_invalid():
    env, _, ts = _ppo()
    lay = pool_rounds(env, ts.pool)[0]
    flat = (lay["obj"] == ref.dk.DOOR).flatten(1).int().argmax(1)
    broken = {k: v.clone() for k, v in lay.items()}
    b, h, w = lay["obj"].shape
    rows = torch.arange(b)
    for plane, value in (("obj", ref.dk.WALL), ("color", ref.dk.GREY), ("state", 0)):
        broken[plane].view(b, -1)[rows, flat] = value
    assert int(ref.invalid_layouts(lay).sum()) == 0
    assert bool(ref.invalid_layouts(broken).all())


def test_eager_update_spans_its_phases(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _, ppo, ts = _ppo()
    with profiling.tracing():
        ppo._update_eager(ts)
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    (update,) = [r for r in recs if r["name"] == "ppo.update"]
    phases = {r["name"] for r in recs if r["parent"] == update["id"]}
    assert phases == {"ppo.collector", "ppo.bootstrap", "ppo.learner"}
    steps = [r for r in recs if r["name"] == "ppo.collect.step"]
    minibatches = [r for r in recs if r["name"] == "ppo.minibatch"]
    assert len(steps) == 24 and len(minibatches) == 2
    assert all(by_id[by_id[r["parent"]]["parent"]]["name"] == "ppo.collector" for r in steps)
    assert {by_id[r["parent"]]["name"] for r in minibatches} == {"ppo.learner.replay"}
