"""The port's PPO learner against the JAX package's, and on its own.

* ``_gae`` equals JAX's within 1e-6.
* The clipped PPO loss and its gradients on one fixed minibatch equal
  ``jax.value_and_grad`` of JAX's loss (``models/ppo.py:329-352`` of the
  JAX package, written out below as its update defines it inside a
  closure) through the flax model, at float32, within 1e-4 relative to
  each leaf's largest gradient.
* One clipped Adam step, then a second one, equal optax's
  ``chain(clip_by_global_norm, adam(eps=1e-5))`` within 1e-3 x lr on every
  element, given the same gradients.
* The collector's model inputs equal ``env.observation``, and JAX's, on
  the same states.
* The collector's env steps equal the lane rollout's plain step, given
  the actions the policy drew and a generator seeded alike, bit for bit:
  per-step reward sums and done counts, the final lanes and the reset
  counts ("pool" and "cached", on a family with no hook and on one whose
  hook draws nothing).
* Updates run on Empty-5x5 and GoToRedBallGrey with finite metrics, in
  every auto-reset mode, and PPO learns Empty-5x5 (as the JAX package's
  ``tests/test_ppo.py`` holds its own).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.models.ppo import _gae as jax_gae

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import actor_critic_from_flax, from_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.models import PPO, ActorCritic, PPOConfig, train
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

from .test_torch_nets import flax_params, jax_obs

torch.set_num_threads(1)

CFG = PPOConfig()


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def test_gae_equals_jax():
    rng = np.random.default_rng(0)
    T, B = 33, 64
    rewards = rng.random((T, B)).astype(np.float32) * (rng.random((T, B)) < 0.2)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.1
    last = rng.normal(size=B).astype(np.float32)
    want = jax_gae(*(jnp.asarray(a) for a in (rewards, values, dones, last)), 0.99, 0.95)
    got = tppo._gae(*(torch.from_numpy(a) for a in (rewards, values, dones, last)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def jax_loss_fn(model, cfg, params, mb):
    """JAX's PPO loss, as its update writes it."""
    obs, action, old_logp, old_value, adv, ret = mb
    logits, value = model.apply(params, obs)
    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(logp_all, action[..., None], axis=-1).squeeze(-1)
    ratio = jnp.exp(logp - old_logp)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * adv
    pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -jnp.minimum(pg1, pg2).mean()
    v_clipped = old_value + jnp.clip(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    value_loss = 0.5 * jnp.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    entropy = -(jnp.exp(logp_all) * logp_all).sum(-1).mean()
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    approx_kl = (old_logp - logp).mean()
    return loss, (policy_loss, value_loss, entropy, approx_kl)


def fixed_minibatch(jmodel, params):
    """BabyAI observations, random actions, and old log-probs and values
    near the model's own so that some ratios and values are clipped."""
    obs = {k: v.copy() for k, v in jax_obs("BabyAI-GoToLocal-v0").items()}
    n = obs["direction"].shape[0]
    rng = np.random.default_rng(3)
    logits, value = jmodel.apply(params, {k: jnp.asarray(v) for k, v in obs.items()})
    action = rng.integers(0, 7, n).astype(np.int32)
    logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(n), action]
    old_logp = (logp + rng.normal(0, 0.3, n)).astype(np.float32)
    old_value = (np.asarray(value) + rng.normal(0, 0.3, n)).astype(np.float32)
    adv = rng.normal(size=n).astype(np.float32)
    ret = rng.normal(size=n).astype(np.float32)
    return obs, action, old_logp, old_value, adv, ret


def torch_model(params) -> ActorCritic:
    model = ActorCritic(compute_dtype=torch.float32)
    model.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def test_loss_and_gradients_equal_jax():
    jmodel, params = flax_params(7)
    obs, action, old_logp, old_value, adv, ret = fixed_minibatch(jmodel, params)
    jmb = ({k: jnp.asarray(v) for k, v in obs.items()}, *(jnp.asarray(a) for a in (action, old_logp, old_value, adv, ret)))
    (j_loss, j_aux), j_grads = jax.jit(
        jax.value_and_grad(lambda p, mb: jax_loss_fn(jmodel, CFG, p, mb), has_aux=True)
    )(params, jmb)

    model = torch_model(params)
    tmb = ({k: torch.from_numpy(v) for k, v in obs.items()},
           torch.from_numpy(action).long(), *(torch.from_numpy(a) for a in (old_logp, old_value, adv, ret)))
    loss, aux = tppo.ppo_loss(model, CFG, tmb)
    loss.backward()

    for g, w in zip((loss.detach(), *(a.detach() for a in aux)), (j_loss, *j_aux)):
        assert float(g) == pytest.approx(float(w), rel=1e-4, abs=1e-6)
    ratio = np.exp(np.asarray(jax.nn.log_softmax(jmodel.apply(params, jmb[0])[0]))[np.arange(len(action)), action] - old_logp)
    assert ((ratio < 0.8) | (ratio > 1.2)).any(), "some ratios are clipped"
    want = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err, np.abs(w).max())


def test_clipped_adam_steps_equal_optax():
    """Two steps from the same gradients: the first clipped (norm above
    max_grad_norm), the second not."""
    _, params = flax_params(7)
    rng = np.random.default_rng(4)
    grads = [
        jax.tree_util.tree_map(lambda x: jnp.asarray(rng.normal(0, s, x.shape), jnp.float32), params)
        for s in (0.1, 1e-4)
    ]
    norms = [float(optax.global_norm(g)) for g in grads]
    assert norms[0] > CFG.max_grad_norm > norms[1]
    tx = optax.chain(optax.clip_by_global_norm(CFG.max_grad_norm), optax.adam(CFG.lr, eps=1e-5))
    j_params, opt_state = params, tx.init(params)

    model = torch_model(params)
    opt = torch.optim.Adam(model.parameters(), lr=CFG.lr, eps=1e-5)
    @jax.jit
    def optax_step(g, opt_state, j_params):
        updates, opt_state = tx.update(g, opt_state, j_params)
        return optax.apply_updates(j_params, updates), opt_state

    for g in grads:
        j_params, opt_state = optax_step(g, opt_state, j_params)
        t_grads = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, g))
        for name, p in model.named_parameters():
            p.grad = t_grads[name].clone()
        params_list = list(model.parameters())
        norm = tppo.clip_by_global_norm_(params_list, CFG.max_grad_norm)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-5)
        opt.step()
        want = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, j_params))
        for name, p in model.named_parameters():
            err = np.abs(p.detach().numpy() - want[name].numpy()).max()
            assert err <= 1e-3 * CFG.lr, (name, err)


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-5x5-v0", "BabyAI-GoToDoor-v0"])
def test_collector_obs_equals_env_observation(env_id):
    """The collector's model inputs, taken from the lanes, equal
    ``env.observation`` and JAX's on the same states, the image in the
    ``[x, y]`` wire layout (a transposed image silently degrades
    learning); and one collected step starts from the train state's obs."""
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    st = jax.jit(jax.vmap(jenv.generate, in_axes=(0, None)), static_argnums=1)(keys, jenv.params)
    want = jax.jit(jax.vmap(jenv.observation))(st)
    tst = from_numpy(EnvState, _np(st), "cpu")
    for got in (tenv.observation_lanes(tlanes.to_lanes(tst)), tenv.observation(tst)):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{env_id} {k}")

    ppo = PPO(tenv, PPOConfig(num_envs=8, rollout_len=2, num_minibatches=1), device="cpu")
    ts = ppo.init(0)
    env_state, last_obs, _, traj = ppo._collect(ts)
    for k, v in tenv.observation(ts.env_state).items():
        assert torch.equal(traj.obs[k][0], v) and torch.equal(ts.obs[k], v), k
    for k, v in tenv.observation(env_state).items():
        assert torch.equal(last_obs[k], v), k


@pytest.mark.parametrize("autoreset", ["pool", "cached"])
@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToDoor-v0"])
def test_collector_steps_as_the_rollout(env_id, autoreset):
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=4)  # lanes reset inside the rollout
    if env_id.startswith("BabyAI-"):
        env.params = env.params.with_extra(fixed_max_steps=True)
    B, T, rounds, seed = 16, 10, 3, 5
    ppo = PPO(env, PPOConfig(num_envs=B, rollout_len=T, num_minibatches=1, autoreset=autoreset,
                             pool_rounds=rounds), device="cpu")
    ts = ppo.init(seed)
    c = ppo._rollout_carry(ts)
    ppo._load(c, ts)
    for _ in range(T):
        ppo._collect_step(c, ts.model, ts.pool, ts.generator)
    g = torch.Generator().manual_seed(tppo.rank_seed(seed, 0))
    pool = tlanes.lane_pool(env, g, B, autoreset, rounds, "cpu")
    scan = tlanes._Scan(env, g, pool, B, T, autoreset, rounds, c.traj.actions)
    scan.run_eager()
    r = scan.carry
    assert int(r.dones.sum()) > 0
    assert torch.equal(r.rewards, c.traj.rewards.sum(1))
    assert torch.equal(r.dones, c.traj.dones.sum(1))
    assert torch.equal(r.reset_count, c.reset_count)
    for name in tlanes._FIELDS:
        assert torch.equal(getattr(r.ls, name), getattr(c.ls, name)), name


@pytest.mark.parametrize(
    "env_id, autoreset",
    [("MiniGrid-Empty-5x5-v0", "pool"), ("MiniGrid-Empty-5x5-v0", "cached"),
     ("MiniGrid-Empty-5x5-v0", "regen"), ("BabyAI-GoToRedBallGrey-v0", "pool")],
)
def test_two_updates_give_finite_metrics(env_id, autoreset):
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=6)  # every slot resets
    cfg = PPOConfig(num_envs=16, rollout_len=8, epochs=1, num_minibatches=2, autoreset=autoreset,
                    pool_rounds=3)
    ppo = PPO(env, cfg, device="cpu")
    ts = ppo.init(2)
    first = ts.env_state
    for _ in range(2):
        ts, m = ppo.update(ts)
    assert ts.update_idx == 2
    assert all(np.isfinite(float(x)) for x in m), m
    if env.params.opt("dynamic_max_steps_slot") is None:
        assert int(m.episodes) >= 16 and int(ts.reset_count.min()) >= 2
    if autoreset == "pool":
        assert ts.pool.grid_obj.shape[0] == 3
    if autoreset == "cached":
        # A slot's reset replays its first layout: every slot has just
        # reset (16 steps, limit 6, all reset at steps 6 and 12 ...).
        assert ts.pool.grid_obj.shape[0] == 1
        assert torch.equal(ts.env_state.grid_obj, first.grid_obj)
    if autoreset == "regen":
        assert ts.pool is None


def test_ppo_learns_empty_env():
    """Empty-5x5 at the JAX test's settings: 128 envs, T=16, one epoch, one
    minibatch, lr 1e-3, 25 updates; the mean terminal reward of the last
    update clearly beats that of the third."""
    cfg = PPOConfig(num_envs=128, rollout_len=16, epochs=1, num_minibatches=1, lr=1e-3)
    _, history = train("MiniGrid-Empty-5x5-v0", cfg, num_updates=25, seed=1, log_every=1, device="cpu")
    assert len(history) == 25
    first, last = history[2].mean_return, history[-1].mean_return
    assert last > first + 0.1, (first, last)


def test_ppo_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPO(port.make("MiniGrid-Empty-5x5-v0"))
    with pytest.raises(ValueError, match="autoreset"):
        PPO(port.make("MiniGrid-Empty-5x5-v0"), PPOConfig(autoreset="bogus"), device="cpu")


def test_cli_runs_an_update(capsys):
    tppo.main(["--env-id", "MiniGrid-Empty-5x5-v0", "--num-envs", "8", "--rollout-len", "4",
               "--updates", "1", "--device", "cpu"])
    assert "update 1/1 steps=32" in capsys.readouterr().out
