"""One whole PPO learner phase of the port against the JAX package's, on
the JAX collector's own rollout.

The JAX ``PPO`` (its model switched to float32 compute) collects a rollout
on Empty-5x5 and runs its jitted update; the port's ``PPO._learn`` gets the
same trajectory and the same starting parameters.  With one epoch of one
minibatch the permutation cannot matter, so GAE, the per-minibatch
advantage normalization, the loss, the clip and the Adam step must land on
the same parameters, within 1e-3 x lr on every element, with the same
metrics within 1e-4 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.models.nets import ActorCritic as JActorCritic
from minigrid_dynamicprogramming_tpu.models.ppo import PPO as JPPO
from minigrid_dynamicprogramming_tpu.models.ppo import PPOConfig as JPPOConfig
from minigrid_dynamicprogramming_tpu.parallel.sharding import env_mesh

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import actor_critic_from_flax
from minigrid_dynamicprogramming_tpu_torch.models import PPO, ActorCritic, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo

torch.set_num_threads(1)

ENV_ID = "MiniGrid-Empty-5x5-v0"
B, T = 32, 16


def test_learner_phase_equals_jax():
    jenv = mgtpu.make(ENV_ID)
    jenv.params = jenv.params.replace(max_steps=10)  # episodes end inside the rollout
    jcfg = JPPOConfig(num_envs=B, rollout_len=T, epochs=1, num_minibatches=1)
    jppo = JPPO(jenv, jcfg, mesh=env_mesh(jax.devices()[:1]))
    jppo.model = JActorCritic(num_actions=jenv.action_dim, compute_dtype=jnp.float32)
    ts = jppo.init(jax.random.PRNGKey(0))
    _, _, last_obs, _, traj = jax.jit(jppo._collect_lanes)(ts)
    new_ts, jm = jax.jit(jppo._update_impl)(ts)

    def torch_params(params) -> ActorCritic:
        model = ActorCritic(compute_dtype=torch.float32)
        model.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
        return model

    def t(x):
        return torch.from_numpy(np.array(x))

    cfg = PPOConfig(num_envs=B, rollout_len=T, epochs=1, num_minibatches=1)
    tenv = port.make(ENV_ID)
    ppo = PPO(tenv, cfg, device="cpu")
    model = torch_params(ts.params)
    obs_t, actions, logps, values, rewards, dones = traj
    ttraj = tppo.Trajectory(
        obs={k: t(v) for k, v in obs_t.items()}, actions=t(actions).long(), logps=t(logps),
        values=t(values), rewards=t(rewards), dones=t(dones),
    )
    with torch.no_grad():
        _, last_value = model({k: t(v) for k, v in last_obs.items()})
    tts = tppo.TrainState(
        model=model, optimizer=torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5),
        env_state=None, obs=None, generator=torch.Generator().manual_seed(0), update_idx=0,
        pool=None, reset_count=None, learner_generator=torch.Generator().manual_seed(0),
    )
    m = ppo._learn(tts, ttraj, last_value)

    assert int(jm.episodes) > 0 and int(m.episodes) == int(jm.episodes)
    for name in tppo.UpdateMetrics._fields:
        assert float(getattr(m, name)) == pytest.approx(float(getattr(jm, name)), rel=1e-4, abs=1e-6), name
    want = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, new_ts.params))
    start = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, ts.params))
    for name, p in model.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy()).max()
        assert err <= 1e-3 * cfg.lr, (name, err)
    moved = max(float((want[n] - start[n]).abs().max()) for n in want)
    assert moved > 0.5 * cfg.lr, "the step moved the parameters"
