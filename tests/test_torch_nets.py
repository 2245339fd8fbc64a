"""The port's ``ActorCritic`` against the flax one, given the flax
parameters carried across by ``bridge.actor_critic_from_flax``.

Both compute in float32 (``compute_dtype``): bf16 on the CPU is neither
fast nor rounded as XLA rounds it.  Logits and values must agree within
1e-4.  The inputs are real observations from the JAX package (DoorKey-8x8
at view 7, BabyAI GoToLocal with its mission codes, DoorKey-8x8 at view
11, where the flattened conv output is 2x2 and a wrong flatten order
would show).  The port's own initializer is held to flax's laws.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.models.nets import ActorCritic as JActorCritic

from minigrid_dynamicprogramming_tpu_torch.bridge import actor_critic_from_flax
from minigrid_dynamicprogramming_tpu_torch.models import ActorCritic, init_params

torch.set_num_threads(1)

BATCH = 32
ATOL = 1e-4


def jax_obs(env_id: str, view: int = 7) -> dict:
    env = mgtpu.make(env_id)
    env.params = env.params.replace(agent_view_size=view)
    keys = jax.random.split(jax.random.PRNGKey(2), BATCH)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)(keys, env.params)
    return {k: np.array(v) for k, v in jax.jit(jax.vmap(env.observation))(states).items()}


def flax_params(view: int, seed: int = 1):
    dummy = {
        "image": jnp.zeros((view, view, 3), jnp.uint8),
        "direction": jnp.zeros((), jnp.int32),
        "mission": jnp.zeros((48,), jnp.int32),
    }
    model = JActorCritic(num_actions=7, compute_dtype=jnp.float32)
    return model, model.init(jax.random.PRNGKey(seed), dummy)


@pytest.mark.parametrize(
    "env_id, view",
    [("MiniGrid-DoorKey-8x8-v0", 7), ("BabyAI-GoToLocal-v0", 7), ("MiniGrid-DoorKey-8x8-v0", 11)],
)
def test_forward_equals_flax(env_id, view):
    obs = jax_obs(env_id, view)
    assert obs["image"].shape == (BATCH, view, view, 3)
    if env_id.startswith("BabyAI"):
        assert (obs["mission"] > 0).sum(axis=1).min() >= 3, "missions carry codes"
    jmodel, params = flax_params(view)
    j_logits, j_value = jmodel.apply(params, {k: jnp.asarray(v) for k, v in obs.items()})

    model = ActorCritic(num_actions=7, view=view, compute_dtype=torch.float32)
    model.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        logits, value = model({k: torch.from_numpy(v) for k, v in obs.items()})
    assert logits.dtype == value.dtype == torch.float32 and value.shape == (BATCH,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=0, atol=ATOL)
    assert np.ptp(np.asarray(j_logits), axis=0).max() > 10 * ATOL, "inputs move the logits"


def test_bf16_forward_is_close_to_f32():
    """The default compute dtype, bf16 as in JAX: the heads stay float32,
    and the outputs stay near the float32 model's."""
    obs = {k: torch.from_numpy(v) for k, v in jax_obs("MiniGrid-DoorKey-8x8-v0").items()}
    f32 = init_params(ActorCritic(compute_dtype=torch.float32), torch.Generator().manual_seed(0))
    bf16 = ActorCritic()
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        (l32, v32), (l16, v16) = f32(obs), bf16(obs)
    assert l16.dtype == v16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert float((l16 - l32).abs().max()) < 0.05 and float((v16 - v32).abs().max()) < 0.05


def _law_std(name: str, w: torch.Tensor) -> float:
    """The standard deviation of flax's law for one leaf."""
    if name.endswith("code_pos"):
        return 0.02
    if "embed" in name:
        return 1 / w.shape[1] ** 0.5  # variance_scaling(1, fan_in, normal)
    return 1 / w[0].numel() ** 0.5  # LeCun normal, fan_in = all but the output axis


def test_init_follows_flax_laws():
    """The port's initializer draws flax's laws: zero biases, LeCun-normal
    kernels cut at two standard deviations, embeddings with standard
    deviation 1/sqrt(features), ``code_pos`` 0.02.  Each leaf divided by
    its law's standard deviation is pooled per law (some leaves hold 32
    numbers); the pools of the port and of flax must each have mean within
    0.05 and standard deviation within 5% of 1, and kernels stay inside
    the cut."""
    _, params = flax_params(7, seed=0)
    flax_sd = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params))
    got = init_params(ActorCritic(), torch.Generator().manual_seed(0)).state_dict()
    assert set(got) == set(flax_sd)
    for sd in (got, flax_sd):
        pools = {"kernel": [], "embed": [], "code_pos": []}
        for name, w in sd.items():
            assert w.dtype == torch.float32 and w.shape == got[name].shape, name
            if name.endswith("bias"):
                assert not w.any(), name
                continue
            z = (w / _law_std(name, w)).flatten()
            law = "code_pos" if name.endswith("code_pos") else "embed" if "embed" in name else "kernel"
            if law == "kernel":
                assert float(z.abs().max()) <= 2 / 0.87962566103423978 + 1e-5, name
            pools[law].append(z)
        for law, zs in pools.items():
            z = torch.cat(zs)
            assert abs(float(z.mean())) < 0.05 and float(z.std()) == pytest.approx(1, rel=0.05), law
    again = init_params(ActorCritic(), torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(again[k], got[k]) for k in got), "a seeded init is reproducible"
