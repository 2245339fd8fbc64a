"""The port's ``ActorCritic`` against the flax one, given the flax
parameters carried across by ``bridge.actor_critic_from_flax``.

Both compute in float32 (``compute_dtype``): bf16 on the CPU is neither
fast nor rounded as XLA rounds it.  Logits and values must agree within
1e-4.  The inputs are real observations from the JAX package (DoorKey-8x8
at view 7, BabyAI GoToLocal with its mission codes, DoorKey-8x8 at view
11, where the flattened conv output is 2x2 and a wrong flatten order
would show).  The port's own initializer is held to flax's laws.

The encoder's lookups run on the CPU as ``nets.lookups``, ``nn.Embedding``'s
composition under autograd: the twin that ``csrc/embed.cu`` is held to on
the card.  Its forward equals each table's rows picked by the clamped ids
bit for bit (the bag within the bound of two float32 orders), and its
gradients equal float64 sums of the same terms within twice float32's
reordering bound (``tests/_torch_embed.py``), and bit for bit on dyadic
inputs, whose sums are exact in any order; at views 5, 7 and 9, with ids
outside every vocabulary and a batch of 300 rows (not a multiple of the
kernels' 128-row blocks).  A bag summed in bf16 falls outside the bag's
bound.
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
from minigrid_dynamicprogramming_tpu_torch.models import ActorCritic, init_params, nets

from ._torch_embed import assert_grads_close, composition_grads, inputs, reorder_bound

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


EMBED_B = 300  # rows: two of the kernels' 128-row blocks and a part


def _twin(ids, tables, grads, dtype):
    """``nets.lookups``' outputs and the tables' gradients by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tables]
    out = nets.lookups(*ids, dtype, leaves)
    return out, torch.autograd.grad(out, leaves, grads)


def _picked(ids, dtype, tables):
    """The planes and the direction features as each table's rows at the
    clamped ids, rounded to ``dtype``; the bag's products rounded to
    ``dtype``, (B, 48, 32)."""
    image, direction, mission = (x.long() for x in ids)
    *planes, w_dir, w_code, pos = tables
    x = torch.cat([w[image[..., c].clamp(0, w.shape[0] - 1)] for c, w in enumerate(planes)], -1)
    tok = w_code[mission.clamp(0, w_code.shape[0] - 1)].to(dtype)
    return x.to(dtype), w_dir[direction].to(dtype), tok * pos.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("view", [5, 7, 9])
def test_embed_twin_forward_is_the_composition(view, dtype):
    """The twin's outputs in the compute dtype: the planes and the
    direction features each table's rows at the clamped ids, bit for bit;
    the bag the 48 rounded products summed in float32, within the bound of
    two orders."""
    from ._torch_embed import bag_bound

    ids, tables, grads = inputs(EMBED_B, view, dtype, seed=view)
    assert int(ids[0].max()) >= 16 and int(ids[2].min()) < 0 and int(ids[2].max()) >= 64
    (x, d, m), _ = _twin(ids, tables, grads, dtype)
    want_x, want_d, products = _picked(ids, dtype, tables)
    assert x.dtype == d.dtype == m.dtype == dtype
    assert torch.equal(x, want_x) and torch.equal(d, want_d)
    assert x.shape == (EMBED_B, view, view, 24) and d.shape == (EMBED_B, 16) and m.shape == (EMBED_B, 32)
    in_order = products.float().flip(1).sum(1).to(dtype)
    assert bool(((m.float() - in_order.float()).abs() <= bag_bound(ids, tables, dtype, m, in_order)).all())
    clamped = nets.lookups(ids[0].clamp(max=3), ids[1], ids[2].clamp(0, 63), dtype, tables)
    assert torch.equal(clamped[2], m) and not torch.equal(clamped[0], x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("view", [5, 7, 9])
def test_embed_twin_grads_within_reordering_bound(view, dtype):
    """The six tables' gradients against the same composition's on float64
    tables, whose sums of the same terms are exact to float32: within the
    reordering bound of each entry."""
    ids, tables, grads = inputs(EMBED_B, view, dtype, seed=10 + view)
    _, got = _twin(ids, tables, grads, dtype)
    want = [w.float() for w in composition_grads(ids, [t.double() for t in tables], grads, dtype)]
    assert_grads_close(got, want, reorder_bound(ids, tables, grads, dtype), dtype, f"view {view}")
    assert all(float(w.abs().max()) > 0 for w in want)
    assert not all(torch.equal(a, w) for a, w in zip(got, want)), "float64 sums differ somewhere"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("view", [5, 9])
def test_embed_twin_grads_exact_on_dyadic_inputs(view, dtype):
    """On dyadic inputs every sum is exact in float32: the twin's gradients
    equal the float64 composition's bit for bit."""
    ids, tables, grads = inputs(EMBED_B, view, dtype, seed=20 + view, dyadic=True)
    _, got = _twin(ids, tables, grads, dtype)
    want = composition_grads(ids, [t.double() for t in tables], grads, dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b.float())


@pytest.mark.parametrize("view", [5, 7, 9])
def test_embed_bag_bound_refuses_a_bf16_sum(view):
    """The bag's bound is tight enough to matter: the 48 rounded products
    summed in bf16 (each partial sum rounded) fall outside it, summed in
    float32 in reverse order they do not."""
    from ._torch_embed import bag_bound

    dtype = torch.bfloat16
    ids, tables, _ = inputs(EMBED_B, view, dtype, seed=30 + view)
    m = nets.lookups(*ids, dtype, tables)[2]
    products = _picked(ids, dtype, tables)[2]
    in_bf16 = torch.zeros_like(m)
    for s in range(products.shape[1]):
        in_bf16 = in_bf16 + products[:, s]
    reverse = products.float().flip(1).sum(1).to(dtype)
    for other, inside in ((in_bf16, False), (reverse, True)):
        within = (m.float() - other.float()).abs() <= bag_bound(ids, tables, dtype, m, other)
        assert bool(within.all()) == inside


def test_encoder_takes_the_twin_on_the_cpu(monkeypatch):
    """On the CPU the encoder's lookups are the twin, once a forward, and
    never the kernels: its gradients reach the same parameters, under the
    same names."""
    model = init_params(ActorCritic(), torch.Generator().manual_seed(0))
    ids, _, _ = inputs(8, 7, torch.bfloat16, seed=3)
    kernels, twin, lookups = [], [], nets.lookups
    monkeypatch.setattr(nets.EmbedKernel, "apply", lambda *a: kernels.append(a))
    monkeypatch.setattr(nets, "lookups", lambda *a: twin.append(a) or lookups(*a))
    logits, value = model(dict(zip(("image", "direction", "mission"), ids)))
    (logits.sum() + value.sum()).backward()
    assert not kernels and len(twin) == 1
    names = {n for n, p in model.named_parameters() if p.grad is not None}
    assert {"encoder.plane_embed_0.weight", "encoder.dir_embed.weight", "encoder.code_embed.weight",
            "encoder.code_pos"} <= names
