"""The port's data-parallel PPO learner: two gloo processes on the CPU.

* ``_learn`` on a fixed trajectory made from a seed with numpy (Empty-5x5,
  8 envs, T=8, two epochs of four minibatches of two envs, the model at
  ``compute_dtype=torch.float32``): two ranks, each given its slice of the
  trajectory, end with the one-process learner's parameters within 1e-5
  (float32 sums of the two ranks' shares taken in another order), and
  with its metrics within 1e-5 relative.  The minibatches are global, so
  some rank holds none of some minibatch's envs and still joins every
  collective; the test checks that this case occurs.
* One sharded ``update`` on BabyAI-GoToDoor (``dryrun_multichip``'s leg 3:
  two envs a rank, T=8) gives finite metrics, equal on both ranks, and
  the same parameters on both ranks (JAX's ``tests/test_ppo.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
from minigrid_dynamicprogramming_tpu_torch.models.nets import ActorCritic, init_params

from ._torch_dist import join, run_workers

torch.set_num_threads(1)

ENV_ID = "MiniGrid-Empty-5x5-v0"
B, T, EPOCHS, MINIBATCHES, SEED = 8, 8, 2, 4, 3
PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-5


def trajectory(seed: int = 0):
    """A ``(T, B)`` trajectory of valid observations and random outcomes,
    and the last values, made with numpy."""
    rng = np.random.default_rng(seed)
    image = np.stack([rng.integers(0, 11, (T, B, 7, 7)), rng.integers(0, 6, (T, B, 7, 7)),
                      rng.integers(0, 3, (T, B, 7, 7))], axis=-1).astype(np.uint8)
    obs = {
        "image": image,
        "direction": rng.integers(0, 4, (T, B)).astype(np.int32),
        "mission": rng.integers(0, 5, (T, B, 48)).astype(np.int32),
    }
    arrays = {
        "actions": rng.integers(0, 7, (T, B)).astype(np.int64),
        "logps": np.log(rng.uniform(0.05, 0.5, (T, B))).astype(np.float32),
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "rewards": (rng.random((T, B)) * (rng.random((T, B)) < 0.3)).astype(np.float32),
        "dones": rng.random((T, B)) < 0.2,
    }
    return obs, arrays, rng.normal(size=B).astype(np.float32)


def as_trajectory(obs, arrays, lanes=slice(None)) -> tppo.Trajectory:
    t = {k: torch.from_numpy(v[:, lanes].copy()) for k, v in arrays.items()}
    return tppo.Trajectory(obs={k: torch.from_numpy(v[:, lanes].copy()) for k, v in obs.items()}, **t)


def f32_state(ppo: tppo.PPO, ts: tppo.TrainState) -> tppo.TrainState:
    """``ts`` with the model at float32 compute, the same parameters."""
    model = init_params(ActorCritic(num_actions=ppo.env.action_dim, compute_dtype=torch.float32),
                        torch.Generator().manual_seed(SEED))
    optimizer = torch.optim.Adam(model.parameters(), lr=ppo.config.lr, eps=1e-5)
    return ts._replace(model=model, optimizer=optimizer)


CFG = tppo.PPOConfig(num_envs=B, rollout_len=T, epochs=EPOCHS, num_minibatches=MINIBATCHES)

_WORKER = join(2) + f"""
import numpy as np
import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
from tests.test_torch_ppo_distributed import CFG, SEED, as_trajectory, f32_state, trajectory

group = distributed.global_env_group("cpu")
ppo = tppo.PPO(port.make("{ENV_ID}"), CFG, device="cpu", group=group)
ts = f32_state(ppo, ppo.init(SEED))
obs, arrays, last = trajectory()
lanes = group.slice(CFG.num_envs)
m = ppo._learn(ts, as_trajectory(obs, arrays, lanes), torch.from_numpy(last[lanes]))
learned = {{"param_" + n: p.detach().numpy() for n, p in ts.model.named_parameters()}}

cfg = tppo.PPOConfig(num_envs=4, rollout_len=8, autoreset="pool")
door = tppo.PPO(port.make("BabyAI-GoToDoor-v0"), cfg, device="cpu", group=group)
dts, dm = door.update(door.init(1))
np.savez(
    out, metrics=np.array([float(x) for x in m]), update_metrics=np.array([float(x) for x in dm]),
    update_params=np.concatenate([p.detach().reshape(-1).float().numpy() for p in dts.model.parameters()]),
    **learned,
)
print("worker", rank, "ok")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppo_ranks")
    outs = [d / f"rank{r}.npz" for r in range(2)]
    run_workers(_WORKER, 2, outs)
    return [np.load(o) for o in outs]


def test_two_rank_learn_equals_one_process(ranks):
    ppo = tppo.PPO(port.make(ENV_ID), CFG, device="cpu")
    ts = f32_state(ppo, ppo.init(SEED))
    obs, arrays, last = trajectory()
    m = ppo._learn(ts, as_trajectory(obs, arrays), torch.from_numpy(last))
    moved = 0.0
    start = dict(f32_state(ppo, ppo.init(SEED)).model.named_parameters())
    for name, p in ts.model.named_parameters():
        want = p.detach().numpy()
        moved = max(moved, float(np.abs(want - start[name].detach().numpy()).max()))
        for r, d in enumerate(ranks):
            err = np.abs(d["param_" + name] - want).max()
            assert err <= PARAM_ATOL, (r, name, err)
    assert moved > 10 * PARAM_ATOL, "the learner moved the parameters"
    want = np.array([float(x) for x in m])
    for d in ranks:
        np.testing.assert_allclose(d["metrics"], want, rtol=METRIC_RTOL, atol=1e-7)
    # Some rank held none of some minibatch's envs: the global permutations.
    g = torch.Generator().manual_seed(SEED)
    mb = B // MINIBATCHES
    owned = [
        ((perm[i * mb:(i + 1) * mb] < B // 2).sum().item())
        for perm in (torch.randperm(B, generator=g) for _ in range(EPOCHS))
        for i in range(MINIBATCHES)
    ]
    assert 0 in owned or mb in owned, owned


def test_sharded_update_metrics_agree(ranks):
    a, b = ranks
    assert np.isfinite(a["update_metrics"]).all(), a["update_metrics"]
    np.testing.assert_array_equal(a["update_metrics"], b["update_metrics"])
    np.testing.assert_array_equal(a["update_params"], b["update_params"])
