"""The port's data-parallel PPO learner: two gloo processes on the CPU.

* ``_learn`` on a fixed trajectory made from a seed with numpy (Empty-5x5,
  8 envs, T=8, two epochs of four minibatches of two envs, the model at
  ``compute_dtype=torch.float32``): two ranks, each given its slice of the
  trajectory, end with the one-process learner's parameters within 1e-5
  (float32 sums of the two ranks' shares taken in another order), and
  with its metrics within 1e-5 relative.  The minibatches are global, so
  some minibatch's envs all lie on one rank, and the other rank's share
  reads them from the all-gathered trajectory; the test checks that this
  case occurs.  The same at 12 envs (minibatches of three: a share of two
  rows, one of them padded at weight 0).
* Every rank's share is ``S = ceil(mb / N)`` rows at every step; the
  grouped minibatch step runs under ``_torch_graph.py``'s ``NoHostReads``
  (Adam's own step excepted, as in ``test_torch_ppo_graph.py``); the
  learner's graph path (a stand-in capture that replays the step, as
  there) equals the eager loop at two ranks bit for bit.
* In one process: ``minibatch_shares`` covers every position of a
  minibatch once at weight 1 over 1 to 4 ranks.
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


def trajectory(seed: int = 0, B: int = B):
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
# Minibatches of three envs: a two-rank share of two rows, one padded.
UNEVEN_B = 12
UNEVEN = tppo.PPOConfig(num_envs=UNEVEN_B, rollout_len=T, epochs=EPOCHS, num_minibatches=MINIBATCHES)

_WORKER = join(2) + f"""
import numpy as np
import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes
from tests._torch_graph import NoHostReads
from tests.test_torch_ppo_distributed import (
    CFG, SEED, UNEVEN, as_trajectory, f32_state, trajectory)
from tests.test_torch_ppo_graph import _capture_on_cpu

group = distributed.global_env_group("cpu")

# Each minibatch step's rows a step: the share's size.
rows = []
loss_fn = tppo.ppo_loss

def counted_loss(model, cfg, mb, group=None, weight=None):
    rows.append(len(mb[1]) // cfg.rollout_len)
    return loss_fn(model, cfg, mb, group, weight)

tppo.ppo_loss = counted_loss


def learn(cfg, eager=False, graph=False):
    ppo = tppo.PPO(port.make("{ENV_ID}"), cfg, device="cpu", group=group)
    if graph:
        ppo._capture = ppo._capture_learner = True
    ts = f32_state(ppo, ppo.init(SEED))
    obs, arrays, last = trajectory(B=cfg.num_envs)
    lanes = group.slice(cfg.num_envs)
    m = ppo._learn(ts, as_trajectory(obs, arrays, lanes), torch.from_numpy(last[lanes]), eager)
    return ppo, ts, np.array([float(x) for x in m])


ppo, ts, metrics = learn(CFG)
learned = {{"param_" + n: p.detach().numpy() for n, p in ts.model.named_parameters()}}
even_rows, rows[:] = list(rows), []
_, uts, uneven_metrics = learn(UNEVEN)
learned.update({{"uneven_" + n: p.detach().numpy() for n, p in uts.model.named_parameters()}})
uneven_rows = list(rows)

# One grouped minibatch step after another under NoHostReads, at the
# uneven share (its padded row included).
ppo = tppo.PPO(port.make("{ENV_ID}"), UNEVEN, device="cpu", group=group)
ts = f32_state(ppo, ppo.init(SEED))
obs, arrays, last = trajectory(B=UNEVEN.num_envs)
lanes = group.slice(UNEVEN.num_envs)
mb = ppo._minibatch_carry(ts, as_trajectory(obs, arrays, lanes), torch.from_numpy(last[lanes]))
mode = NoHostReads()
adam_step = ts.optimizer.step

def unchecked_step():
    with mode.unchecked():
        adam_step()

ts.optimizer.step = unchecked_step
with mode:
    for _ in range(UNEVEN.epochs * UNEVEN.num_minibatches):
        ppo._learn_step(mb, ts.model, ts.optimizer)
checked_terms = mb.terms.numpy().copy()

# The learner's graph path (a stand-in capture) against the eager loop.
capture, tlanes.capture_step = tlanes.capture_step, _capture_on_cpu
pg, tg, mg = learn(UNEVEN, graph=True)
pe, te, me = learn(UNEVEN, eager=True)
graph_equal = (
    pg.captures["learner"] == 1 and pe.captures["learner"] == 0
    and np.array_equal(mg, me)
    and all(torch.equal(p, q) for p, q in zip(tg.model.parameters(), te.model.parameters()))
    and all(torch.equal(x, y) for p, q in zip(tg.model.parameters(), te.model.parameters())
            for x, y in zip(tg.optimizer.state[p].values(), te.optimizer.state[q].values()))
)
tlanes.capture_step = capture
tppo.ppo_loss = loss_fn

cfg = tppo.PPOConfig(num_envs=4, rollout_len=8, autoreset="pool")
door = tppo.PPO(port.make("BabyAI-GoToDoor-v0"), cfg, device="cpu", group=group)
dts, dm = door.update(door.init(1))
np.savez(
    out, metrics=metrics, update_metrics=np.array([float(x) for x in dm]),
    update_params=np.concatenate([p.detach().reshape(-1).float().numpy() for p in dts.model.parameters()]),
    uneven_metrics=uneven_metrics, even_rows=np.array(even_rows), uneven_rows=np.array(uneven_rows),
    checked_terms=checked_terms, graph_equal=np.array(graph_equal), **learned,
)
print("worker", rank, "ok")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppo_ranks")
    outs = [d / f"rank{r}.npz" for r in range(2)]
    run_workers(_WORKER, 2, outs)
    return [np.load(o) for o in outs]


def _assert_learn_equals_one_process(ranks, cfg, prefix: str, metrics: str) -> None:
    ppo = tppo.PPO(port.make(ENV_ID), cfg, device="cpu")
    ts = f32_state(ppo, ppo.init(SEED))
    obs, arrays, last = trajectory(B=cfg.num_envs)
    m = ppo._learn(ts, as_trajectory(obs, arrays), torch.from_numpy(last))
    moved = 0.0
    start = dict(f32_state(ppo, ppo.init(SEED)).model.named_parameters())
    for name, p in ts.model.named_parameters():
        want = p.detach().numpy()
        moved = max(moved, float(np.abs(want - start[name].detach().numpy()).max()))
        for r, d in enumerate(ranks):
            err = np.abs(d[prefix + name] - want).max()
            assert err <= PARAM_ATOL, (r, name, err)
    assert moved > 10 * PARAM_ATOL, "the learner moved the parameters"
    want = np.array([float(x) for x in m])
    for d in ranks:
        np.testing.assert_allclose(d[metrics], want, rtol=METRIC_RTOL, atol=1e-7)


def test_two_rank_learn_equals_one_process(ranks):
    _assert_learn_equals_one_process(ranks, CFG, "param_", "metrics")
    # Some minibatch's envs all lie on one rank: the global permutations.
    g = torch.Generator().manual_seed(SEED)
    mb = B // MINIBATCHES
    owned = [
        ((perm[i * mb:(i + 1) * mb] < B // 2).sum().item())
        for perm in (torch.randperm(B, generator=g) for _ in range(EPOCHS))
        for i in range(MINIBATCHES)
    ]
    assert 0 in owned or mb in owned, owned


def test_two_rank_uneven_learn_equals_one_process(ranks):
    _assert_learn_equals_one_process(ranks, UNEVEN, "uneven_", "uneven_metrics")


def test_two_rank_shares_have_fixed_size(ranks):
    steps = EPOCHS * MINIBATCHES
    for d in ranks:
        assert d["even_rows"].tolist() == [1] * steps  # mb 2: one row a rank
        assert d["uneven_rows"].tolist() == [2] * steps  # mb 3: two, one padded


def test_two_rank_learner_step_reads_nothing_to_the_host(ranks):
    for d in ranks:
        assert d["checked_terms"].shape == (EPOCHS * MINIBATCHES, 5)
        assert np.isfinite(d["checked_terms"]).all()
    # Each rank's terms are its shares of the global minibatch's.
    assert not np.array_equal(ranks[0]["checked_terms"], ranks[1]["checked_terms"])


def test_two_rank_graph_path_equals_eager(ranks):
    assert all(bool(d["graph_equal"]) for d in ranks)


@pytest.mark.parametrize("minibatch", [12, 7, 1])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_minibatch_shares_cover_each_position_once(world, minibatch):
    positions, weights = tppo.minibatch_shares(minibatch, world)
    size = -(-minibatch // world)
    assert positions.shape == weights.shape == (world, size)
    assert positions.dtype == torch.int64 and weights.dtype == torch.float32
    assert set(weights.unique().tolist()) <= {0.0, 1.0}
    real = positions[weights == 1.0]
    assert sorted(real.tolist()) == list(range(minibatch))
    assert (positions[weights == 0.0] == 0).all()  # a valid row
    for r in range(world):  # rank r's block: contiguous, then padding
        n = int(weights[r].sum())
        assert positions[r, :n].tolist() == list(range(r * size, r * size + n))
        assert (weights[r, :n] == 1.0).all()
    if world == 1:
        assert torch.equal(positions[0], torch.arange(minibatch)) and bool((weights == 1).all())


def test_sharded_update_metrics_agree(ranks):
    a, b = ranks
    assert np.isfinite(a["update_metrics"]).all(), a["update_metrics"]
    np.testing.assert_array_equal(a["update_metrics"], b["update_metrics"])
    np.testing.assert_array_equal(a["update_params"], b["update_params"])
