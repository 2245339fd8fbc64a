"""PPO's collector and minibatch steps as the card captures them, checked
on the CPU.

On a CUDA device ``models/ppo.py:PPO.update`` captures the collector's
step (``_collect_step``) and the learner's minibatch step
(``_learn_step``) each once as a CUDA graph and replays them; on the CPU
the same steps run in Python loops.  Here there is no card, so:

* each step runs under ``_torch_graph.py``'s ``NoHostReads`` (Adam's own
  step excepted: on the card it is PyTorch's capturable Adam, on the CPU
  it reads its step count), on Empty-5x5, GoToDoor and
  Dynamic-Obstacles-8x8 (its hooks draw), the collector in every
  autoreset mode ("regen" generates inside the step); the collector's
  step writes nothing but its carry;
* the action draw equals ``torch.multinomial``'s from the same generator
  state;
* the update's graph path runs with a stand-in for
  ``lanes.capture_step`` that warms up as the real one does and whose
  "replay" calls the step: it equals ``_update_eager`` bit for bit over
  three updates (trajectory, state, reset counts, metrics, parameters,
  Adam's state, both generators), which holds the learner's warm-up to
  leaving the model and the optimizer where it found them; it captures
  each loop once, again after a new ``init`` or a restored optimizer
  state, and no learner at zero epochs; in "regen" too, where the
  collector's graph reads no pool;
* a TrainState and metrics that the caller keeps do not change when the
  next update runs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes
from minigrid_dynamicprogramming_tpu_torch.utils import checkpoint as ckpt

from ._torch_graph import NoHostReads

torch.set_num_threads(1)

IDS = ["MiniGrid-Empty-5x5-v0", "BabyAI-GoToDoor-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"]
B, T = 4, 3


def _ppo(env_id: str, autoreset: str = "pool", epochs: int = 2, seed: int = 0):
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=2)  # lanes reset inside the rollout
    cfg = PPOConfig(num_envs=B, rollout_len=T, epochs=epochs, num_minibatches=2,
                    autoreset=autoreset, pool_rounds=2)
    ppo = PPO(env, cfg, device="cpu")
    return ppo, ppo.init(seed)


class _Replays:
    """A stand-in for a captured graph: each replay calls the step."""

    def __init__(self, step):
        self.replay = step

    def reset(self) -> None:
        pass


def _capture_on_cpu(step, warmup, device, generator=None, stamps=None):
    """``lanes.capture_step`` without the card: the warm-up, the generator
    put back, then a graph whose replay calls ``step`` (tracing is off, so
    ``stamps`` is None)."""
    saved = None if generator is None else generator.get_state()
    warmup()
    if generator is not None:
        generator.set_state(saved)
    return _Replays(step), 0.0, 0


@pytest.fixture
def graph_path(monkeypatch):
    """Makes a PPO take its graph path on the CPU."""
    monkeypatch.setattr(tlanes, "capture_step", _capture_on_cpu)

    def on(ppo: PPO) -> PPO:
        ppo._capture = True
        return ppo

    return on


def _params(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("autoreset", ["pool", "cached", "regen"])
@pytest.mark.parametrize("env_id", IDS)
def test_collector_step_reads_nothing_to_the_host(env_id, autoreset):
    ppo, ts = _ppo(env_id, autoreset)
    c = ppo._rollout_carry(ts)
    ppo._load(c, ts)
    assert (ts.pool is None) == (autoreset == "regen")
    pool = {} if ts.pool is None else to_numpy(ts.pool)
    state, params = to_numpy(ts.env_state), _params(ts.model)
    with NoHostReads():
        for _ in range(T):
            ppo._collect_step(c, ts.model, ts.pool, ts.generator)
    assert int(c.t) == T
    for name, value in pool.items():
        np.testing.assert_array_equal(to_numpy(ts.pool)[name], value, err_msg=name)
    for name, value in to_numpy(ts.env_state).items():
        np.testing.assert_array_equal(value, state[name], err_msg=name)
    assert all(torch.equal(p, q) for p, q in zip(ts.model.parameters(), params))
    assert int(ts.reset_count.abs().sum()) == 0


@pytest.mark.parametrize("env_id", IDS)
def test_learner_step_reads_nothing_to_the_host(env_id):
    ppo, ts = _ppo(env_id)
    _, last_obs, _, traj = ppo._collect(ts)
    with torch.no_grad():
        _, last_value = ts.model(last_obs)
    mb = ppo._minibatch_carry(ts, traj, last_value)
    before = _params(ts.model)
    mode = NoHostReads()
    adam_step = ts.optimizer.step

    def unchecked_step():
        with mode.unchecked():
            adam_step()

    ts.optimizer.step = unchecked_step
    with mode:
        for _ in range(ppo.config.epochs * ppo.config.num_minibatches):
            ppo._learn_step(mb, ts.model, ts.optimizer)
    assert int(mb.k) == 4 and bool(torch.isfinite(mb.terms).all())
    assert any(not torch.equal(p, q) for p, q in zip(ts.model.parameters(), before))


@pytest.mark.parametrize("seed", range(5))
def test_sample_actions_equals_multinomial(seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(256, 7, generator=g) * torch.tensor([0.1, 1.0, 5.0, 20.0]).repeat(64)[:, None]
    a, b = torch.Generator().manual_seed(100 + seed), torch.Generator().manual_seed(100 + seed)
    got = tppo.sample_actions(logits, a)
    want = torch.multinomial(logits.softmax(-1), 1, generator=b)[:, 0]
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    assert torch.equal(torch.randint(0, 1 << 30, (8,), generator=a),
                       torch.randint(0, 1 << 30, (8,), generator=b))


def _assert_state_equal(a, b, what: str) -> None:
    for name, value in to_numpy(a).items():
        np.testing.assert_array_equal(value, to_numpy(b)[name], err_msg=f"{what}: {name}")


def _assert_updates_equal(ppo_a, ta, ma, ppo_b, tb, mb) -> None:
    for x, y in zip(tppo._traj_tensors(ppo_a._traj), tppo._traj_tensors(ppo_b._traj)):
        assert torch.equal(x, y)
    _assert_state_equal(ta.env_state, tb.env_state, "state")
    for k in ta.obs:
        assert torch.equal(ta.obs[k], tb.obs[k]), k
    assert torch.equal(ta.reset_count, tb.reset_count)
    for name, x, y in zip(tppo.UpdateMetrics._fields, ma, mb):
        assert torch.equal(x, y) or (x.isnan().all() and y.isnan().all()), name
    for p, q in zip(ta.model.parameters(), tb.model.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(ta.model.parameters(), tb.model.parameters()):
        for (n, x), y in zip(ta.optimizer.state[p].items(), tb.optimizer.state[q].values()):
            assert torch.equal(x, y), n
    for g, h in ((ta.generator, tb.generator), (ta.learner_generator, tb.learner_generator)):
        assert torch.equal(g.get_state(), h.get_state())


@pytest.mark.parametrize("env_id", IDS)
def test_graph_path_equals_eager(graph_path, env_id):
    ppo_g, ts_g = _ppo(env_id, seed=3)
    ppo_e, ts_e = _ppo(env_id, seed=3)
    graph_path(ppo_g)
    for _ in range(3):
        ts_g, m_g = ppo_g.update(ts_g)
        ts_e, m_e = ppo_e._update_eager(ts_e)
        _assert_updates_equal(ppo_g, ts_g, m_g, ppo_e, ts_e, m_e)
    assert ppo_g.captures == {"collector": 1, "learner": 1}
    assert ppo_e.captures == {"collector": 0, "learner": 0}


@pytest.mark.parametrize("env_id", IDS)
def test_regen_graph_path_equals_eager(graph_path, env_id):
    ppo_g, ts_g = _ppo(env_id, "regen", seed=3)
    ppo_e, ts_e = _ppo(env_id, "regen", seed=3)
    graph_path(ppo_g)
    for _ in range(3):
        ts_g, m_g = ppo_g.update(ts_g)
        ts_e, m_e = ppo_e._update_eager(ts_e)
        _assert_updates_equal(ppo_g, ts_g, m_g, ppo_e, ts_e, m_e)
    assert ppo_g.captures == {"collector": 1, "learner": 1}
    assert ppo_e.captures == {"collector": 0, "learner": 0}


def test_captures_again_only_for_other_objects(graph_path, tmp_path):
    ppo = graph_path(_ppo(IDS[0])[0])
    ts = ppo.init(0)
    for _ in range(3):
        ts, _ = ppo.update(ts)
    assert ppo.captures == {"collector": 1, "learner": 1}
    # Adam's state loaded anew: new tensors, which only the learner reads.
    ckpt.save(str(tmp_path / "opt"), ts.optimizer)
    ckpt.restore(str(tmp_path / "opt"), ts.optimizer)
    ts, _ = ppo.update(ts)
    assert ppo.captures == {"collector": 1, "learner": 2}
    other, _ = ppo.update(ppo.init(1))
    assert ppo.captures == {"collector": 2, "learner": 3}
    ppo.update(other)
    assert ppo.captures == {"collector": 2, "learner": 3}
    ppo.update(ts)
    assert ppo.captures == {"collector": 3, "learner": 4}


def test_zero_epoch_update_captures_no_learner(graph_path):
    ppo, ts = _ppo(IDS[0], epochs=0)
    graph_path(ppo)
    for _ in range(2):
        ts, m = ppo.update(ts)
    assert ppo.captures == {"collector": 1, "learner": 0}
    assert all(bool(x.isnan()) for x in m[:5])
    assert np.isfinite(float(m.mean_reward)) and ts.update_idx == 2


@pytest.mark.parametrize("path", ["graph", "eager"])
def test_kept_state_and_metrics_do_not_change(graph_path, path):
    ppo, ts = _ppo(IDS[2], seed=1)
    if path == "graph":
        graph_path(ppo)
    ts, m = ppo.update(ts)
    kept = (to_numpy(ts.env_state), {k: v.clone() for k, v in ts.obs.items()},
            ts.reset_count.clone(), [x.clone() for x in m])
    collected = ppo._collect(ts)
    traj = [x.clone() for x in tppo._traj_tensors(collected[3])]
    ppo.update(ts)
    state, obs, resets, metrics = kept
    for name, value in to_numpy(ts.env_state).items():
        np.testing.assert_array_equal(value, state[name], err_msg=name)
    for k in obs:
        assert torch.equal(ts.obs[k], obs[k]), k
    assert torch.equal(ts.reset_count, resets)
    for x, y in zip(m, metrics):
        assert torch.equal(x, y)
    for x, y in zip(tppo._traj_tensors(collected[3]), traj):
        assert torch.equal(x, y)
