"""The port's host tools against the JAX package's: the ASCII printer and
the state digest (the same strings on the same states), checkpoints, the
scripted manual control, and the CLI's ``--dp`` (its plain V equal to
JAX's ``value_iteration`` bit for bit on the same layouts; its kernel
branch raises on the CPU).  Mirrors JAX's ``tests/test_tools.py``."""

from __future__ import annotations

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp import tabular as jtab
from minigrid_dynamicprogramming_tpu.utils import debug as jdebug

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch import benchmark
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import ACT_FORWARD
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
from minigrid_dynamicprogramming_tpu_torch.utils import checkpoint as ckpt
from minigrid_dynamicprogramming_tpu_torch.utils.debug import encode_grid, pprint_state, state_hash

torch.set_num_threads(1)

B = 6


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def _jax_states(env_id: str, seed: int, steps: int):
    """A JAX batch after ``steps`` scripted random steps (doors opened,
    objects carried, poses varied), and the same states in the port."""
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    step = jax.jit(jax.vmap(env.step))
    acts = np.random.default_rng(seed).choice(7, (steps, B), p=[0.2, 0.2, 0.3, 0.1, 0.05, 0.15, 0.0])
    for t in range(steps):
        _, states, *_ = step(jax.random.split(jax.random.PRNGKey(100 + t), B), states, jnp.asarray(acts[t]))
    return states, from_numpy(EnvState, _np(states), "cpu")


@pytest.mark.parametrize("steps", [0, 12])
@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-LavaGapS7-v0", "MiniGrid-Empty-8x8-v0"])
def test_pprint_and_hash_equal_jax(env_id, steps):
    jstates, tstates = _jax_states(env_id, 3, steps)
    for i in range(B):
        one = jax.tree_util.tree_map(lambda x: x[i], jstates)
        assert pprint_state(tstates, i) == jdebug.pprint_state(one), (env_id, i)
        np.testing.assert_array_equal(encode_grid(tstates, i), jdebug.encode_grid(one))
        assert state_hash(tstates, i) == jdebug.state_hash(one), (env_id, i)


def test_state_hash_sensitivity():
    env = port.make("MiniGrid-Empty-5x5-v0")
    _, state = env.reset(torch.Generator().manual_seed(0), 1, "cpu")
    h0 = state_hash(state)
    _, moved, *_ = env.step(state, ACT_FORWARD)
    assert state_hash(moved) != h0
    assert state_hash(state) == h0  # a pure function, the state untouched


def test_manual_control_scripted():
    """ManualControl driven with key names (the reference's
    ``tests/test_scripts.py`` drives pygame with a mock)."""
    from minigrid_dynamicprogramming_tpu_torch.manual_control import ManualControl

    mc = ManualControl(port.make("MiniGrid-Empty-5x5-v0"), seed=0, device="cpu")
    mc.reset()
    before = mc.describe()
    assert "mission" in before and any(a * 2 in before for a in "><^V")
    out = mc.handle_key("up")
    assert out is not None and isinstance(out[0], float)
    assert mc.handle_key("x") is None  # an unbound key is ignored
    mc.handle_key("r")  # the reset binding
    with pytest.raises(SystemExit):
        mc.handle_key("q")


def test_checkpoint_roundtrip(tmp_path):
    env = port.make("MiniGrid-DoorKey-5x5-v0")
    batch = env.generate(torch.Generator().manual_seed(0), env.params, 8, "cpu")
    tree = {"env_state": batch, "counter": torch.tensor(5)}
    meta = ckpt.save(str(tmp_path / "ck"), tree, env_state=batch)
    assert len(meta["env_digests"]) == 4
    target = {
        "env_state": EnvState(**{k: torch.zeros_like(v) for k, v in vars(batch).items()}),
        "counter": torch.tensor(0),
    }
    restored = ckpt.restore(str(tmp_path / "ck"), target, env_state_of=lambda t: t["env_state"])
    for name, want in to_numpy(batch).items():
        np.testing.assert_array_equal(to_numpy(restored["env_state"])[name], want, err_msg=name)
    assert int(restored["counter"]) == 5


def test_checkpoint_integrity_check(tmp_path):
    env = port.make("MiniGrid-Empty-5x5-v0")
    batch = env.generate(torch.Generator().manual_seed(0), env.params, 4, "cpu")
    ckpt.save(str(tmp_path / "ck"), {"env_state": batch}, env_state=batch)
    meta_path = os.path.join(str(tmp_path / "ck"), "framework_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["env_digests"][0] = "deadbeefdeadbeef"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="integrity"):
        ckpt.restore(str(tmp_path / "ck"), {"env_state": batch}, env_state_of=lambda t: t["env_state"])


def test_checkpoint_train_state(tmp_path):
    """A TrainState round trip: model, optimizer, env state, pool and both
    generators; the restored run then collects the same actions."""
    ppo = PPO(port.make("MiniGrid-Empty-5x5-v0"), PPOConfig(num_envs=8, rollout_len=4, num_minibatches=2),
              device="cpu")
    ts, _ = ppo.update(ppo.init(0))
    ckpt.save(str(tmp_path / "ts"), ts, env_state=ts.env_state)
    want = ppo._collect(ts)[3]
    target = ppo.init(1)
    got_ts = ckpt.restore(str(tmp_path / "ts"), target, env_state_of=lambda t: t.env_state)
    for (name, p), q in zip(ts.model.named_parameters(), got_ts.model.parameters()):
        assert torch.equal(p, q), name
    a, b = ts.optimizer.state_dict()["state"], got_ts.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and all(torch.equal(a[k]["exp_avg_sq"], b[k]["exp_avg_sq"]) for k in a)
    assert got_ts.update_idx == 1
    for name, v in to_numpy(ts.pool).items():
        np.testing.assert_array_equal(to_numpy(got_ts.pool)[name], v, err_msg=name)
    got = ppo._collect(got_ts)[3]
    assert torch.equal(got.actions, want.actions)
    assert torch.equal(got_ts.learner_generator.get_state(), ts.learner_generator.get_state())


def test_benchmark_dp_plain_equals_jax():
    layouts = benchmark.dp_layouts(batch=4, device="cpu")
    v, policy = benchmark.dp_solve(layouts, 24, use_kernel=False)
    jlay = jtab.TabularLayout(**{k: jnp.asarray(a) for k, a in to_numpy(layouts).items()})
    jv, jpol = jax.jit(jax.vmap(partial(jtab.value_iteration, gamma=benchmark.DP_GAMMA, n_sweeps=24)))(jlay)
    assert float(np.abs(v.numpy() - np.asarray(jv)).max()) == 0.0
    np.testing.assert_array_equal(policy.numpy(), np.asarray(jpol))
    assert layouts.n_doors == 2 and float(v.max()) > 0


def test_benchmark_dp_cli_on_the_cpu(capsys):
    res = benchmark.benchmark_dp(batch=4, n_sweeps=8, device="cpu")
    assert res["vi_backend"] == "torch" and res["vi_sweeps_per_s"] > 0
    assert set(res) == {"env_id", "vi_backend", "vi_sweeps_per_s", "vi_batch", "vi_n_sweeps"}
    # The kernel runs on a card only: no fallback to the plain version.
    with pytest.raises(RuntimeError, match="card"):
        benchmark.benchmark_dp(batch=4, n_sweeps=8, use_kernel=True, device="cpu")
    assert "vi_backend: torch" in capsys.readouterr().out


def test_cli_trace_and_telemetry(tmp_path, capsys):
    reports = benchmark.main([
        "--env-id", "MiniGrid-MultiRoom-N6-v0", "--num-resets", "1", "--num-frames", "1",
        "--batch", "4", "--horizon", "2", "--device", "cpu", "--telemetry", "--trace", str(tmp_path),
    ])
    assert reports["telemetry"]["mode"] == "loop" and "gen_accept_rate: " in capsys.readouterr().out
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"reset", "render_frame", "agent_view", "lane_rollout"} <= names
