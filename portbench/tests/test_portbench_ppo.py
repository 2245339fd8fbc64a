"""The PPO cell's driver (``drivers/ppo_update.py``), run through the
harness on the CPU at a small size, agrees with the plain reference; each
fault planted in the timed path makes ``correct`` come out false; a run
of it in a fresh process loads no JAX."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

CELL = "gotodoor.ppo-update"
# Rows enough a minibatch (32 x 128) that the loss terms' means settle.
SMALL = dict(num_envs=256, rollout_len=32, epochs=2, num_minibatches=2, check_block=4096)


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def run(bench, overrides=SMALL, seed=20260418, control=False):
    return harness.run_cell(bench, CELL, seed, 0.0, False, "cpu", time.time(),
                            overrides=overrides, control=control)


def test_ppo_update_agrees_with_the_reference(bench):
    line = run(bench)
    assert line["correct"], line["checks"]
    exact = ("invalid_layouts", "obs_gap", "done_gap", "state_lanes", "reset_lanes", "episodes_gap")
    assert all(line["checks"][k]["value"] == 0 for k in exact)
    assert {"env_steps_per_s", "setup_s"} == set(line["metrics"]) and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


def test_ppo_control_fails(bench):
    line = run(bench, control=True)
    assert not line["correct"]


def _fault(monkeypatch, fault: str) -> None:
    from minigrid_dynamicprogramming_tpu_torch.models import ppo as P
    from minigrid_dynamicprogramming_tpu_torch.parallel import lanes

    if fault == "conv":
        real = P.PPO.update

        def altered(self, ts):
            with torch.no_grad():
                ts.model.encoder.convs[1].weight[0, 0, 1, 1] += 0.5
            return real(self, ts)

        monkeypatch.setattr(P.PPO, "update", altered)
    elif fault == "lr":
        real_init = P.PPO.init

        def doubled(self, seed=0):
            ts = real_init(self, seed)
            for group in ts.optimizer.param_groups:
                group["lr"] *= 2
            return ts

        monkeypatch.setattr(P.PPO, "init", doubled)
    elif fault == "half":
        real_new = P.PPO.__init__

        def halved(self, *args, **kwargs):
            real_new(self, *args, **kwargs)
            # Rows are step-major: the second half of each minibatch's envs
            # counts nowhere in the learner.
            weight = self._row_weight.view(self.config.rollout_len, -1)
            weight[:, weight.shape[1] // 2:] = 0

        monkeypatch.setattr(P.PPO, "__init__", halved)
    else:
        real_step = lanes.step_lanes_env

        def reward(env, ls, action, generator=None):
            ls, r, term = real_step(env, ls, action, generator)
            return ls, r + (torch.arange(r.shape[0], device=r.device) == 0) * 0.25, term

        monkeypatch.setattr(lanes, "step_lanes_env", reward)


@pytest.mark.parametrize("fault", ["conv", "lr", "half", "reward"])
def test_ppo_faults_fail(bench, monkeypatch, fault):
    _fault(monkeypatch, fault)
    line = run(bench, dict(SMALL, num_envs=64, epochs=1))
    assert not line["correct"], (fault, line["checks"])


def test_a_ppo_run_loads_no_jax():
    """A whole (tiny, CPU) run of the PPO driver, in a fresh process, leaves
    no JAX module and no module of the JAX package in ``sys.modules``."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "harness.run_cell(harness.benchmark(), %r, 7, 0.0, False, 'cpu', time.time(),"
        " overrides=dict(num_envs=16, rollout_len=8, epochs=1, num_minibatches=2, check_block=64))\n"
        "print(harness.forbidden_loaded())\n" % (str(harness.CHECKOUT), CELL)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_param_update_gap_leaves_out_only_tensors_at_rounding_level():
    """The widest tensor's gap counts, except a tensor whose reference
    update moves by more than the level when the reference's work is
    rounded to the program's dtype."""
    from portbench.drivers import ppo_update as D

    start = {"params": {"w": torch.zeros(4), "b": torch.zeros(1)}}
    want = {"logps": torch.zeros(3), "values": torch.zeros(3), "terms": [1.0] * 5,
            "exp_avg": {"w": torch.ones(4), "b": torch.ones(1)},
            "params": {"w": torch.ones(4), "b": torch.ones(1)}}
    got = {**want, "params": {"w": torch.full((4,), 1.5), "b": torch.full((1,), -1.0)}}
    kept = D._gaps(got, want, start, {"w": 0.01, "b": 0.01}, 0.05)
    left_out = D._gaps(got, want, start, {"w": 0.01, "b": 0.2}, 0.05)
    assert kept["param_update_gap"] == pytest.approx(2.0)
    assert left_out["param_update_gap"] == pytest.approx(0.5)
    assert left_out["grad_moment_gap"] == 0.0 and left_out["loss_gap"] == 0.0
