"""The BossLevel rollout cells (``drivers/babyai_rollout.py``), run through
the harness on the CPU at a small size, agree with the plain reference
(``reference/babyai_levelgen.py``): every generated level passes its
rules, every exact number is 0 and the reward within its limit.  The
control (the reference's reward in bfloat16) fails.  The reference loads
no JAX and no module of the port.  The planted faults are
``test_portbench_bosslevel_faults.py``'s."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.reference import babyai_levelgen as ref

POOL, REGEN = "bosslevel.rollout-pool", "bosslevel.rollout-regen"
# The pool cell at the size the CPU can replay quickly, with rounds enough
# (256 layouts) that every instruction shape shows (at 128 a shape of
# probability 1/24 goes unseen in about one run of 30); the regen cell
# generates a batch a step (about 0.17 s on one CPU thread), three calls'
# worth a run, so it takes fewer steps (576 layouts).
SMALL = {POOL: dict(batch=64, horizon=48, pool_rounds=4, check_within=1),
         REGEN: dict(batch=64, horizon=8, check_within=1)}
SEEDS = (20260419, 7, 3141592653)


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def run(bench, cell, seed=SEEDS[0], overrides=None, control=False):
    return harness.run_cell(bench, cell, seed, 0.0, False, "cpu", time.time(),
                            overrides=overrides or SMALL[cell], control=control)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [POOL, REGEN])
def test_bosslevel_agrees_with_the_reference(bench, cell, seed):
    line = run(bench, cell, seed)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k != "reward_gap")
    assert line["checks"]["reward_gap"]["value"] <= 2e-4
    assert {"env_steps_per_s", "setup_s"} == set(line["metrics"]) and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


def test_generated_levels_pass_the_rules():
    import minigrid_dynamicprogramming_tpu_torch as port
    from portbench.drivers import babyai_rollout as driver

    env = port.make("BabyAI-BossLevel-v0")
    g = torch.Generator().manual_seed(11)
    s = driver.ref_layout(env, env.generate(g, env.params, 256, "cpu"))
    assert not ref.invalid_layouts(s).any()
    assert ref.unseen_shapes(ref.instruction_shapes(s["codes"])) == 0
    # Each rule is live: a level with a rule broken fails.
    broken = {k: v.clone() for k, v in s.items()}
    broken["steps"][0] = 1
    broken["obj"][1, 0, 0] = ref.dk.EMPTY
    broken["codes"][2, 1] = 1
    broken["max_steps"][3] += 1
    # Room (0, 0) walled off: its doors made grey walls.
    for plane, value in (("obj", ref.dk.WALL), ("color", ref.dk.GREY), ("state", 0)):
        broken[plane][4, 1:ref.PITCH, ref.PITCH] = value
        broken[plane][4, ref.PITCH, 1:ref.PITCH] = value
    assert ref.invalid_layouts(broken)[:5].all() and not ref.invalid_layouts(broken)[5:].any()
    assert ref.broken_rules(broken)["connected"].tolist() == [False] * 4 + [True] + [False] * 251


def test_bosslevel_control_fails(bench):
    # At this size and seed the random actions complete a few missions, so
    # that the reward's precision shows.
    line = run(bench, POOL, seed=7, control=True)
    assert not line["correct"]
    reward = line["checks"]["reward_gap"]
    assert reward["value"] > 3 * reward["limit"]


def test_reference_loads_no_jax_and_no_port():
    code = ("import sys; from portbench.reference import babyai_levelgen; from portbench import harness; "
            "bad = harness.forbidden_loaded() + [m for m in sys.modules "
            "if m.split('.')[0] == 'minigrid_dynamicprogramming_tpu_torch']; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.CHECKOUT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
