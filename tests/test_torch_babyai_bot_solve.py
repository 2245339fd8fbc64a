"""The port's BabyAI bot solves every BabyAI level of the port, as
``tests/test_babyai_bot.py`` requires of the JAX package's bot.

``test_bot_solves_level``: each of the 86 fast ids must be solved (the
verifier terminates with a positive reward) in at least one of
``MAX_SEEDS`` = 8 episodes within 240 steps.  The port runs the eight as
one batch (``run_bots``: one bot per env, one batch-first ``step``) where
JAX runs seed after seed.  ``test_bot_solve_rate`` (``-m slow``): the
measured per-level solve rate over 20 episodes must clear 90%, planner
errors counted as failures.  The known-unsolvable levels are JAX's.
"""

from __future__ import annotations

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.utils.babyai_bot import run_bots

torch.set_num_threads(1)

BROKEN_BONUS_ENVS = {
    "BabyAI-PutNextS5N2Carrying-v0",
    "BabyAI-PutNextS6N3Carrying-v0",
    "BabyAI-PutNextS7N4Carrying-v0",
    "BabyAI-KeyInBox-v0",
}
BABYAI_ENVS = [
    i for i in port.registered_ids() if i.startswith("BabyAI-") and i not in BROKEN_BONUS_ENVS
]
HEAVY_BOT_ENVS = {
    "BabyAI-BossLevel-v0",
    "BabyAI-BossLevelNoUnlock-v0",
    "BabyAI-SynthSeq-v0",
    "BabyAI-MiniBossLevel-v0",
    "BabyAI-SynthLoc-v0",
    "BabyAI-SynthS5R2-v0",
}
FAST_BOT_ENVS = [i for i in BABYAI_ENVS if i not in HEAVY_BOT_ENVS]

MAX_STEPS = 240
MAX_SEEDS = 8
SOLVE_SEEDS = 20
SOLVE_FLOOR = 0.90


def _run(env_id: str, episodes: int, seed: int = 0):
    env = port.make(env_id)
    _, state = env.reset(torch.Generator().manual_seed(seed), episodes, device="cpu")
    return run_bots(env, state, MAX_STEPS)


def test_the_fast_ids():
    assert len(BABYAI_ENVS) == 92 and len(FAST_BOT_ENVS) == 86


@pytest.mark.parametrize("env_id", FAST_BOT_ENVS)
def test_bot_solves_level(env_id):
    run = _run(env_id, MAX_SEEDS)
    assert run.solved.any(), f"bot failed to solve {env_id} within {MAX_SEEDS} seeds: {run}"
    assert (run.reward[run.solved] > 0).all()


@pytest.mark.slow
@pytest.mark.parametrize("env_id", sorted(HEAVY_BOT_ENVS))
def test_bot_solves_heavy_level(env_id):
    test_bot_solves_level(env_id)


@pytest.mark.slow
@pytest.mark.parametrize("env_id", BABYAI_ENVS)
def test_bot_solve_rate(env_id):
    """Measured solve rate over SOLVE_SEEDS episodes, errors = failures."""
    run = _run(env_id, SOLVE_SEEDS)
    rate = float(run.solved.mean())
    failures = [(i, e or "unsolved") for i, (ok, e) in enumerate(zip(run.solved, run.errors)) if not ok]
    assert rate >= SOLVE_FLOOR, (
        f"{env_id}: solve rate {rate:.0%} < {SOLVE_FLOOR:.0%} "
        f"({int(run.solved.sum())}/{SOLVE_SEEDS}); failures={failures}"
    )
