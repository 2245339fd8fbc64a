"""The port's BabyAI bot, on the port's env, picks the same action at every
step as the JAX package's bot on the JAX package's env.

One id from each BabyAI module of the JAX package (``goto.py``,
``open.py``, ``pickup.py``, ``unlock.py``, ``other.py``, ``levelgen.py``),
four start states each from the JAX package's numpy twin
(``tests/_torch_babyai.py``).  The port drives its four bots over one
batch-first ``step`` (``run_bots``); JAX's bot runs one env at a time over
the jitted ``step``, as ``tests/test_babyai_bot.py`` drives it.  The action
sequences, their lengths and the terminal rewards must agree; so must the
outcome where both bots fail (OpenDoorsOrderN2Debug ends some episodes on
a wrong door), and so must the planner's own assertion: on the PickupDist
layouts below both bots raise "nothing to drop" after the same actions,
which ``run_bots`` records as that env's error while the others run on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core.state import EnvState as JEnvState
from minigrid_dynamicprogramming_tpu.utils.babyai_bot import BabyAIBot as JBot

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.utils.babyai_bot import (
    BabyAIBot,
    HostState,
    host_snapshot,
    run_bots,
)

from ._torch_babyai import twin_batch

torch.set_num_threads(1)

MAX_STEPS = 240
SEEDS = range(4)
# Twin seeds of PickupDist whose layouts make both planners assert
# ("nothing to drop"), beside seed 0, which both solve.
PICKUPDIST_ASSERTS = (7, 19, 20)
SEEDS_OF = {"BabyAI-PickupDist-v0": (0,) + PICKUPDIST_ASSERTS}


@pytest.mark.parametrize(
    "env_id",
    [
        "BabyAI-GoToImpUnlock-v0",  # goto.py
        "BabyAI-OpenDoorsOrderN2Debug-v0",  # open.py
        "BabyAI-PutNextLocal-v0",  # pickup.py
        "BabyAI-PickupDist-v0",  # pickup.py
        "BabyAI-BlockedUnlockPickup-v0",  # unlock.py
        "BabyAI-MoveTwoAcrossS5N2-v0",  # other.py
        "BabyAI-MiniBossLevel-v0",  # levelgen.py
    ],
)
def test_bot_actions_equal_jax(env_id):
    seeds = SEEDS_OF.get(env_id, SEEDS)
    arrays = twin_batch(env_id, seeds)
    run = run_bots(port.make(env_id), from_numpy(EnvState, arrays, "cpu"), MAX_STEPS)
    jenv = mgtpu.make(env_id)
    jstep = jax.jit(jenv.step)
    for i in range(len(seeds)):
        state = JEnvState(**{k: jnp.asarray(v[i]) for k, v in arrays.items()},
                          rng=jax.random.PRNGKey(0))
        bot, last, want, error = JBot(jenv, state), None, [], None
        for t in range(MAX_STEPS):
            try:
                last = bot.replan(state, last)
            except AssertionError as e:
                error = f"AssertionError: {e}"
                break
            want.append(last)
            _, state, reward, term, trunc, _ = jstep(jax.random.PRNGKey(t), state, jnp.int32(last))
            if bool(term) or bool(trunc):
                break
        got = run.actions[:, i]
        np.testing.assert_array_equal(got[got >= 0], want, err_msg=f"{env_id} env {i}")
        assert run.steps[i] == len(want)
        assert run.errors[i] == error
        if error is None:
            assert run.reward[i] == pytest.approx(float(reward), abs=1e-6)
            assert run.solved[i] == (bool(term) and float(reward) > 0)
    if env_id == "BabyAI-PickupDist-v0":
        assert run.solved[0] and not run.solved[1:].any()
        assert run.errors[1:] == ["AssertionError: nothing to drop"] * len(PICKUPDIST_ASSERTS)
    elif env_id != "BabyAI-OpenDoorsOrderN2Debug-v0":
        assert run.solved.all()


def test_host_snapshot_is_the_state():
    """One transfer carries every field the bot reads, the reward's bits
    included; a bot made from the state and one from its snapshot plan
    alike."""
    env = port.make("BabyAI-GoToLocal-v0")
    _, state = env.reset(torch.Generator().manual_seed(0), 3, device="cpu")
    reward = torch.tensor([0.5, -1.0, 0.123456789], dtype=torch.float32)
    snap = host_snapshot(state, reward)
    assert isinstance(snap, HostState)
    for name in ("grid_obj", "grid_color", "grid_state", "marks", "agent_pos", "agent_dir",
                 "carrying_obj", "carrying_color", "carrying_marks", "terminated",
                 "truncated", "mission"):
        np.testing.assert_array_equal(snap.__dict__[name], getattr(state, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(snap.reward, reward.numpy())
    for i in range(3):
        assert BabyAIBot(env, state, i).replan(state) == BabyAIBot(env, snap, i).replan(snap)
