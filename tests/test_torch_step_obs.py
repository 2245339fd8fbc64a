"""The PyTorch port's lane-major step and observation against the JAX
package's, on the same states and the same actions.

States come from the JAX generator and cross over through numpy
(``bridge.from_numpy``).  The actions are a numpy script mixed with the
optimal action: each step, every env takes JAX's greedy DP action with
probability 0.7 and a uniform random action otherwise, so the run picks up
keys, unlocks doors and reaches goals; ``max_steps`` is cut so that it also
truncates.  Everything is compared exactly, except rewards: XLA on the CPU
may contract ``1 - 0.9 * x`` into one fused multiply-add, so rewards are
held within 1e-6.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core.constants import OBJ_KEY, STATE_LOCKED
from minigrid_dynamicprogramming_tpu.dp.tabular import (
    extract_layout,
    greedy_action,
    value_iteration,
)
from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

BATCH = 64
STEPS = 200
MAX_STEPS = 120  # below STEPS, so every env truncates
GREEDY_P = 0.7


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


@pytest.mark.parametrize(
    "env_id, see_through_walls, gated",
    [
        ("MiniGrid-DoorKey-5x5-v0", False, True),
        ("MiniGrid-DoorKey-5x5-v0", True, True),
        ("MiniGrid-DoorKey-8x8-v0", False, True),
        ("MiniGrid-DoorKey-8x8-v0", True, True),
        # The registry's no_boxes/no_marks gates off: the full plane path.
        ("MiniGrid-DoorKey-8x8-v0", False, False),
    ],
)
def test_step_obs_bit_identical(env_id, see_through_walls, gated):
    jenv = mgtpu.make(env_id)
    changes = dict(max_steps=MAX_STEPS, see_through_walls=see_through_walls)
    jparams = jenv.params.replace(**changes)
    tparams = port.make(env_id).params.replace(**changes)
    if not gated:
        jparams = jparams.with_extra(no_boxes=False, no_marks=False)
        tparams = tparams.with_extra(no_boxes=False, no_marks=False)

    keys = jax.random.split(jax.random.PRNGKey(5), BATCH)
    states = jax.vmap(jenv.generate, in_axes=(0, None))(keys, jenv.params)
    layouts = jax.vmap(partial(extract_layout, max_doors=1))(states)
    _, policy = jax.jit(jax.vmap(partial(value_iteration, gamma=0.995, n_sweeps=96)))(
        layouts
    )
    greedy = jax.jit(jax.vmap(greedy_action))

    jls = jlanes.to_lanes(states)
    tls = from_numpy(tlanes.LaneState, _np(jls), "cpu")
    jstep = jax.jit(partial(jlanes.step_lanes, jparams))
    jobs = jax.jit(partial(jlanes.obs_image_lanes, jparams))

    rng = np.random.default_rng(0)
    seen = dict(pickup=0, unlock=0, goal=0, truncated=0)
    for t in range(STEPS):
        jstate = jlanes.from_lanes(jparams, jls)
        act = np.asarray(greedy(policy, layouts, jstate))
        explore = rng.random(BATCH) >= GREEDY_P
        act = np.where(explore, rng.integers(0, 7, BATCH), act).astype(np.int32)

        was_locked = np.asarray(jls.grid_state) == STATE_LOCKED
        had_key = np.asarray(jls.carrying_obj) == OBJ_KEY
        jls, j_rew, j_term = jstep(jls, jax.numpy.asarray(act))
        tls, t_rew, t_term = tlanes.step_lanes(tparams, tls, torch.from_numpy(act))

        got, want = to_numpy(tls), _np(jls)
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"t={t} {name}")
        np.testing.assert_array_equal(t_term.numpy(), np.asarray(j_term))
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            tlanes.obs_image_lanes(tparams, tls).numpy(), np.asarray(jobs(jls))
        )

        seen["pickup"] += int((~had_key & (want["carrying_obj"] == OBJ_KEY)).sum())
        seen["unlock"] += int((was_locked & (want["grid_state"] != STATE_LOCKED)).sum())
        seen["goal"] += int((np.asarray(j_rew) > 0).sum())
        seen["truncated"] += int(want["truncated"].sum())
    assert all(n > 0 for n in seen.values()), seen
