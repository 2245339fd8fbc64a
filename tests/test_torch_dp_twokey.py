"""The port's two-key DP (``dp/tabular_twokey.py``) against the JAX
package's on UnlockToUnlock at room size 4 (a 10x4 grid: two locked doors,
two keys, the ball in the far room), the layouts that
``tests/test_dp_twokey.py`` solves, built here by the JAX package's numpy
twin of the reference's generation at seeds 0-2: the layouts equal field by
field, V within 1e-6 and the greedy policy equal wherever the best action
leads the next by more than 1e-6, at 112 sweeps.  Then the greedy policy,
stepped by the port's ``step_lanes_env`` with the BabyAI verifier, picks up
the ball in exactly ``twokey_steps_to_go`` steps with the return the value
predicts."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu.core.state import EnvState as JState
from minigrid_dynamicprogramming_tpu.dp import tabular_twokey as jtk
from minigrid_dynamicprogramming_tpu.utils import twin_babyai

from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_twokey as ttk
from minigrid_dynamicprogramming_tpu_torch.dp.tabular import env_return
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.level import make_level
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

from ._torch_babyai import stack

torch.set_num_threads(2)

GAMMA = 0.995
SWEEPS = 112
SEEDS = (0, 1, 2)
ROOM_SIZE, MAX_STEPS = 4, 480


@pytest.fixture(scope="module")
def solved():
    layouts = [
        twin_babyai.gen_level(
            s, twin_babyai._unlock_to_unlock, room_size=ROOM_SIZE, num_rows=1, num_cols=3,
            fixed_max_steps=MAX_STEPS,
        )
        for s in SEEDS
    ]
    arrays = stack(layouts)
    # The target: the one ball ("pick up the ball" names no color).
    balls = arrays["grid_obj"] == OBJ_BALL
    assert (balls.sum(axis=(1, 2)) == 1).all()
    color = arrays["grid_color"][balls].astype(np.int32)
    kind = np.full(len(SEEDS), OBJ_BALL, np.int32)

    js = JState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                rng=jnp.zeros((len(SEEDS), 2), jnp.uint32))
    jl = jax.vmap(lambda s, t, c: jtk.extract_twokey_layout(s, 2, t, c))(js, kind, color)
    jv, jpol = jax.jit(jax.vmap(lambda lay: jtk.twokey_value_iteration(lay, GAMMA, SWEEPS)))(jl)

    ts = from_numpy(EnvState, arrays, "cpu")
    tl = ttk.extract_twokey_layout(ts, 2, torch.from_numpy(kind), torch.from_numpy(color))
    tv, tpol = ttk.twokey_value_iteration(tl, GAMMA, SWEEPS)
    return jl, np.asarray(jv), np.asarray(jpol), ts, tl, tv, tpol


def test_layouts_equal_jax(solved):
    jl, _, _, _, tl, _, _ = solved
    got = to_numpy(tl)
    assert set(got) == set(jl._fields)
    for name in jl._fields:
        want = np.asarray(getattr(jl, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    # Two keys on the grid, two locked doors each opened by one of them.
    assert (tl.key0 >= 0).all() and (tl.key0 < 40).all()
    assert (tl.door_unlockable.sum(dim=2) == 1).all()


def test_values_and_policy_equal_jax(solved):
    _, jv, jpol, _, tl, tv, tpol = solved
    assert tv.shape == (len(SEEDS), 42, 42, 4, 4, 4, 10)
    assert (tv > 0).any()
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)
    tables = ttk._tables(tl, tv.shape[1])
    unique = torch.empty(tv.shape, dtype=torch.bool)
    for d, t in enumerate(tables):
        q = torch.stack(list(ttk._action_values(tv, t, d, tl.box_idx, GAMMA)))
        top2 = q.topk(2, dim=0).values
        unique[:, :, :, :, d] = top2[0] - top2[1] > 1e-6
    assert unique.float().mean() > 0.2
    np.testing.assert_array_equal(tpol[unique].numpy(), jpol[unique.numpy()])


def test_greedy_picks_up_the_ball_in_steps_to_go(solved):
    _, _, _, ts, tl, tv, tpol = solved
    env = make_level(
        "BabyAI-UnlockToUnlock-v0", None, ROOM_SIZE, 1, 3, max_steps=MAX_STEPS,
        instr_profile=B.single_profile("pickup"),
    )
    v0 = ttk.twokey_state_value(tv, tl, ts)
    dist = ttk.twokey_steps_to_go(v0, GAMMA)
    assert torch.isfinite(dist).all() and (dist > 20).all(), dist
    want = env_return(v0, GAMMA, 0, ts.aux[:, B.AUX_MAX_STEPS].float())
    ls = tlanes.to_lanes(ts)
    got = torch.zeros(len(SEEDS))
    for t in range(int(dist.max())):
        act = ttk.twokey_greedy_action(tpol, tl, tlanes.from_lanes(env.params, ls))
        ls, r, term = tlanes.step_lanes_env(env, ls, act)
        live = t < dist
        ends = live & (t + 1 == dist)
        assert torch.equal(term[live], ends[live]), (t, term, dist)
        got = torch.where(ends, r, got)
    assert (got > 0).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
