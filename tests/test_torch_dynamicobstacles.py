"""DynamicObstacles in the port against the JAX package.

The balls' moves draw from a ``torch.Generator`` in the port and from
per-env threefry keys in JAX, so they cannot match draw for draw.  What
draws nothing must match bit for bit: the action map, the "front not
clear" flag that ``pre_step`` reads from the grid before any ball moves,
and the core step plus ``post_step`` run by JAX on the port's state after
its ``pre_step`` (rewards within 1e-6, as in the other step tests).  The
moves are held by their law: each ball, in order, lands on a free cell of
its 3x3 neighbourhood (free as the earlier balls left the grid), or stays
where that neighbourhood has none; and over 4096 copies of one layout the
first ball's landing cell is uniform over its free cells (chi-square, p
above 1e-3, a fixed seed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy import stats

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL, OBJ_EMPTY
from minigrid_dynamicprogramming_tpu_torch.envs.dynamicobstacles import NOT_CLEAR_SLOT
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

ENV_ID = "MiniGrid-Dynamic-Obstacles-6x6-v0"
BATCH = 64
STEPS = 40
P_FLOOR = 1e-3


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def _to_jax(tls) -> jlanes.LaneState:
    arrays = to_numpy(tls)
    b = arrays["agent_x"].shape[0]
    return jlanes.LaneState(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        rng=jnp.zeros((b, 2), jnp.uint32),
    )


def _jax_start(jenv, batch: int, seed: int):
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    states = jax.vmap(jenv.generate, in_axes=(0, None))(keys, jenv.params)
    jls = jlanes.to_lanes(states)
    return jls, from_numpy(tlanes.LaneState, _np(jls), "cpu")


def _check_moves(before: dict, after: dict, n_obs: int, w: int) -> int:
    """Replay the balls' moves in numpy, in order: each lands on a free
    cell of its 3x3 neighbourhood, or stays where it has none.  The
    replayed grid must be the port's.  Returns the number of balls that
    moved."""
    grid = before["grid_obj"].copy()  # (HW, B)
    hw, b = grid.shape
    xs, ys = np.arange(hw) % w, np.arange(hw) // w
    agent = (ys[:, None] == before["agent_y"]) & (xs[:, None] == before["agent_x"])
    moved = 0
    for i in range(n_obs):
        ox, oy = before["aux"][2 * i], before["aux"][2 * i + 1]
        nx, ny = after["aux"][2 * i], after["aux"][2 * i + 1]
        near = (np.abs(xs[:, None] - ox) <= 1) & (np.abs(ys[:, None] - oy) <= 1)
        free = (grid == OBJ_EMPTY) & ~agent & near
        stay = (nx == ox) & (ny == oy)
        assert (free.sum(0)[stay] == 0).all(), f"ball {i} stayed beside a free cell"
        lanes = np.flatnonzero(~stay)
        assert free[(ny * w + nx)[lanes], lanes].all(), f"ball {i} landed on a non-free cell"
        grid[(oy * w + ox)[lanes], lanes] = OBJ_EMPTY
        grid[(ny * w + nx)[lanes], lanes] = OBJ_BALL
        moved += len(lanes)
    np.testing.assert_array_equal(grid, after["grid_obj"])
    return moved


def test_hooks_bit_exact_and_moves_valid():
    jenv, tenv = mgtpu.make(ENV_ID), port.make(ENV_ID)
    p = tenv.params
    n_obs = 3
    _, tls = _jax_start(jenv, BATCH, seed=2)
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    jstep = jax.jit(lambda s, a: jlanes.step_lanes(jenv.params, s, a))
    jpost = jax.jit(lambda prev, s, a, r, t: jenv.post_step_lanes(jenv.params, None, prev, s, a, r, t))
    jpre = jax.jit(lambda k, s, a: jenv.pre_step_lanes(jenv.params, k, s, a))
    seen = dict(moved=0, collided=0, goal=0)
    for t in range(STEPS):
        raw = rng.integers(0, 7, BATCH).astype(np.int32)  # beyond action_dim too
        act = tenv.action_map(p, torch.from_numpy(raw))
        np.testing.assert_array_equal(act.numpy(), np.asarray(jenv.action_map(jenv.params, raw)))

        g_pre = torch.Generator().set_state(g.get_state())
        after_pre = tenv.pre_step_lanes(p, g_pre, tls, act)
        new, t_rew, t_term = tlanes.step_lanes_env(tenv, tls, torch.from_numpy(raw), g)
        # The same draws: the port's pre_step state is the step's.
        torch.testing.assert_close(new.aux, after_pre.aux, rtol=0, atol=0)

        # The flag equals JAX's pre_step's on the same pre-move state.
        jprev = _to_jax(tls)
        keys = jax.random.split(jax.random.PRNGKey(t), BATCH)
        j_pre = jpre(keys, jprev, jnp.asarray(act.numpy()))
        np.testing.assert_array_equal(
            after_pre.aux[NOT_CLEAR_SLOT].numpy(), np.asarray(j_pre.aux[NOT_CLEAR_SLOT])
        )

        # JAX's core step and post_step on the port's pre_step state.
        ja = jnp.asarray(act.numpy())
        jls, j_rew, j_term = jstep(_to_jax(after_pre), ja)
        jls, j_rew, j_term = jpost(jprev, jls, ja, j_rew, j_term)
        jls = jls.replace(terminated=j_term)
        got, want = to_numpy(new), _np(jls)
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"t={t} {name}")
        np.testing.assert_array_equal(t_term.numpy(), np.asarray(j_term))
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0, atol=1e-6)

        seen["moved"] += _check_moves(to_numpy(tls), to_numpy(after_pre), n_obs, p.width)
        seen["collided"] += int((t_rew.numpy() == -1).sum())
        seen["goal"] += int((t_rew.numpy() > 0).sum())
        tls = new
    assert seen["moved"] > 0 and seen["collided"] > 0, seen


def test_first_ball_moves_uniformly():
    """4096 copies of one layout, one pre_step: the first ball's landing
    cell against the uniform law over its free neighbours."""
    jenv, tenv = mgtpu.make(ENV_ID), port.make(ENV_ID)
    p = tenv.params
    _, one = _jax_start(jenv, 1, seed=3)
    b = 4096
    tls = one.map(lambda x: x.expand(*x.shape[:-1], b).clone())
    before = to_numpy(tls)
    act = torch.zeros(b, dtype=torch.int32)
    after = to_numpy(tenv.pre_step_lanes(p, torch.Generator().manual_seed(4), tls, act))

    hw = p.width * p.height
    xs, ys = np.arange(hw) % p.width, np.arange(hw) // p.width
    ox, oy = before["aux"][0, 0], before["aux"][1, 0]
    agent = (xs == before["agent_x"][0]) & (ys == before["agent_y"][0])
    free = (before["grid_obj"][:, 0] == OBJ_EMPTY) & ~agent
    free &= (np.abs(xs - ox) <= 1) & (np.abs(ys - oy) <= 1)
    cells = np.flatnonzero(free)
    assert len(cells) >= 3, "pick a layout whose first ball has room to move"
    landed = after["aux"][1] * p.width + after["aux"][0]
    counts = np.array([(landed == c).sum() for c in cells])
    assert counts.sum() == b
    assert stats.chisquare(counts).pvalue > P_FLOOR, counts
