"""Helpers of the port's family tests: the step and observation parity
run against the JAX package.

``step_obs_parity`` checks the port's lane-major step (hooks included) and
observation against the JAX package's on one id.

States come from the JAX generator and cross over through numpy
(``bridge.from_numpy``).  The actions are a seeded numpy script, weighted
towards forward so that agents travel; ``max_steps`` is cut so that lanes
truncate.  Each step compares every field of the state, the termination
and the observation exactly, and the reward within 1e-6 (XLA on the CPU
may contract ``1 - 0.9 * x`` into one fused multiply-add).  Each case also
counts the event its family's hook exists for, and requires it to happen.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core.constants import OBJ_LAVA
from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

BATCH = 64
STEPS = 100
MAX_STEPS = 60  # below STEPS, so every lane truncates
# left, right, forward, pickup, drop, toggle, done
ACTION_P = np.array([0.15, 0.15, 0.3, 0.1, 0.1, 0.1, 0.1])


# The observation reads only the grid's size, the view and
# see_through_walls: one compile per such params, shared by the ids.
_jax_obs_jit = jax.jit(jlanes.obs_image_lanes, static_argnums=0)


def _jax_obs(params, ls):
    return _jax_obs_jit(params.replace(max_steps=0, extra=()), ls)


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def _events(kind: str, want: dict, rew: np.ndarray, term: np.ndarray, hw_width: int) -> int:
    """How many lanes had the family's hook event in this step."""
    if kind == "reward":
        return int((rew > 0).sum())
    if kind == "lose":  # a termination that pays nothing
        return int((term & (rew == 0)).sum())
    if kind == "lava":
        idx = want["agent_y"] * hw_width + want["agent_x"]
        on = np.take_along_axis(want["grid_obj"], idx[None, :].astype(np.int64), 0)[0]
        return int((term & (on == OBJ_LAVA)).sum())
    if kind == "memory_fail":
        at = (want["agent_x"] == want["aux"][2]) & (want["agent_y"] == want["aux"][3])
        return int((term & at).sum())
    assert kind == "truncated"
    return int(want["truncated"].sum())


def step_obs_parity(env_id: str, events, prep=None) -> None:
    """``prep``, if given, maps the JAX layouts (a dict of batch-first
    numpy arrays) to the states both packages step from."""
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    # No hook of these families draws.
    assert jenv.pre_step_lanes is None and (jenv.post_step_lanes is None or not jenv.hook_rng)
    jenv.params = jenv.params.replace(max_steps=MAX_STEPS)
    tenv.params = tenv.params.replace(max_steps=MAX_STEPS)

    keys = jax.random.split(jax.random.PRNGKey(5), BATCH)
    states = jax.jit(jax.vmap(jenv.generate, in_axes=(0, None)), static_argnums=1)(
        keys, jenv.params
    )
    if prep is not None:
        changed = prep({k: v for k, v in _np(states).items() if k != "rng"})
        states = states.replace(**{k: jax.numpy.asarray(v) for k, v in changed.items()})
    jls = jlanes.to_lanes(states)
    tls = from_numpy(tlanes.LaneState, _np(jls), "cpu")
    jstep = jax.jit(lambda s, a: jlanes.step_lanes_env(jenv, None, s, a))

    rng = np.random.default_rng(0)
    seen = dict.fromkeys(events, 0)
    for t in range(STEPS):
        act = rng.choice(7, size=BATCH, p=ACTION_P).astype(np.int32)
        jls, j_rew, j_term = jstep(jls, jax.numpy.asarray(act))
        tls, t_rew, t_term = tlanes.step_lanes_env(tenv, tls, torch.from_numpy(act))

        got, want = to_numpy(tls), _np(jls)
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"t={t} {name}")
        np.testing.assert_array_equal(t_term.numpy(), np.asarray(j_term))
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            tlanes.obs_image_lanes(tenv.params, tls).numpy(),
            np.asarray(_jax_obs(jenv.params, jls)),
        )
        for kind in events:
            seen[kind] += _events(
                kind, want, np.asarray(j_rew), np.asarray(j_term), jenv.params.width
            )
    assert all(n > 0 for n in seen.values()), seen


def jax_actions(k_scan, batch: int, horizon: int, action_dim: int) -> np.ndarray:
    """JAX ``_lane_scan``'s own action draws: per step ``split(key_t)[0]``
    -> ``randint(.., (B,), 0, action_dim)``."""

    def draw(key_t):
        k_act, _ = jax.random.split(key_t)
        return jax.random.randint(k_act, (batch,), 0, action_dim)

    return np.array(jax.vmap(draw)(jax.random.split(k_scan, horizon)))


def rollout_parity(
    env_id: str, batch: int = 32, horizon: int = 80, rounds: int = 3, max_steps: int = 30
) -> None:
    """The port's ``_lane_scan`` against JAX ``lane_rollout`` given JAX's
    pool and JAX's actions, with ``max_steps`` cut below the horizon so that
    every lane resets from the pool.  The final state, resets per env,
    episodes and the observation checksum must be equal; the total reward
    sums float32 in another order, so it agrees within rtol 1e-5."""
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    jenv.params = jenv.params.replace(max_steps=max_steps)
    tenv.params = tenv.params.replace(max_steps=max_steps)
    key = jax.random.PRNGKey(7)
    want = jlanes.lane_rollout(jenv, key, batch, horizon, "pool", rounds)

    k_init, k_scan = jax.random.split(key)
    jpool = jlanes._lane_pool(jenv, k_init, batch, "pool", rounds)
    pool = from_numpy(tlanes.LaneState, _np(jpool), "cpu")
    actions = torch.from_numpy(jax_actions(k_scan, batch, horizon, jenv.action_dim))
    got = tlanes._lane_scan(tenv, None, pool, batch, horizon, "pool", rounds, actions=actions)

    assert int(want.resets_per_env.min()) >= 1
    final = to_numpy(got.final_state)
    for name, value in _np(want.final_state).items():
        if name != "rng":
            np.testing.assert_array_equal(final[name], value, err_msg=name)
    np.testing.assert_array_equal(got.resets_per_env.numpy(), np.asarray(want.resets_per_env))
    assert int(got.episodes) == int(want.episodes)
    assert int(got.obs_checksum) == int(want.obs_checksum)
    np.testing.assert_allclose(float(got.total_reward), float(want.total_reward), rtol=1e-5)
