"""The port's observation wrappers against the JAX package's, on the same
states and the same actions.

States come from the JAX generator and cross over through numpy
(``bridge.from_numpy``).  Each step, the JAX side steps the bare env under
``vmap`` and applies every JAX wrapper's ``observation`` to the stepped
state (which is what JAX's ``ObservationWrapper.step`` does); the port
steps each of its wrappers on its own state.  Observations must be equal
bit for bit ("angle" of ``DirectionObsWrapper`` within 1e-6: ``arctan``
may differ in the last ulp), rewards within 1e-6, ``terminated`` and
``truncated`` exactly.  The stepping wrappers (bonuses, ``NoDeath``, the
mission-text and the random ones, the nested stack) are in
``test_torch_wrappers_step.py``.
"""

from __future__ import annotations

import doctest

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu import wrappers as JW

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch import wrappers as TW
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState

torch.set_num_threads(1)

BATCH = 16
STEPS = 20
MAX_STEPS = 14  # below STEPS, so envs truncate
# left, right, forward, pickup, drop, toggle, done
ACTION_P = np.array([0.15, 0.15, 0.3, 0.1, 0.1, 0.1, 0.1])
OBS_ENVS = ["MiniGrid-Empty-5x5-v0", "MiniGrid-DoorKey-6x6-v0", "MiniGrid-Fetch-5x5-N2-v0"]


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def make_pair(env_id: str, max_steps: int = MAX_STEPS):
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    jenv.params = jenv.params.replace(max_steps=max_steps)
    tenv.params = tenv.params.replace(max_steps=max_steps)
    return jenv, tenv


def start_states(jenv, batch: int = BATCH, seed: int = 5):
    """A JAX-generated batch and the same states in the port."""
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    jstate = jax.jit(jax.vmap(jenv.generate, in_axes=(0, None)), static_argnums=1)(
        keys, jenv.params
    )
    return jstate, from_numpy(EnvState, _np(jstate), "cpu")


def actions(steps: int = STEPS, batch: int = BATCH, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(7, size=(steps, batch), p=ACTION_P).astype(np.int32)


def assert_equal(got, want, what: str) -> None:
    """Port output (tensor, dict of tensors) equal to JAX's bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_equal(got[k], want[k], f"{what} {k}")
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_flags(t_out, j_out, what: str) -> None:
    """reward within 1e-6, terminated and truncated exactly."""
    (_, _, t_r, t_term, t_trunc, _), (_, _, j_r, j_term, j_trunc, _) = t_out, j_out
    np.testing.assert_allclose(t_r.numpy(), np.asarray(j_r), rtol=0, atol=1e-6, err_msg=what)
    np.testing.assert_array_equal(t_term.numpy(), np.asarray(j_term), err_msg=what)
    np.testing.assert_array_equal(t_trunc.numpy(), np.asarray(j_trunc), err_msg=what)


def obs_wrappers(W, env) -> dict:
    """Every deterministic observation wrapper of module ``W`` over ``env``."""
    out = {
        "img": W.ImgObsWrapper(env),
        "one_hot": W.OneHotPartialObsWrapper(env),
        "fully": W.FullyObsWrapper(env),
        "symbolic": W.SymbolicObsWrapper(env),
        "rgb": W.RGBImgObsWrapper(env, 8),
        "rgb_no_highlight": W.RGBImgObsWrapper(env, 8, highlight=False),
        "rgb_partial": W.RGBImgPartialObsWrapper(env, 8),
        "direction_slope": W.DirectionObsWrapper(env, type="slope"),
        "direction_angle": W.DirectionObsWrapper(env, type="angle"),
    }
    for v in (3, 5, 9):
        out[f"view{v}"] = W.ViewSizeWrapper(env, v)
    return out


def assert_obs(name: str, got, want, what: str) -> None:
    if name == "direction_angle":
        np.testing.assert_allclose(
            got["goal_direction"].numpy(), np.asarray(want["goal_direction"]), rtol=0, atol=1e-6,
            err_msg=what,
        )
        got = {k: v for k, v in got.items() if k != "goal_direction"}
        want = {k: v for k, v in want.items() if k != "goal_direction"}
    assert_equal(got, want, what)


@pytest.mark.parametrize("env_id", OBS_ENVS)
def test_observation_wrappers_equal_jax(env_id):
    jenv, tenv = make_pair(env_id)
    jw, tw = obs_wrappers(JW, jenv), obs_wrappers(TW, tenv)

    @jax.jit
    @jax.vmap
    def j_obs(s):
        obs = jenv.observation(s)
        return {name: w.observation(obs, s) for name, w in jw.items()}

    jstate, tstate = start_states(jenv)
    tstates = {name: tstate for name in tw}
    want = j_obs(jstate)
    for name, w in tw.items():
        assert_obs(name, w.observation(tenv.observation(tstate), tstate), want[name], f"{name} t=-1")
    jstep = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    seen = dict(pickup=0, truncated=0)
    for t, act in enumerate(actions()):
        j_out = jstep(keys, jstate, jax.numpy.asarray(act))
        prev, jstate = jstate, j_out[1]
        want = j_obs(jstate)
        for name, w in tw.items():
            t_out = w.step(tstates[name], torch.from_numpy(act))
            tstates[name] = t_out[1]
            assert_obs(name, t_out[0], want[name], f"{env_id} {name} t={t}")
            assert_flags(t_out, j_out, f"{env_id} {name} t={t}")
        seen["pickup"] += int((np.asarray(jstate.carrying_obj) != np.asarray(prev.carrying_obj)).sum())
        seen["truncated"] += int(np.asarray(j_out[4]).sum())
    assert seen["truncated"] > 0, seen
    if env_id != "MiniGrid-Empty-5x5-v0":
        assert seen["pickup"] > 0, seen


def test_view_size_33_equals_jax():
    """A view wider than the grid, past the 31 columns of an int32 row:
    once, after the steps, against JAX's (eager: compiling JAX's sweep at
    33 columns takes a minute)."""
    jenv, tenv = make_pair("MiniGrid-DoorKey-6x6-v0")
    jstate, tstate = start_states(jenv)
    jstep = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    tw = TW.ViewSizeWrapper(tenv, 33)
    for act in actions(steps=8):
        jstate = jstep(keys, jstate, jax.numpy.asarray(act))[1]
        obs, tstate, *_ = tw.step(tstate, torch.from_numpy(act))
    jw = JW.ViewSizeWrapper(jenv, 33)
    want = jax.vmap(lambda s: jw.observation({}, s))(jstate)
    assert_equal(obs["image"], want["image"], "view 33")
    assert int((obs["image"][..., 0] == 2).sum()) > 0  # walls in view


def test_flat_obs_static_missions_equal_jax():
    """``FlatObsWrapper`` bakes in the same missions as JAX's on every id,
    and decodes the others per episode."""
    n_static = 0
    for env_id in port.registered_ids():
        outcome = []
        for W, make in ((JW, mgtpu.make), (TW, port.make)):
            try:
                chars = W.FlatObsWrapper(make(env_id))._static_chars
                outcome.append(None if chars is None else np.asarray(chars))
            except (AssertionError, ValueError):  # a fixed mission past 96 chars
                outcome.append("too long")
        j, t = outcome
        if isinstance(j, np.ndarray):
            np.testing.assert_array_equal(t, j, err_msg=env_id)
            n_static += 1
        else:
            assert t is None if j is None else t == j, env_id
    assert n_static > 50


def test_view_size_limits():
    env = port.make("MiniGrid-Empty-5x5-v0")
    assert TW.ViewSizeWrapper(env, 63).agent_view_size == 63
    for v in (1, 4, 65):
        with pytest.raises(ValueError, match="agent_view_size"):
            TW.ViewSizeWrapper(env, v)


def test_public_names_equal_jax():
    assert TW.__all__ == JW.__all__
    assert TW.get_minigrid_words() == JW.get_minigrid_words()
    for text in ("get to the green goal square", "pick up the red key, then open a door"):
        np.testing.assert_array_equal(TW.mission_char_onehot(text), JW.mission_char_onehot(text))


def test_wrapper_doctests():
    result = doctest.testmod(TW, verbose=False, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.failed == 0, f"{result.failed} wrapper doctests failed"
    assert result.attempted >= 15
