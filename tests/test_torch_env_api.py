"""The port's batch-first ``Environment`` methods against the JAX
package's vmapped ones, on the same states and the same actions.

States come from the JAX generator and cross over through numpy
(``bridge.from_numpy``); the actions are a seeded numpy script, weighted
towards forward so that agents travel, and ``max_steps`` is cut below the
steps taken so that envs truncate.  Each step compares the observation
(image, direction, mission), every field of the state, the termination
and the truncation exactly, and the reward within 1e-6 (XLA on the CPU may
contract ``1 - 0.9 * x`` into one fused multiply-add).  One id per hook
family; DynamicObstacles, whose hook draws, is held by its invariants.
The RoomGrid and BabyAI ids are in ``test_torch_env_api_rooms.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core.state import EnvState as JEnvState
from minigrid_dynamicprogramming_tpu.ops import obs as jobs
from minigrid_dynamicprogramming_tpu.registry import family as jfamily

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import COLOR_BLUE, OBJ_BALL
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.ops import obs as tobs

torch.set_num_threads(1)

BATCH = 32
STEPS = 40
MAX_STEPS = 25  # below STEPS, so every env truncates
# left, right, forward, pickup, drop, toggle, done
ACTION_P = np.array([0.15, 0.15, 0.3, 0.1, 0.1, 0.1, 0.1])


def _np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree.__dataclass_fields__}


def jax_states(jenv, batch: int = BATCH, seed: int = 5):
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return jax.jit(jax.vmap(jenv.generate, in_axes=(0, None)), static_argnums=1)(
        keys, jenv.params
    )


def assert_obs_equal(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want) == {"image", "direction", "mission"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{what} {k}")


def assert_step_parity(env_id: str) -> None:
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    jenv.params = jenv.params.replace(max_steps=MAX_STEPS)
    tenv.params = tenv.params.replace(max_steps=MAX_STEPS)
    jstate = jax_states(jenv)
    slot = jenv.params.opt("dynamic_max_steps_slot")
    if slot is not None:  # BabyAI keeps each episode's step limit in aux
        jstate = jstate.replace(aux=jstate.aux.at[:, slot].set(MAX_STEPS))
    tstate = from_numpy(EnvState, _np(jstate), "cpu")
    assert_obs_equal(tenv.observation(tstate), jax.vmap(jenv.observation)(jstate), "observation")
    jstep = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)

    rng = np.random.default_rng(0)
    seen = dict(reward=0, terminated=0, truncated=0)
    for t in range(STEPS):
        act = rng.choice(7, size=BATCH, p=ACTION_P).astype(np.int32)
        jo, jstate, j_rew, j_term, j_trunc, _ = jstep(keys, jstate, jax.numpy.asarray(act))
        to, tstate, t_rew, t_term, t_trunc, info = tenv.step(tstate, torch.from_numpy(act))
        assert info == {}
        assert_obs_equal(to, jo, f"{env_id} t={t}")
        got, want = to_numpy(tstate), _np(jstate)
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{env_id} t={t} {name}")
        np.testing.assert_array_equal(t_term.numpy(), np.asarray(j_term))
        np.testing.assert_array_equal(t_trunc.numpy(), np.asarray(j_trunc))
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0, atol=1e-6)
        seen["reward"] += int((np.asarray(j_rew) != 0).sum())
        seen["terminated"] += int(np.asarray(j_term).sum())
        seen["truncated"] += int(np.asarray(j_trunc).sum())
    assert seen["truncated"] > 0, seen


@pytest.mark.parametrize(
    "env_id",
    [
        "MiniGrid-DoorKey-8x8-v0",  # no hook
        "MiniGrid-LavaGapS7-v0",  # lava
        "MiniGrid-GoToDoor-5x5-v0",  # post-step hook (done at the door)
        "MiniGrid-Fetch-5x5-N2-v0",  # post-step hook (pickup)
        "MiniGrid-MemoryS7-v0",  # action_map
    ],
)
def test_step_equals_jax(env_id):
    assert_step_parity(env_id)


def test_view_helpers_equal_jax():
    """``get_view_coords``, ``in_view``, ``agent_sees`` and
    ``agent_view_visible_mask`` on DoorKey-8x8 states after some steps,
    at cells inside and outside the grid, scalar and per-env."""
    jenv, tenv = mgtpu.make("MiniGrid-DoorKey-8x8-v0"), port.make("MiniGrid-DoorKey-8x8-v0")
    jstate = jax_states(jenv)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    for _ in range(6):
        act = rng.choice(7, size=BATCH, p=ACTION_P).astype(np.int32)
        jstate = jstep(keys, jstate, jax.numpy.asarray(act))[1]
    tstate = from_numpy(EnvState, _np(jstate), "cpu")
    p = jenv.params

    def views(s):
        return jobs.agent_view_visible_mask(p, s), jobs.gen_obs_image(p, s), jobs.gen_obs_planes(p, s)

    j_mask, j_image, want = jax.jit(jax.vmap(views))(jstate)
    np.testing.assert_array_equal(
        tobs.agent_view_visible_mask(tenv.params, tstate).numpy(), np.asarray(j_mask)
    )
    np.testing.assert_array_equal(tobs.gen_obs_image(tenv.params, tstate).numpy(), np.asarray(j_image))
    planes = tobs.gen_obs_planes(tenv.params, tstate)
    for name, got_plane, want_plane in zip(("obj", "color", "state", "vis"), planes, want):
        np.testing.assert_array_equal(got_plane.numpy(), np.asarray(want_plane), err_msg=name)

    def helpers(s, x, y):
        return jenv.in_view(s, x, y), jenv.agent_sees(s, x, y), jobs.get_view_coords(p, s, x, y)

    jax_helpers = {
        axes: jax.jit(jax.vmap(helpers, in_axes=(0, axes, axes))) for axes in (None, 0)
    }
    cells = [(int(x), int(y)) for x, y in rng.integers(-2, 10, (12, 2))] + [(1, 1), (6, 6)]
    per_env = (rng.integers(-1, 9, BATCH).astype(np.int32), rng.integers(-1, 9, BATCH).astype(np.int32))
    seen = 0
    for x, y in cells + [per_env]:
        axes = 0 if isinstance(x, np.ndarray) else None
        j_in, j_sees, j_coords = jax_helpers[axes](jstate, jax.numpy.asarray(x), jax.numpy.asarray(y))
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        np.testing.assert_array_equal(tenv.in_view(tstate, tx, ty).numpy(), np.asarray(j_in))
        np.testing.assert_array_equal(tenv.agent_sees(tstate, tx, ty).numpy(), np.asarray(j_sees))
        for g, w in zip(tobs.get_view_coords(tenv.params, tstate, tx, ty), j_coords):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        seen += int(np.asarray(j_sees).sum())
    assert seen > 0


def test_single_env_is_a_call_at_batch_one():
    """``reset`` at B=1 and ``step`` with one int action: the same as
    JAX's unbatched ``step`` on the same state."""
    jenv, tenv = mgtpu.make("MiniGrid-DoorKey-5x5-v0"), port.make("MiniGrid-DoorKey-5x5-v0")
    obs, state = tenv.reset(torch.Generator().manual_seed(3), device="cpu")
    assert obs["image"].shape == (1, 7, 7, 3) and state.grid_obj.shape == (1, 5, 5)
    assert_obs_equal(obs, tenv.observation(state), "reset")
    arrays = {k: jax.numpy.asarray(a[0]) for k, a in to_numpy(state).items()}
    jstate = JEnvState(**arrays, rng=jax.random.PRNGKey(0))
    for act in (2, 1, 2, 3, 0, 5):
        jo, jstate, j_rew, j_term, j_trunc, _ = jenv.step(
            jax.random.PRNGKey(0), jstate, jax.numpy.int32(act)
        )
        obs, state, rew, term, trunc, _ = tenv.step(state, act)
        assert_obs_equal({k: v[0] for k, v in obs.items()}, jo, f"action {act}")
        assert float(rew[0]) == pytest.approx(float(j_rew), abs=1e-6)
        assert bool(term[0]) == bool(j_term) and bool(trunc[0]) == bool(j_trunc)


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-6x6-v0"])
def test_dynamic_obstacles_step_keeps_its_balls(env_id):
    """The hook draws, so ``step`` needs a generator; with one, every step
    keeps each env's balls, blue and named by aux, and pays 0, -1 or a
    success reward."""
    env = port.make(env_id)
    g = torch.Generator().manual_seed(0)
    obs, state = env.reset(g, 64, device="cpu")
    n_obs = int((state.grid_obj[0] == OBJ_BALL).sum())
    with pytest.raises(ValueError, match="pass a generator"):
        env.step(state, torch.zeros(64, dtype=torch.int32))
    rng = np.random.default_rng(0)
    collisions = 0
    for _ in range(30):
        act = torch.from_numpy(rng.choice(7, size=64, p=ACTION_P).astype(np.int32))
        obs, state, rew, term, trunc, _ = env.step(state, act, g)
        balls = state.grid_obj == OBJ_BALL
        assert (balls.sum(dim=(1, 2)) == n_obs).all()
        assert (state.grid_color[balls] == COLOR_BLUE).all()
        xs, ys = state.aux[:, 0:2 * n_obs:2].long(), state.aux[:, 1:2 * n_obs:2].long()
        assert balls[torch.arange(64)[:, None], ys, xs].all()
        assert ((rew == 0) | (rew == -1) | ((rew > 0) & (rew <= 1))).all()
        assert_obs_equal(obs, env.observation(state), "step")
        collisions += int((rew == -1).sum())
    assert collisions > 0


def test_reset_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = port.make("MiniGrid-Empty-5x5-v0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.reset(torch.Generator())
    assert env.default_params is env.params


def test_public_names_equal_jax():
    for name in ("Environment", "EnvParams", "EnvState", "make", "register", "registered_ids"):
        assert name in port.__all__ and name in mgtpu.__all__
    ids = port.registered_ids()
    assert [port.registry.family(i) for i in ids] == [jfamily(i) for i in ids]
    port.register("Test-DoorKey-Alias-v0", lambda: port.make("MiniGrid-DoorKey-5x5-v0"))
    try:
        assert port.make("Test-DoorKey-Alias-v0").params == port.make("MiniGrid-DoorKey-5x5-v0").params
        assert port.registry.family("Test-DoorKey-Alias-v0") == "misc"
    finally:
        port.registry._REGISTRY.pop("Test-DoorKey-Alias-v0")
