"""The port's renderer against the JAX package's, bit for bit.

``tile_lut`` byte for byte; ``render_frame`` (with and without the view
highlight), ``render_pov`` and ``view_highlight_mask`` on 16 states of each
id against JAX's functions under ``vmap``, on the start states and after
a scripted step in which one agent picks up a key (the carried-object
overlay of the POV) and one opens a door, then two more steps.  States
come from the JAX generator (the BabyAI id from the JAX package's numpy
twin, ``tests/_torch_babyai.py``) and are stepped by the port, whose step
the env tests hold to JAX's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu import render as JR
from minigrid_dynamicprogramming_tpu.core.state import EnvState as JEnvState
from minigrid_dynamicprogramming_tpu.render import tiles as JT

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch import render as TR
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_PICKUP,
    ACT_TOGGLE,
    COLOR_YELLOW,
    OBJ_DOOR,
    OBJ_KEY,
    STATE_CLOSED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.render import tiles as TT

from ._torch_babyai import twin_batch

torch.set_num_threads(1)

BATCH = 16
TILE = 8
IDS = [
    "MiniGrid-Empty-5x5-v0",
    "MiniGrid-DoorKey-6x6-v0",
    "MiniGrid-Fetch-5x5-N2-v0",
    "MiniGrid-LavaCrossingS9N1-v0",
    "MiniGrid-GoToDoor-5x5-v0",  # sees through walls
    "BabyAI-GoToLocal-v0",
]


def test_tile_lut_equals_jax():
    got, want = TT.tile_lut(TILE), JT.tile_lut(TILE)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    lut = TT.tile_lut_tensor(TILE, torch.device("cpu"))
    assert lut is TT.tile_lut_tensor(TILE, torch.device("cpu"))  # made once
    np.testing.assert_array_equal(lut.numpy(), want)


@functools.lru_cache(maxsize=None)
def start_arrays(env_id: str) -> dict:
    """16 start states (callers copy before they write)."""
    if env_id.startswith("BabyAI-"):
        return twin_batch(env_id, range(BATCH))
    jenv = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(3), BATCH)
    s = jax.jit(jax.vmap(jenv.generate, in_axes=(0, None)), static_argnums=1)(keys, jenv.params)
    return {n: np.asarray(getattr(s, n)) for n in s.__dataclass_fields__ if n != "rng"}


def stage(a: dict) -> dict:
    """Env 0 faces a key, env 1 a closed door, both from cell (1, 1)."""
    a = {k: v.copy() for k, v in a.items()}
    for b, (obj, color, st) in enumerate(((OBJ_KEY, COLOR_YELLOW, 0), (OBJ_DOOR, COLOR_YELLOW, STATE_CLOSED))):
        a["agent_pos"][b], a["agent_dir"][b] = (1, 1), 0
        a["grid_obj"][b, 1, 2], a["grid_color"][b, 1, 2], a["grid_state"][b, 1, 2] = obj, color, st
        a["carrying_obj"][b] = 1
    return a


def jax_renders(params):
    def one(s):
        return (
            JR.render_frame(params, s, TILE, True),
            JR.render_frame(params, s, TILE, False),
            JR.render_pov(params, s, TILE),
            JR.view_highlight_mask(params, s),
        )

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("env_id", IDS)
def test_render_equals_jax(env_id):
    tenv = port.make(env_id)
    p = tenv.params
    j_render = jax_renders(mgtpu.make(env_id).params)
    rng = np.random.default_rng(1)
    state = from_numpy(EnvState, stage(start_arrays(env_id)), "cpu")
    for t in range(4):
        if t:
            act = rng.integers(0, 7, BATCH)
            act[:2] = (ACT_PICKUP, ACT_TOGGLE) if t == 1 else act[:2]
            state = tenv.step(state, torch.from_numpy(act))[1]
        if t == 1:
            assert int(state.carrying_obj[0]) == OBJ_KEY
            assert int(state.grid_state[1, 1, 2]) == STATE_OPEN
        arrays = to_numpy(state)
        jstate = JEnvState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                           rng=jnp.zeros((BATCH, 2), jnp.uint32))
        want = j_render(jstate)
        got = (
            TR.render_frame(p, state, TILE, True),
            TR.render_frame(p, state, TILE, False),
            TR.render_pov(p, state, TILE),
            TR.view_highlight_mask(p, state),
        )
        for name, g, w in zip(("frame", "frame_no_highlight", "pov", "highlight_mask"), got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{env_id} {name} t={t}")
    assert tuple(got[0].shape) == (BATCH, p.height * TILE, p.width * TILE, 3)
    v = p.agent_view_size
    assert tuple(got[2].shape) == (BATCH, v * TILE, v * TILE, 3)


def test_render_frame_np_is_a_host_array():
    env = port.make("MiniGrid-Empty-5x5-v0")
    _, state = env.reset(torch.Generator().manual_seed(0), 2, device="cpu")
    frames = TR.render_frame_np(env, state, TILE)
    assert isinstance(frames, np.ndarray) and frames.shape == (2, 40, 40, 3)
    np.testing.assert_array_equal(frames, TR.render_frame(env.params, state, TILE).numpy())
