"""The port's BabyAI step, verifier hook included, and observation against
the JAX package's on twin layouts (``_torch_babyai.verifier_parity``): one
id of each instruction profile a fixed-shape level registers, and the
``BABYAI_DONE_ACTIONS`` mode, bit for bit, the reward within 1e-6.

The layouts are set up so that a random walk meets the verifier's events:
the agent faces an object its instruction names (``face_target``), or
carries the object PutNext moves and faces a cell next to the fixed one
(``carry_to_fixed``).  Each case must show the events listed: successes;
failures where the instruction is strict or a `done` comes unmatched; a
clause or leaf done before the mission (``partial``) for sequences.  The
profiles of the generic sampler are in ``test_torch_babyai_step_levelgen.py``.
"""

from __future__ import annotations

import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port

from ._torch_babyai import carry_to_fixed, face_target, verifier_parity

torch.set_num_threads(1)

# (id, its profile, the events it must show, the set-up)
CASES = [
    ("BabyAI-GoToRedBallGrey-v0", "single goto", ("success",), face_target),
    ("BabyAI-OpenRedDoor-v0", "single open", ("success",), face_target),
    ("BabyAI-PickupDistDebug-v0", "single pickup, strict", ("success", "failure"), face_target),
    ("BabyAI-PutNextS5N2Carrying-v0", "single putnext, start_carrying", ("success",), carry_to_fixed),
    ("BabyAI-ActionObjDoor-v0", "single goto/open/pickup", ("success",), face_target),
    ("BabyAI-OpenRedBlueDoorsDebug-v0", "before open/open, strict",
     ("partial", "failure"), face_target),
    ("BabyAI-OpenDoorsOrderN2Debug-v0", "single/before/after open/open, strict",
     ("success", "failure", "partial"), face_target),
    ("BabyAI-MoveTwoAcrossS5N2-v0", "before putnext/putnext", ("partial",), carry_to_fixed),
]


@pytest.mark.parametrize("env_id, profile, events, prep", CASES, ids=[c[0] for c in CASES])
def test_verifier_step_bit_identical(env_id, profile, events, prep):
    verifier_parity(env_id, events, prep)


@pytest.mark.parametrize("env_id", ["BabyAI-GoToRedBallGrey-v0", "BabyAI-PickupDistDebug-v0"])
def test_done_actions_mode_bit_identical(monkeypatch, env_id):
    """With BABYAI_DONE_ACTIONS set when the id is made, instructions end
    only on `done`: a success after a matching step, else a failure."""
    monkeypatch.setenv("BABYAI_DONE_ACTIONS", "1")
    assert mgtpu.make(env_id).params.opt("done_actions") is True
    assert port.make(env_id).params.opt("done_actions") is True
    verifier_parity(env_id, ("success", "failure"), face_target)


@pytest.mark.parametrize("dx,dy", [(0, -1), (0, 1), (-1, 0), (1, 0), (2, -3)])
def test_cell_helpers_equal_jax(dx, dy):
    """``ops/agnostic.py``'s cell helpers on lane-major planes of a grid
    wider than high (PutNext, 9x5) against JAX's: a shift drops what leaves
    the grid, never wrapping it onto the opposite edge or the next row; any
    and sum run over the cell axis alone."""
    import jax.numpy as jnp
    import numpy as np

    from minigrid_dynamicprogramming_tpu.core.state import EnvState as JState
    from minigrid_dynamicprogramming_tpu.ops import agnostic as JAG
    from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

    from minigrid_dynamicprogramming_tpu_torch.ops import agnostic as AG

    from ._torch_babyai import twin_batch

    env_id, batch = "BabyAI-PutNextS5N2-v0", 8
    jenv, tenv = mgtpu.make(env_id), port.make(env_id)
    arrays = twin_batch(env_id, range(batch))
    jls = jlanes.to_lanes(JState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                 rng=jnp.zeros((batch, 2), jnp.uint32)))
    h, w = tenv.params.height, tenv.params.width
    assert w > h
    rng = np.random.default_rng([dx + 5, dy + 5])
    mask = rng.random((h * w, batch)) < 0.3
    ints = rng.integers(0, 5, (h * w, batch)).astype(np.int32)
    got = AG.shift_cells(tenv.params, None, torch.from_numpy(mask), dx, dy).numpy()
    want = np.asarray(JAG.shift_cells(jenv.params, jls, jnp.asarray(mask), dx, dy))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == mask.reshape(h, w, batch)[
        max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)
    ].sum()
    np.testing.assert_array_equal(
        AG.reduce_any_cells(tenv.params, None, torch.from_numpy(got)).numpy(),
        np.asarray(JAG.reduce_any_cells(jenv.params, jls, jnp.asarray(want))),
    )
    np.testing.assert_array_equal(
        AG.reduce_sum_cells(tenv.params, None, torch.from_numpy(ints)).numpy(),
        np.asarray(JAG.reduce_sum_cells(jenv.params, jls, jnp.asarray(ints))),
    )
