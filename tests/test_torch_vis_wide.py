"""The port's visibility sweep at wide views, against the JAX package's
batch-first ``process_vis``, which takes any view.

The port holds each view row as one int64 bitboard (bit i = column i), so
it covers views up to 63 columns and refuses wider ones.  Each case draws
20 see-through masks from a seeded numpy generator, each cell see-through
with probability 0.8 so that light travels far, and requires the two
sweeps to be equal.  JAX runs its sweep eagerly (compiling the unrolled
sweep takes minutes at v = 33), so the 63-column case, which alone takes
about 35 s, has a file of its own (``test_torch_vis_wide_63.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu.ops.obs import process_vis

from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

MASKS = 20


def _masks(v: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((MASKS, v, v)) < 0.8


def assert_sweeps_equal(v: int) -> None:
    see = _masks(v, v)
    want = np.asarray(jax.vmap(lambda s: process_vis(s, v))(jax.numpy.asarray(see)))
    lanes_see = torch.from_numpy(see.reshape(MASKS, v * v).T.copy())
    got = tlanes._process_vis_lanes(lanes_see, v).T.reshape(MASKS, v, v).numpy()
    assert got.sum() > MASKS * v, "light reaches past the first row"
    for i in range(MASKS):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"v={v} mask {i}")


@pytest.mark.parametrize("v", [7, 31, 33, 35])
def test_wide_views_equal_jax(v):
    assert_sweeps_equal(v)


def test_views_past_63_raise():
    see = torch.ones(65 * 65, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="65"):
        tlanes._process_vis_lanes(see, 65)
