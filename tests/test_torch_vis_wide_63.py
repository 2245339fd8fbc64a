"""The port's visibility sweep at its widest view, 63 columns, against
the JAX package's ``process_vis`` (see ``test_torch_vis_wide.py``)."""

from __future__ import annotations

from .test_torch_vis_wide import assert_sweeps_equal


def test_widest_view_equals_jax():
    assert_sweeps_equal(63)
