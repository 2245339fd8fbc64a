"""The port's scaling harness on the CPU: groups of one and two gloo ranks
(JAX's ``tests/test_scaling.py`` assertions).  The efficiency of two CPU
processes is noise, not a device metric: the test holds only that it is
finite and positive."""

from __future__ import annotations

import numpy as np
import pytest

from minigrid_dynamicprogramming_tpu_torch.parallel.scaling import measure_scaling

from ._torch_dist import GROUP_TIMEOUT_S


def test_measure_scaling_reports_points():
    pts = measure_scaling(
        "MiniGrid-Empty-5x5-v0",
        per_device_batch=64,
        horizon=32,
        device_counts=[1, 2],
        warmup=1,
        iters=1,
        device="cpu",
        timeout_s=GROUP_TIMEOUT_S,
    )
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[0].batch == 64 and pts[1].batch == 128
    for p in pts:
        assert p.steps_per_s > 0
    assert pts[0].efficiency == 1.0
    assert np.isfinite(pts[1].efficiency) and pts[1].efficiency > 0


def test_measure_scaling_needs_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_scaling("MiniGrid-Empty-5x5-v0")
    with pytest.raises(ValueError, match="device"):
        measure_scaling("MiniGrid-Empty-5x5-v0", device="tpu")
