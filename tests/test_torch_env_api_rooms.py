"""The port's batch-first ``Environment.step`` and ``observation`` against
the JAX package's vmapped ones on the hook families of multi-object and
multi-room layouts and on BabyAI (see ``test_torch_env_api.py``)."""

from __future__ import annotations

import pytest

from .test_torch_env_api import assert_step_parity


@pytest.mark.parametrize(
    "env_id",
    [
        "MiniGrid-PutNear-6x6-N2-v0",  # post-step hook (put near)
        "MiniGrid-RedBlueDoors-6x6-v0",  # post-step hook (door order)
        "MiniGrid-KeyCorridorS3R1-v0",  # RoomGrid, post-step hook (pickup)
        "BabyAI-GoToLocal-v0",  # the BabyAI verifier
    ],
)
def test_step_equals_jax(env_id):
    assert_step_parity(env_id)
