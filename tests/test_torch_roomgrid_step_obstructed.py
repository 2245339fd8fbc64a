"""The port's lane-major step, post-step hook and observation against the
JAX package's on the 13 ObstructedMaze ids, as
``test_torch_roomgrid_step.py`` holds the other RoomGrid ids: bit for bit,
the reward within 1e-6, each case with a pickup of the target."""

from __future__ import annotations

import pytest
import torch

from ._torch_families import step_obs_parity
from .test_torch_roomgrid_step import CASES

torch.set_num_threads(1)

HERE = [c for c in CASES if "ObstructedMaze" in c[0]]


@pytest.mark.parametrize("env_id, events, prep", HERE, ids=[c[0] for c in HERE])
def test_step_obs_bit_identical(env_id, events, prep):
    step_obs_parity(env_id, events, prep)
