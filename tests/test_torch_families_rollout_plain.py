"""The port's pool-autoreset rollout against JAX ``lane_rollout``, given
JAX's pool and actions, for one id of each hook-free family on grids of
at most 9x9 (``_torch_families.rollout_parity`` says how; the 19x19
families are in ``test_torch_families_rollout_rooms.py``)."""

from __future__ import annotations

import pytest
import torch

from ._torch_families import rollout_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id", [
    "MiniGrid-Empty-8x8-v0",
    "MiniGrid-SimpleCrossingS9N1-v0",
    "MiniGrid-LavaGapS7-v0",
    "MiniGrid-DistShift2-v0",
])
def test_rollout_matches_jax_given_pool_and_actions(env_id):
    rollout_parity(env_id)
