"""The port's pool-autoreset rollout against JAX ``lane_rollout``, given
JAX's pool and actions, for the hook-free families on 19x19 grids
(``_torch_families.rollout_parity`` says how)."""

from __future__ import annotations

import pytest
import torch

from ._torch_families import rollout_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id", ["MiniGrid-FourRooms-v0", "MiniGrid-LockedRoom-v0"])
def test_rollout_matches_jax_given_pool_and_actions(env_id):
    rollout_parity(env_id)
