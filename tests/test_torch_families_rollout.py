"""The port's pool-autoreset rollout against JAX ``lane_rollout``, given
JAX's pool and actions, for one id of each family with a post-step hook
that draws nothing (``_torch_families.rollout_parity`` says how)."""

from __future__ import annotations

import pytest
import torch

from ._torch_families import rollout_parity

torch.set_num_threads(1)


@pytest.mark.parametrize("env_id", [
    "MiniGrid-GoToDoor-6x6-v0",
    "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-Fetch-8x8-N3-v0",
    "MiniGrid-MemoryS9-v0",
    "MiniGrid-PutNear-8x8-N3-v0",
    "MiniGrid-RedBlueDoors-8x8-v0",
])
def test_rollout_matches_jax_given_pool_and_actions(env_id):
    rollout_parity(env_id)
