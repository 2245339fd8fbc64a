"""The port's lane-major step, post-step hooks included, and observation
against the JAX package's, for one id of each family whose hook rewrites
reward or termination without drawing (``_torch_families.step_obs_parity``
says how).  Each case requires the event its hook exists for: a GoToDoor
``done`` reward, a GoToObject one, a Fetch target pickup, Memory's success
and failure squares, a PutNear drop next to the target, a RedBlueDoors
wrong-order termination.
"""

from __future__ import annotations

import pytest
import torch

from ._torch_families import step_obs_parity

torch.set_num_threads(1)

# (id, the events its hook must produce)
CASES = [
    ("MiniGrid-GoToDoor-5x5-v0", ("reward",)),
    ("MiniGrid-GoToObject-6x6-N2-v0", ("reward",)),
    ("MiniGrid-Fetch-5x5-N2-v0", ("reward",)),
    ("MiniGrid-MemoryS7-v0", ("reward", "memory_fail")),
    ("MiniGrid-PutNear-6x6-N2-v0", ("reward",)),
    ("MiniGrid-RedBlueDoors-6x6-v0", ("lose",)),
]


@pytest.mark.parametrize("env_id, events", CASES, ids=[c[0] for c in CASES])
def test_step_obs_bit_identical(env_id, events):
    step_obs_parity(env_id, events)
