"""The port's lane-major step and observation against the JAX package's,
for one id of each hook-free family (``_torch_families.step_obs_parity``
says how).  Each case requires its lanes to truncate, or to die in lava
where the family has lava.
"""

from __future__ import annotations

import pytest
import torch

from ._torch_families import step_obs_parity

torch.set_num_threads(1)

# (id, the events it must produce)
CASES = [
    ("MiniGrid-Empty-Random-6x6-v0", ("truncated",)),
    ("MiniGrid-FourRooms-v0", ("truncated",)),
    ("MiniGrid-LavaCrossingS9N2-v0", ("lava", "truncated")),
    ("MiniGrid-LavaGapS5-v0", ("lava",)),
    ("MiniGrid-DistShift1-v0", ("lava",)),
    ("MiniGrid-LockedRoom-v0", ("truncated",)),
]


@pytest.mark.parametrize("env_id, events", CASES, ids=[c[0] for c in CASES])
def test_step_obs_bit_identical(env_id, events):
    step_obs_parity(env_id, events)
