"""The rollout step's observation checksum on the CPU.

On a card ``parallel/lanes.py:obs_checksum_lanes`` is one launch of
``csrc/obs.cu`` (held against the plain path by the on-card tests); on
the CPU it is the plain ``obs_lanes`` and its sum, looked up by the
module's name, so a fault planted there reaches the rollout's step.
"""

from __future__ import annotations

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

B = 16


def _lanes(env_id: str, seed: int = 0):
    env = port.make(env_id)
    g = torch.Generator().manual_seed(seed)
    return env, tlanes.to_lanes(env.generate(g, env.params, B, "cpu"))


def _launches() -> dict:
    return {k: v for k, v in profiling.counters().items() if k.startswith("obs.launches")}


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Empty-8x8-v0"])
def test_cpu_wrapper_adds_the_plain_checksum(env_id):
    """On CPU tensors the wrapper adds the plain path's checksum into the
    slot it is given, leaves the others, and counts no launch."""
    env, ls = _lanes(env_id)
    obj, color, obj_state, vis = tlanes.obs_lanes(env.params, ls)
    want = int(((obj.to(torch.int64) + color + obj_state) * vis).sum())
    assert want > 0
    out = torch.full((3,), 7, dtype=torch.int64)
    before = _launches()
    tlanes.obs_checksum_lanes(env.params, ls, out, torch.tensor([2]))
    assert out.tolist() == [7, 7, 7 + want]
    assert _launches() == before


def test_cpu_step_reaches_obs_lanes(monkeypatch):
    """``_Scan.step`` on the CPU reads the observation through
    ``lanes.obs_lanes``: one more at every lane's own cell, which is
    always in view, adds one a lane to the step's checksum."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    real = tlanes.obs_lanes
    calls = []

    def altered(params, ls):
        calls.append(ls.agent_x.shape[0])
        obj, color, state, vis = real(params, ls)
        v = params.agent_view_size
        obj = obj.clone()
        obj[(v - 1) * v + v // 2] += 1
        return obj, color, state, vis

    def checksum():
        g = torch.Generator().manual_seed(3)
        pool = tlanes.lane_pool(env, g, B, "pool", 2, "cpu")
        scan = tlanes._Scan(env, g, pool, B, 1, "pool", 2, None)
        scan.step(scan.carry)
        return scan.carry.checksums

    plain = checksum()
    monkeypatch.setattr(tlanes, "obs_lanes", altered)
    planted = checksum()
    assert calls == [B]
    assert int(planted[0] - plain[0]) == B


@pytest.mark.parametrize("view,instance", [(3, "vrt"), (5, "vrt"), (7, "v7"), (9, "vrt"),
                                           (63, "vrt")])
def test_obs_instance_from_the_view(view, instance):
    """The kernel's instance comes from the view's width alone: the
    unrolled one at 7, the run-time one otherwise."""
    assert tlanes.obs_instance(view) == instance
