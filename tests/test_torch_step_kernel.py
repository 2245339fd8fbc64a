"""Which step a rollout takes, checked on the CPU.

On a CUDA device a family with no hook steps through one hand-written
kernel (``csrc/step.cu``: the transition, the autoreset and the write-back
in place); hooked families, every BabyAI id and any CPU device step through
the plain ``step_lanes_env`` and the autoreset select
(``parallel/lanes.py:step_path``).  The choice reads the env record and the
device alone, so it is held here for every registered id.  The kernel
itself runs only on a card (``tests/test_torch_on_card.py``, ``-k step``);
here its wrapper refuses the CPU before it loads anything, and its
argument record keeps the layout of ``csrc/step.cu``'s ``StepArgs``.
"""

from __future__ import annotations

import ctypes

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch import registry
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

# The MiniGrid families with no action map, pre-step or post-step hook.
KERNEL_FAMILIES = frozenset({
    "empty", "doorkey", "fourrooms", "crossing", "distshift", "lavagap", "lockedroom",
    "multiroom", "playground",
})


@pytest.mark.parametrize("env_id", port.registered_ids())
def test_step_path_from_the_env_record(env_id):
    """The kernel for an unhooked MiniGrid family on a card; the plain step
    for every hooked family, every BabyAI id and on the CPU."""
    env = port.make(env_id)
    kernel = env_id.startswith("MiniGrid-") and registry.family(env_id) in KERNEL_FAMILIES
    assert tlanes.step_path(env, torch.device("cuda")) == ("kernel" if kernel else "plain")
    assert tlanes.step_path(env, torch.device("cuda", 0)) == ("kernel" if kernel else "plain")
    assert tlanes.step_path(env, torch.device("cpu")) == "plain"


@pytest.mark.parametrize("autoreset", ["pool", "cached", "regen"])
def test_cpu_rollout_takes_the_plain_step(autoreset):
    """A rollout on the CPU of a family that takes the kernel on a card
    steps through the plain step, once a step, and launches nothing."""
    env = port.make("MiniGrid-DoorKey-5x5-v0")
    horizon = 3
    plain, kernel = profiling.counter("lanes.plain_steps"), profiling.counter(
        "lanes.step_kernel.launches")
    res = tlanes.lane_rollout(env, torch.Generator().manual_seed(0), 8, horizon, autoreset, 2,
                              device="cpu")
    assert res.steps == 8 * horizon
    assert profiling.counter("lanes.plain_steps") == plain + horizon
    assert profiling.counter("lanes.step_kernel.launches") == kernel


def test_kernel_wrapper_refuses_the_cpu():
    """The kernel's wrapper raises on lanes that are not on a card, before
    any build or launch."""
    env = port.make("MiniGrid-DoorKey-5x5-v0")
    g = torch.Generator().manual_seed(1)
    pool = tlanes.lane_pool(env, g, 4, "pool", 2, torch.device("cpu"))
    scan = tlanes._Scan(env, g, pool, 4, 2, "pool", 2, None)
    c = scan.carry
    launches = profiling.counter("lanes.step_kernel.launches")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tlanes.step_lanes_kernel(env.params, c.ls, c.reset_count, pool, 2,
                                 torch.zeros(4, dtype=torch.int32), c.t.view(1),
                                 torch.zeros(4), c.dones, c.wins, c.ends, "pool")
    with pytest.raises(ValueError, match="batch-first"):
        tlanes.step_lanes_kernel(env.params, c.ls, c.reset_count, pool, 2,
                                 torch.zeros(4, dtype=torch.int32), c.t.view(1),
                                 torch.zeros(4), c.dones, c.wins, c.ends, "regen")
    assert profiling.counter("lanes.step_kernel.launches") == launches
    assert tlanes._step_launch.cache_info().currsize == 0


def test_step_args_mirror_the_kernels_record():
    """``_StepArgs`` lays out ``csrc/step.cu``'s ``StepArgs``: two records of
    a pointer a field, in ``LaneState``'s order; seven pointers; the
    actions' row stride; nine 32-bit ints (424 bytes on a 64-bit host; the
    kernel's library reports its own size, which the loader checks)."""
    assert [name for name, _ in tlanes._Fields._fields_] == list(tlanes._FIELDS)
    names = [name for name, _ in tlanes._StepArgs._fields_]
    assert names[:9] == ["cur", "fresh", "actions", "t", "reset_count", "reward", "dones",
                         "wins", "ends"]
    assert names[9:] == ["action_row", "action_bytes", "B", "H", "W", "max_steps", "rounds",
                         "n_aux", "n_mission", "flags"]
    assert ctypes.sizeof(tlanes._StepArgs) == 2 * 20 * 8 + 7 * 8 + 8 + 9 * 4 + 4
