"""The hand-written CUDA kernels against their plain versions, on a card.

These tests need a CUDA card (a kernel has no CPU mode) and skip without
one.  They import no JAX, so they also run on a machine that has only
PyTorch; from the repository root:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_on_card.py -q

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's full sizes.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey

GAMMA = 0.995


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _states(card, env_id: str, batch: int, seed: int):
    env = port.make(env_id)
    g = torch.Generator(device=card).manual_seed(seed)
    return env.generate(g, env.params, batch, card)


@pytest.mark.cuda
@pytest.mark.parametrize("max_doors", [1, 2])
@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-DoorKey-16x16-v0"])
def test_vi_kernel_equals_plain(card, env_id, max_doors):
    layouts = ttab.extract_layout(_states(card, env_id, 37, seed=0), max_doors)
    before = cuda_vi.cuda_value_iteration.launches
    got = cuda_vi.cuda_value_iteration(layouts, GAMMA, 96)
    torch.cuda.synchronize()
    assert cuda_vi.cuda_value_iteration.launches == before + 1
    want = ttab.value_iteration(layouts, GAMMA, 96)[0]
    assert (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sweeps", [0, 1, 40])
def test_key_vi_kernel_equals_plain(card, n_sweeps):
    layouts = tkey.extract_key_layout(_states(card, "MiniGrid-DoorKey-6x6-v0", 19, seed=1), 1)
    before = cuda_vi.cuda_key_value_iteration.launches
    got = cuda_vi.cuda_key_value_iteration(layouts, GAMMA, n_sweeps)
    torch.cuda.synchronize()
    assert cuda_vi.cuda_key_value_iteration.launches == before + 1
    want = tkey.key_value_iteration(layouts, GAMMA, n_sweeps)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_wrappers_refuse_other_inputs(card):
    layouts = ttab.extract_layout(_states(card, "MiniGrid-DoorKey-5x5-v0", 2, seed=2), 1)
    with pytest.raises(ValueError):
        cuda_vi.cuda_value_iteration(
            dataclasses.replace(layouts, door_id=layouts.door_id.long())
        )
    with pytest.raises(ValueError, match="on cuda"):
        cuda_vi.cuda_value_iteration(
            dataclasses.replace(layouts, goal=layouts.goal.cpu())
        )
