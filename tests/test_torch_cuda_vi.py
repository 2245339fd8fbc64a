"""The CUDA wrappers of ``dp/cuda_vi.py`` on the CPU.

On CPU tensors each wrapper runs its plain version, and that is held
against the JAX package's Pallas kernel in interpret mode, as
``tests/test_dp.py`` runs it: bit for bit for the restricted domain, within
atol 1e-6 for the key-position domain.  The wrapper must not count a launch
there.

The kernels themselves run only on a card (``tests/test_torch_on_card.py``);
what can be checked here is the contract between a wrapper and its kernel.
``_emulate_vi`` and ``_emulate_key_vi`` replay each ``.cu`` file's
per-state arithmetic over the byte masks the wrapper builds, and must
reproduce the plain values.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp import tabular as jtab
from minigrid_dynamicprogramming_tpu.dp import tabular_key as jkey
from minigrid_dynamicprogramming_tpu.dp.pallas_vi import (
    pallas_key_value_iteration,
    pallas_value_iteration,
)

from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey

torch.set_num_threads(1)

GAMMA = 0.995


def _states(env_id: str, batch: int, seed: int):
    """(JAX batch of states, the same states in the port)."""
    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)))(keys, env.params)
    arrays = {n: np.asarray(getattr(states, n)) for n in states.__dataclass_fields__}
    return states, from_numpy(EnvState, arrays, "cpu")


def test_cuda_vi_plain_path_matches_pallas_interpret():
    jstates, tstates = _states("MiniGrid-DoorKey-5x5-v0", 4, seed=0)
    jlay = jax.vmap(partial(jtab.extract_layout, max_doors=1))(jstates)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_value_iteration(jlay, gamma=GAMMA, n_sweeps=48)
    before = cuda_vi.cuda_value_iteration.launches
    got = cuda_vi.cuda_value_iteration(ttab.extract_layout(tstates, 1), GAMMA, 48)
    assert cuda_vi.cuda_value_iteration.launches == before  # CPU: no kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_key_vi_plain_path_matches_pallas_interpret():
    jstates, tstates = _states("MiniGrid-DoorKey-8x8-v0", 3, seed=2)
    jlay = jax.vmap(partial(jkey.extract_key_layout, max_doors=1))(jstates)
    with pltpu.force_tpu_interpret_mode():
        jv_pl = pallas_key_value_iteration(jlay, gamma=GAMMA, n_sweeps=48)
    tlay = tkey.extract_key_layout(tstates, 1)
    assert (np.asarray(jv_pl) > 0).any()
    before = cuda_vi.cuda_key_value_iteration.launches
    got = cuda_vi.cuda_key_value_iteration(tlay, GAMMA, 48)
    assert cuda_vi.cuda_key_value_iteration.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(jv_pl), rtol=0, atol=1e-6)


def _emulate_vi(layouts, gamma: float, n_sweeps: int) -> torch.Tensor:
    """``csrc/vi.cu``'s sweep over the wrapper's masks, all states at once."""
    walk, flags, slot, tog = cuda_vi.vi_masks(layouts)
    b, C, _, hw = walk.shape
    w = layouts.base_walk.shape[2]
    cell = torch.arange(hw)
    front = torch.stack([cell + 1, cell + w, cell - 1, cell - w]).clamp(0, hw - 1)
    fwd_ok = (walk == 1) & ((flags & 2) == 0)[:, None]
    pick_ok = ((flags & 4) != 0)[:, None] & (torch.arange(C) % 2 == 0)[None, :, None, None]
    safe = slot.long().clamp(min=0)
    tog_cfg = tog.gather(2, safe.reshape(b, 1, 4 * hw).expand(b, C, 4 * hw)).reshape(b, C, 4, hw)
    v = torch.zeros(b, C, 4, hw)
    for _ in range(n_sweeps):
        q = torch.maximum(v, torch.maximum(v.roll(1, 2), v.roll(-1, 2)))
        ahead = v.gather(3, front[None, None].expand(b, C, 4, hw))
        q = torch.where(fwd_ok, torch.maximum(q, ahead), q)
        flipped = v.reshape(b, C // 2, 2, 4, hw).flip(2).reshape(b, C, 4, hw)
        q = torch.where(pick_ok, torch.maximum(q, flipped), q)
        toggled = v.gather(1, tog_cfg.long())
        q = torch.where((slot >= 0)[:, None], torch.maximum(q, toggled), q)
        v = torch.where(((flags & 1) != 0)[:, None], 1.0, gamma * q)
    return v.reshape(layouts.base_walk.shape[:1] + (C, 4) + layouts.base_walk.shape[1:])


def _emulate_key_vi(layouts, gamma: float, n_sweeps: int) -> torch.Tensor:
    """``csrc/key_vi.cu``'s sweep over the wrapper's masks."""
    cell_flags, cfg_flags, door_bit = cuda_vi.key_vi_masks(layouts)
    b, C, _, hw = cfg_flags.shape
    h, w = layouts.base_walk.shape[1:]
    K, carried = hw + 1, hw
    cell = torch.arange(hw)
    x, y = cell % w, cell // w
    fx = torch.stack([x + 1, x, x - 1, x])
    fy = torch.stack([y, y + 1, y, y - 1])
    front = torch.where((fx >= 0) & (fx < w) & (fy >= 0) & (fy < h), fy * w + fx, -1)  # (4, HW)
    k = torch.arange(K)[:, None, None, None]  # (K, 1, 1, 1) against (C, 4, HW)
    f = cell_flags[:, None, None]  # (B, 1, 1, 4, HW)
    g = cfg_flags[:, None]  # (B, 1, C, 4, HW)
    at_front = k == front  # (K, 1, 4, HW)
    fwd_ok = ((g & 1) != 0) & ~at_front & ((f & 2) == 0)
    drop_ok = (k == carried) & ((f & 8) != 0)
    tog_ok = ((g & 2) != 0) | (((g & 4) != 0) & (k == carried))
    terminal = ((f & 1) != 0) | (((f & 4) != 0) & (k != carried))
    safe_front = front.clamp(min=0)
    new_cfg = torch.arange(C)[None, :, None, None] | door_bit[:, None].long()  # (B, C, 4, HW)
    v = torch.zeros(b, K, C, 4, hw)
    for _ in range(n_sweeps):
        q = torch.maximum(v, torch.maximum(v.roll(1, 3), v.roll(-1, 3)))
        ahead = v.gather(4, safe_front.expand(b, K, C, 4, hw))
        q = torch.where(fwd_ok, torch.maximum(q, ahead), q)
        q = torch.where(at_front, torch.maximum(q, v[:, carried:]), q)
        dropped = v.permute(0, 2, 3, 4, 1).gather(4, safe_front[None, None, :, :, None].expand(b, C, 4, hw, 1))
        q = torch.where(drop_ok, torch.maximum(q, dropped.permute(0, 4, 1, 2, 3)), q)
        toggled = v.gather(2, new_cfg[:, None].expand(b, K, C, 4, hw))
        q = torch.where(tog_ok, torch.maximum(q, toggled), q)
        v = torch.where(terminal, 1.0, gamma * q)
    return v.reshape(b, K, C, 4, h, w)


@pytest.mark.parametrize("max_doors", [1, 2])
def test_vi_kernel_contract_reproduces_plain(max_doors):
    _, tstates = _states("MiniGrid-DoorKey-8x8-v0", 4, seed=3)
    layouts = ttab.extract_layout(tstates, max_doors)
    want = ttab.value_iteration(layouts, GAMMA, 64)[0]
    assert (want > 0).any()
    torch.testing.assert_close(_emulate_vi(layouts, GAMMA, 64), want, rtol=0, atol=0)


def test_key_vi_kernel_contract_reproduces_plain():
    _, tstates = _states("MiniGrid-DoorKey-6x6-v0", 2, seed=4)
    layouts = tkey.extract_key_layout(tstates, 1)
    want = tkey.key_value_iteration(layouts, GAMMA, 40)[0]
    assert (want > 0).any()
    torch.testing.assert_close(_emulate_key_vi(layouts, GAMMA, 40), want, rtol=0, atol=1e-6)


def test_wrappers_check_their_inputs():
    _, tstates = _states("MiniGrid-DoorKey-5x5-v0", 2, seed=5)
    layouts = ttab.extract_layout(tstates, 1)
    with pytest.raises(ValueError, match="door_id"):
        cuda_vi.cuda_value_iteration(
            dataclasses.replace(layouts, door_id=layouts.door_id.long()), GAMMA, 4
        )
    with pytest.raises(ValueError, match="key_pos"):
        cuda_vi.cuda_value_iteration(
            dataclasses.replace(layouts, key_pos=layouts.key_pos[:1]), GAMMA, 4
        )
    with pytest.raises(ValueError, match="n_sweeps"):
        cuda_vi.cuda_value_iteration(layouts, GAMMA, -1)
    key_layouts = tkey.extract_key_layout(tstates, 1)
    with pytest.raises(ValueError, match="base_empty"):
        cuda_vi.cuda_key_value_iteration(
            dataclasses.replace(key_layouts, base_empty=key_layouts.base_empty.to(torch.uint8)),
            GAMMA, 4,
        )


def test_work_counts():
    """The bound's operation counts lie between the always-present
    candidates and every candidate at every state."""
    _, tstates = _states("MiniGrid-DoorKey-8x8-v0", 3, seed=6)
    for layouts, work, states, n_opt in [
        (ttab.extract_layout(tstates, 1), cuda_vi.vi_work, 3 * 6 * 4 * 64, 3),
        (tkey.extract_key_layout(tstates, 1), cuda_vi.key_vi_work, 3 * 65 * 2 * 4 * 64, 4),
    ]:
        nbytes, ops = work(layouts, 10)
        assert 10 * states * 3 < ops < 10 * states * (3 + n_opt)
        assert nbytes > states * 4
