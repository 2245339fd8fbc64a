"""The hand-written CUDA kernels against their plain versions, on a card.

These tests need a CUDA card (a kernel has no CPU mode) and skip without
one.  They import no JAX, so they also run on a machine that has only
PyTorch; from the repository root:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_on_card.py -q

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's full sizes.  The restricted-domain kernel is held here at
each way it keeps walkability: a 32-bit mask (one and two door slots), a
64-bit one (three) and bytes in shared memory (four).  The key-domain
kernel has two routes, chosen from the shape (``cuda_vi.key_vi_route``):
the cluster route is held here at DoorKey-6x6 (a cluster of 2) and
DoorKey-8x8 (clusters of 4 and 8, and every cluster size the kernel
takes), the global route at DoorKey-16x16; each case checks which route's
launch count moved.  The restricted-domain kernel's instance for grid
sizes given at run time (and its lava flag) is held on LavaGapS7 (7x7),
LavaCrossingS9N2 (9x9) and FourRooms (19x19, 361 threads a block; at two
door slots 208,080 bytes of shared memory), and a hook-free and a
post-step family roll out equal on the card and on the CPU, as do two
RoomGrid families and MultiRoom.  The key-domain kernel also runs on the
layouts it was written for: KeyCorridorS3R2 at six door slots (C = 64, the
global route) and ObstructedMaze-1Dl (11 wide and 6 high, the cluster
route's instance for sizes given at run time).  Three BabyAI ids roll out
equal on the card and on the CPU, the verifier included, and the two-key
domain (plain PyTorch, no kernel) gives the same V on both.
``Environment.step`` gives the same on both on DoorKey-8x8, and PPO
updates on the card with finite metrics.  The renderer (tiles 8 and 32)
and a wrapper stack with a count table give the same frames, observations
and states on both.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_DOOR, OBJ_LAVA
from minigrid_dynamicprogramming_tpu_torch.dp import cuda_vi
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.dp import tabular_key as tkey
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

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
@pytest.mark.parametrize("env_id,max_doors", [
    ("MiniGrid-DoorKey-5x5-v0", 1),
    ("MiniGrid-DoorKey-5x5-v0", 2),
    ("MiniGrid-DoorKey-16x16-v0", 1),
    ("MiniGrid-DoorKey-16x16-v0", 2),
    ("MiniGrid-DoorKey-5x5-v0", 3),
    ("MiniGrid-DoorKey-8x8-v0", 3),
    ("MiniGrid-DoorKey-5x5-v0", 4),
    ("MiniGrid-DoorKey-6x6-v0", 4),
])
def test_vi_kernel_equals_plain(card, env_id, max_doors):
    """Walkability as a 32-bit mask (one and two door slots), a 64-bit one
    (three, C = 54) and bytes in shared memory (four, C = 162; at 6x6 one
    layout a block, 212,544 bytes)."""
    layouts = ttab.extract_layout(_states(card, env_id, 37, seed=0), max_doors)
    C = 2 * 3**max_doors
    assert cuda_vi.vi_walk_bits(C) == {1: 32, 2: 32, 3: 64, 4: 0}[max_doors]
    before = cuda_vi.cuda_value_iteration.launches
    got = cuda_vi.cuda_value_iteration(layouts, GAMMA, 96)
    torch.cuda.synchronize()
    assert cuda_vi.cuda_value_iteration.launches == before + 1
    want = ttab.value_iteration(layouts, GAMMA, 96)[0]
    assert (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_doors", [1, 2])
@pytest.mark.parametrize("env_id", [
    "MiniGrid-LavaGapS7-v0", "MiniGrid-LavaCrossingS9N2-v0", "MiniGrid-FourRooms-v0",
])
def test_vi_kernel_run_time_size_equals_plain(card, env_id, max_doors):
    """Grid sizes with no compile-time instance, lava in the layouts."""
    layouts = ttab.extract_layout(_states(card, env_id, 13, seed=6), max_doors)
    assert layouts.lava.any() or env_id == "MiniGrid-FourRooms-v0"
    before = cuda_vi.cuda_value_iteration.launches
    got = cuda_vi.cuda_value_iteration(layouts, GAMMA, 64)
    torch.cuda.synchronize()
    assert cuda_vi.cuda_value_iteration.launches == before + 1
    want = ttab.value_iteration(layouts, GAMMA, 64)[0]
    assert (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", [
    "MiniGrid-LavaGapS7-v0", "MiniGrid-PutNear-8x8-N3-v0", "MiniGrid-KeyCorridorS3R2-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0", "MiniGrid-MultiRoom-N2-S4-v0",
    "BabyAI-GoToLocal-v0", "BabyAI-BossLevel-v0", "BabyAI-PutNextS5N2Carrying-v0",
])
def test_family_rollout_card_equals_cpu(card, env_id):
    """The same pool and actions step alike on the card and on the CPU,
    the path the CPU tests hold against JAX.  The step limit is cut to 64,
    so that every lane crosses an episode boundary (a BabyAI id whose
    limit is set per episode ends its episodes through the verifier)."""
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=min(env.params.max_steps, 64))
    b, horizon, rounds = 128, 96, 3
    g = torch.Generator(device=card).manual_seed(8)
    pool = tlanes._lane_pool(env, g, b, "pool", rounds, card)
    acts = torch.randint(0, env.action_dim, (horizon, b), generator=g, device=card,
                         dtype=torch.int32)
    on_card = tlanes._lane_scan(env, None, pool, b, horizon, "pool", rounds, acts)
    cpu_pool = tlanes.LaneState(**{n: getattr(pool, n).cpu() for n in tlanes._FIELDS})
    on_cpu = tlanes._lane_scan(env, None, cpu_pool, b, horizon, "pool", rounds, acts.cpu())
    assert int(on_cpu.episodes) > 0
    for n in tlanes._FIELDS:
        assert torch.equal(getattr(on_card.final_state, n).cpu(), getattr(on_cpu.final_state, n)), n
    assert torch.equal(on_card.resets_per_env.cpu(), on_cpu.resets_per_env)
    assert int(on_card.episodes) == int(on_cpu.episodes)
    assert int(on_card.obs_checksum) == int(on_cpu.obs_checksum)


def _key_vi_on_route(layouts, n_sweeps: int, route):
    """The wrapper's V, after checking that it took ``route`` (a
    ``key_vi_route`` result) and counted one launch there."""
    b, h, w = layouts.base_walk.shape
    assert cuda_vi.key_vi_route(h * w + 1, 1 << layouts.n_doors, h * w) == route
    before = dict(cuda_vi.cuda_key_value_iteration.route_launches)
    total = cuda_vi.cuda_key_value_iteration.launches
    got = cuda_vi.cuda_key_value_iteration(layouts, GAMMA, n_sweeps)
    torch.cuda.synchronize()
    assert cuda_vi.cuda_key_value_iteration.launches == total + 1
    after = cuda_vi.cuda_key_value_iteration.route_launches
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route[0]) for r in cuda_vi.ROUTES
    }
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_sweeps", [0, 1, 40])
def test_key_vi_kernel_equals_plain(card, n_sweeps):
    layouts = tkey.extract_key_layout(_states(card, "MiniGrid-DoorKey-6x6-v0", 19, seed=1), 1)
    got = _key_vi_on_route(layouts, n_sweeps, ("cluster", 2))
    want = tkey.key_value_iteration(layouts, GAMMA, n_sweeps)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("max_doors,n,closed", [(1, 4, False), (2, 8, False), (1, 4, True)])
def test_key_vi_cluster_route_8x8(card, max_doors, n, closed):
    """Closed doors (in place of DoorKey's locked one) run the toggle pass
    of every key row."""
    layouts = tkey.extract_key_layout(
        _states(card, "MiniGrid-DoorKey-8x8-v0", 23, seed=3), max_doors
    )
    if closed:
        layouts = dataclasses.replace(layouts, door_init=torch.ones_like(layouts.door_init))
    got = _key_vi_on_route(layouts, 48, ("cluster", n))
    want = tkey.key_value_iteration(layouts, GAMMA, 48)[0]
    assert (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_key_vi_global_route_16x16(card):
    layouts = tkey.extract_key_layout(_states(card, "MiniGrid-DoorKey-16x16-v0", 3, seed=4), 1)
    got = _key_vi_on_route(layouts, 12, ("global", 0))
    want = tkey.key_value_iteration(layouts, GAMMA, 12)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,max_doors,route", [
    ("MiniGrid-KeyCorridorS3R2-v0", 6, ("global", 0)),
    ("MiniGrid-ObstructedMaze-1Dl-v0", 1, ("cluster", 4)),
])
def test_key_vi_families_equal_plain(card, env_id, max_doors, route):
    """The target named by aux slots 0-1, as the families' hook pays it."""
    states = _states(card, env_id, 11, seed=7)
    assert int((states.grid_obj == OBJ_DOOR).sum(dim=(1, 2)).max()) <= max_doors
    layouts = tkey.extract_key_layout(states, max_doors, states.aux[:, 0], states.aux[:, 1])
    got = _key_vi_on_route(layouts, 64, route)
    want = tkey.key_vi_values(layouts, GAMMA, 64)
    assert (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_key_vi_every_cluster_size_agrees(card):
    """Clusters of 2, 4 and 8 CTAs, and the global route, each match the
    plain version at DoorKey-8x8: the row split and the remote reads do
    not change the result."""
    layouts = tkey.extract_key_layout(_states(card, "MiniGrid-DoorKey-8x8-v0", 9, seed=5), 1)
    masks = cuda_vi.key_vi_masks(layouts)
    shape = (9, 65, 2, 4, 8, 8)
    want = tkey.key_vi_values(layouts, GAMMA, 33)
    got = cuda_vi._key_vi_kernel_global(masks, GAMMA, 33, shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for n in (2, 4, 8):
        got = cuda_vi._key_vi_kernel_cluster(masks, GAMMA, 33, shape, n)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert cuda_vi.key_vi_active_clusters(2, 8, 8, n) > 0


@pytest.mark.cuda
def test_launch_plans_match_the_c_side(card):
    """The Python mirrors of each kernel's plan, which the CPU tests check,
    are the plans the .cu files compute."""
    import ctypes

    from minigrid_dynamicprogramming_tpu_torch import _kernels

    vi, key = _kernels.library("vi"), _kernels.library("key_vi")
    for f in (vi.vi_shared_bytes, key.key_vi_cluster_shared_bytes):
        f.restype = ctypes.c_size_t
    for hw in (25, 36, 64, 256, 1024):
        for C, D in ((2, 0), (6, 1), (18, 2), (54, 3), (162, 4)):
            lpb = cuda_vi.vi_plan(C, D, hw)[0]
            assert vi.vi_shared_bytes(C, D, hw, lpb) == cuda_vi.vi_shared_bytes(C, D, hw, lpb)
    for hw in (25, 36, 64, 256):
        for C in (2, 4):
            for n in (1, 2, 4, 8):
                assert key.key_vi_cluster_shared_bytes(C, hw, n) == (
                    cuda_vi.key_vi_cluster_shared_bytes(C, hw, n)
                )


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


@pytest.mark.cuda
def test_twokey_values_card_equal_cpu(card):
    """The two-key domain on two UnlockToUnlock layouts (16x6, two doors),
    the target the ball: V on the card within 1e-6 of V on the CPU."""
    from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_BALL
    from minigrid_dynamicprogramming_tpu_torch.dp import tabular_twokey as ttk

    states = _states(card, "BabyAI-UnlockToUnlock-v0", 2, seed=9)
    balls = (states.grid_obj == OBJ_BALL).reshape(2, -1)
    color = states.grid_color.reshape(2, -1).gather(1, balls.to(torch.int8).argmax(1, True))[:, 0]
    layouts = ttk.extract_twokey_layout(states, 2, OBJ_BALL, color)
    got = ttk.twokey_vi_values(layouts, GAMMA, 16)
    cpu = ttk.TwoKeyLayout(**{f.name: getattr(layouts, f.name).cpu() for f in dataclasses.fields(layouts)})
    want = ttk.twokey_vi_values(cpu, GAMMA, 16)
    assert (want > 0).any()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_env_step_card_equals_cpu(card):
    """``Environment.step`` on DoorKey-8x8 on the card and on the CPU from
    the same states with the same actions: equal observations, states,
    rewards and flags at every step."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    obs, state = env.reset(torch.Generator(device=card).manual_seed(4), 256, device=card)
    cpu = port.EnvState(**{f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)})
    g = torch.Generator().manual_seed(5)
    for _ in range(48):
        act = torch.randint(0, 7, (256,), generator=g)
        got = env.step(state, act.to(card))
        want = env.step(cpu, act)
        state, cpu = got[1], want[1]
        for k in want[0]:
            assert torch.equal(got[0][k].cpu(), want[0][k]), k
        for f in dataclasses.fields(cpu):
            assert torch.equal(getattr(state, f.name).cpu(), getattr(cpu, f.name)), f.name
        for a, b in zip(got[2:5], want[2:5]):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_ppo_update_on_card_is_finite(card):
    """Two PPO updates on the card (bf16 model) on BabyAI-GoToRedBallGrey:
    finite metrics, parameters on the card and changed."""
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    ppo = PPO(port.make("BabyAI-GoToRedBallGrey-v0"),
              PPOConfig(num_envs=256, rollout_len=16, num_minibatches=4))
    ts = ppo.init(0)
    before = [p.detach().clone() for p in ts.model.parameters()]
    for _ in range(2):
        ts, m = ppo.update(ts)
    assert all(torch.isfinite(x).all() for x in m), m
    after = list(ts.model.parameters())
    assert all(p.device.type == "cuda" for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def _to(x, device):
    """A copy of an ``EnvState`` or ``WrapperState`` (nested) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(**{f.name: _to(getattr(x, f.name), device) for f in dataclasses.fields(x)})


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "BabyAI-GoToLocal-v0"])
def test_render_card_equals_cpu(card, env_id):
    """``render_frame`` (with and without highlight), ``render_pov`` and
    ``view_highlight_mask`` of 256 states a few steps into their episodes:
    bit for bit equal on the card and on the CPU; the tile table lives on
    the card."""
    from minigrid_dynamicprogramming_tpu_torch import render as R
    from minigrid_dynamicprogramming_tpu_torch.render.tiles import tile_lut_tensor

    env = port.make(env_id)
    g = torch.Generator(device=card).manual_seed(6)
    _, state = env.reset(g, 256, device=card)
    for _ in range(3):
        state = env.step(state, torch.randint(0, 7, (256,), generator=g, device=card))[1]
    cpu = _to(state, "cpu")
    for tile in (8, 32):
        for got, want in (
            (R.render_frame(env.params, state, tile), R.render_frame(env.params, cpu, tile)),
            (R.render_frame(env.params, state, tile, False), R.render_frame(env.params, cpu, tile, False)),
            (R.render_pov(env.params, state, tile), R.render_pov(env.params, cpu, tile)),
        ):
            assert got.device.type == card.type and got.dtype == torch.uint8
            assert torch.equal(got.cpu(), want)
        assert tile_lut_tensor(tile, state.grid_obj.device).device.type == card.type
    mask = R.view_highlight_mask(env.params, state)
    assert torch.equal(mask.cpu(), R.view_highlight_mask(env.params, cpu)) and mask.any()


@pytest.mark.cuda
def test_wrapper_stack_card_equals_cpu(card):
    """NoDeath over PositionBonus under RGBImgPartialObs on
    LavaCrossingS9N1: observations, states, count tables and flags equal on
    the card and on the CPU at every step, rewards within 1e-5."""
    from minigrid_dynamicprogramming_tpu_torch import wrappers as W

    env = W.RGBImgPartialObsWrapper(
        W.NoDeath(W.PositionBonus(port.make("MiniGrid-LavaCrossingS9N1-v0")), ("lava",)), 8
    )
    obs, state = env.reset(torch.Generator(device=card).manual_seed(7), 256, device=card)
    cpu = _to(state, "cpu")
    g = torch.Generator().manual_seed(8)
    deaths = 0
    for _ in range(24):
        act = torch.randint(0, 7, (256,), generator=g)
        got, want = env.step(state, act.to(card)), env.step(cpu, act)
        state, cpu = got[1], want[1]
        assert torch.equal(got[0]["image"].cpu(), want[0]["image"])
        assert torch.equal(state.data.cpu(), cpu.data)
        for f in dataclasses.fields(cpu.inner):
            assert torch.equal(getattr(state.inner, f.name).cpu(), getattr(cpu.inner, f.name)), f.name
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=0, atol=1e-5)
        assert torch.equal(got[3].cpu(), want[3]) and torch.equal(got[4].cpu(), want[4])
        core = cpu.inner
        pos = core.agent_pos.long()
        deaths += int((core.grid_obj[torch.arange(256), pos[:, 1], pos[:, 0]] == OBJ_LAVA).sum())
    assert deaths > 0  # agents on lava, their deaths cancelled
