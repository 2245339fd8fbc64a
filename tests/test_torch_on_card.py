"""The hand-written CUDA kernels against their plain versions, on a card.

These tests need a CUDA card (a kernel has no CPU mode) and skip without
one.  They import no JAX, so they also run on a machine that has only
PyTorch; from the repository root:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_on_card.py -q

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's full sizes.  The restricted-domain kernel is held here at
each way it keeps walkability: a 32-bit mask (one and two door slots), a
64-bit one (three) and bytes in shared memory (four).  The key-domain
kernel has three routes, chosen from the shape (``cuda_vi.key_vi_route``):
the cluster route is held here at DoorKey-6x6 (a cluster of 2) and
DoorKey-8x8 (clusters of 4 and 8, and every cluster size the kernel
takes), the wide route (a cluster of 16) at DoorKey-16x16 in place, with
open and closed doors and after an even and an odd number of sweeps, and
double-buffered at DoorKey-8x8, the grid route (groups of CTAs that meet
through device memory) resident at DoorKey-16x16 at two door slots,
KeyCorridorS3R3 and DoorKey-8x8 at seven, and streamed at LockedRoom and
a 16x16 grid at seven, through the wrapper and launched directly; each
case checks which route's launch count moved.  The restricted-domain kernel's instance for grid
sizes given at run time (and its lava flag) is held on LavaGapS7 (7x7),
LavaCrossingS9N2 (9x9) and FourRooms (19x19, 361 threads a block; at two
door slots 208,080 bytes of shared memory), and a hook-free and a
post-step family roll out equal on the card and on the CPU, as do two
RoomGrid families and MultiRoom.  The key-domain kernel also runs on the
layouts it was written for: KeyCorridorS3R2 at six door slots (C = 64, the
wide route) and ObstructedMaze-1Dl (11 wide and 6 high, the cluster
route's instance for sizes given at run time).  Three BabyAI ids roll out
equal on the card and on the CPU, the verifier included, and the two-key
domain (plain PyTorch, no kernel) gives the same V on both.
``Environment.step`` gives the same on both on DoorKey-8x8, and PPO
updates on the card with finite metrics.  The renderer (tiles 8 and 32)
and a wrapper stack with a count table give the same frames, observations
and states on both.  A one-rank NCCL group's sharded rollout equals the
ungrouped rollout from the same seed bit for bit, and a PPO train state
on the card survives a checkpoint round trip.  The success reward and the
greedy return on the card equal the CPU's bit for bit at every step count
of every registered step limit, and the headline bench (``bench_torch.py``)
at a small size times both kernels, B2 on its cluster route.  A rollout
on the card captures its step as one CUDA graph and replays it: it equals
the same step in a Python loop (``_lane_scan_eager``) bit for bit on
DoorKey-8x8 (both autoreset modes, drawn and given actions),
Dynamic-Obstacles-8x8 (ball moves drawn in the graph) and GoToLocal, and
leaves its generator where the loop does; a second rollout in the same
process, after another, gives the first one's result; a one-rank NCCL
group's PPO update (its learner graphed with its all-reduces) equals the
ungrouped one bit for bit.  PPO on the card
replays its collector and minibatch steps as CUDA graphs: the graphed
update's trajectory, final state, reset counts and generator equal the
eager update's (``PPO._update_eager``) bit for bit on GoToDoor,
DoorKey-5x5 and Dynamic-Obstacles-8x8, and so, with PyTorch's
deterministic algorithms, do its parameters and Adam's state after two
updates; it captures each
graph once over seven updates, again after a restored optimizer state or
another ``init``, and no learner at zero epochs.  The "regen" autoreset
runs ``generate`` inside those graphs: every registered id's generator,
captured once and replayed, equals an eager call from the same generator
state at B=64; the regen rollout (DoorKey-8x8, drawn and given actions,
Dynamic-Obstacles-8x8 and GoToLocal) and PPO's regen update equal their
eager runs bit for bit.  The rollout step's observation checksum is one
kernel on the card (``csrc/obs.cu``): it equals the plain ``obs_lanes``
sum bit for bit on stepped states of DoorKey-8x8 and 16x16 (staged in
shared memory and read from device memory), a see-through id, a BabyAI
id and views of 3, 9 and 63 columns, refuses a view of 65, and a graphed
rollout through it equals an eager one through the plain path.  The
step's transition, autoreset and write-back are one kernel on the card
for a family with no hook (``csrc/step.cu``): step by step on the same
carry it equals the plain step bit for bit (DoorKey-8x8 and 16x16,
Playground with its box planes, MultiRoom-N6, Empty-8x8; "pool",
"cached" and "regen"; drawn and given actions; every lane reset), as it
does on hand-made lanes with every kind of front cell under every
action; it counts two launches a graphed rollout (a hooked family none),
takes a rank's strided slice of a pool, and refuses other inputs.
DoorKey's generator is one kernel on the card after its five plain draws
(``csrc/doorkey_gen.cu``): at DoorKey-5x5, 6x6, 8x8 and 16x16 and 1 to
65536 layouts it equals the plain generator bit for bit from the same
generator state (DoorKey-8x8 also at 262144, the pool rollout's
launch) and leaves the generator where the plain one does; a
regen rollout launches it once for its start layouts and twice in its
capture, GoToDoor never, and it refuses other draws.
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
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

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
    before = profiling.counter("vi.launches")
    got = cuda_vi.cuda_value_iteration(layouts, GAMMA, 96)
    torch.cuda.synchronize()
    assert profiling.counter("vi.launches") == before + 1
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
    before = profiling.counter("vi.launches")
    got = cuda_vi.cuda_value_iteration(layouts, GAMMA, 64)
    torch.cuda.synchronize()
    assert profiling.counter("vi.launches") == before + 1
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
    pool = tlanes.lane_pool(env, g, b, "pool", rounds, card)
    acts = torch.randint(0, env.action_dim, (horizon, b), generator=g, device=card,
                         dtype=torch.int32)
    on_card = tlanes._lane_scan(env, None, pool, b, horizon, "pool", rounds, acts)
    on_cpu = tlanes._lane_scan(env, None, pool.map(torch.Tensor.cpu), b, horizon, "pool", rounds, acts.cpu())
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
    before = {r: profiling.counter(f"key_vi.launches.{r}") for r in cuda_vi.ROUTES}
    total = profiling.counter("key_vi.launches")
    got = cuda_vi.cuda_key_value_iteration(layouts, GAMMA, n_sweeps)
    torch.cuda.synchronize()
    assert profiling.counter("key_vi.launches") == total + 1
    after = {r: profiling.counter(f"key_vi.launches.{r}") for r in cuda_vi.ROUTES}
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


def _at_most_doors(states, doors: int):
    keep = (states.grid_obj == OBJ_DOOR).sum(dim=(1, 2)) <= doors
    return dataclasses.replace(states, **{k: v[keep] for k, v in states.__dict__.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,max_doors,batch,n_sweeps,closed,route", [
    ("MiniGrid-DoorKey-16x16-v0", 2, 13, 0, False, ("grid", 20)),
    ("MiniGrid-DoorKey-16x16-v0", 2, 13, 1, False, ("grid", 20)),
    ("MiniGrid-DoorKey-16x16-v0", 2, 13, 31, True, ("grid", 20)),
    ("MiniGrid-KeyCorridorS3R3-v0", 7, 12, 40, False, ("grid", 25)),
    ("MiniGrid-DoorKey-8x8-v0", 7, 5, 33, False, ("grid", 65)),
    ("MiniGrid-LockedRoom-v0", 6, 2, 0, False, ("grid", 128)),
    ("MiniGrid-LockedRoom-v0", 6, 2, 33, False, ("grid", 128)),
    ("MiniGrid-DoorKey-16x16-v0", 7, 1, 12, True, ("grid", 128)),
    ("MiniGrid-DoorKey-16x16-v0", 2, 3, 12, False, ("grid", 20)),
])
def test_key_vi_grid_route(card, env_id, max_doors, batch, n_sweeps, closed, route):
    """The grid route through the wrapper, resident (DoorKey-16x16 at two
    door slots, 13 layouts over 6 groups, so a group runs several in
    turn; KeyCorridorS3R3 at seven, the layouts of at most seven doors;
    DoorKey-8x8 at seven, the default max_doors, one row a CTA) and
    streamed (LockedRoom at six door slots, a 16x16 grid at seven), then
    the same kernel launched directly on the same masks."""
    states = _at_most_doors(_states(card, env_id, batch, seed=8), max_doors)
    target = (states.aux[:, 0], states.aux[:, 1]) if "KeyCorridor" in env_id else (-1, -1)
    layouts = tkey.extract_key_layout(states, max_doors, *target)
    if closed:
        layouts = dataclasses.replace(layouts, door_init=torch.ones_like(layouts.door_init))
    hw = layouts.base_walk.shape[1] * layouts.base_walk.shape[2]
    resident = cuda_vi.key_vi_grid_resident(hw + 1, 1 << max_doors, hw)
    assert resident == (route[1] < cuda_vi.KEY_GRID_MAX_CTAS)
    got = _key_vi_on_route(layouts, n_sweeps, route)
    want = tkey.key_vi_values(layouts, GAMMA, n_sweeps)
    assert n_sweeps < 30 or (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    direct = cuda_vi._key_vi_kernel_grid(cuda_vi.key_vi_masks(layouts), GAMMA, n_sweeps, got.shape, route[1])
    torch.testing.assert_close(direct, want, rtol=0, atol=1e-6)
    assert cuda_vi.key_vi_grid_active_groups(1 << max_doors, *layouts.base_walk.shape[1:], route[1],
                                             resident) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_sweeps,closed", [
    (0, False), (1, False), (12, False), (31, False), (30, True), (31, True),
])
def test_key_vi_wide_route_in_place(card, n_sweeps, closed):
    """The in-place sweep at DoorKey-16x16: the hub's CARRIED row ends in
    its second slot after an odd number of sweeps; closed doors make every
    key row toggle, so the configs' order within a sweep matters."""
    layouts = tkey.extract_key_layout(_states(card, "MiniGrid-DoorKey-16x16-v0", 5, seed=6), 1)
    if closed:
        layouts = dataclasses.replace(layouts, door_init=torch.ones_like(layouts.door_init))
    assert cuda_vi.key_vi_wide_in_place(2, 256)
    got = _key_vi_on_route(layouts, n_sweeps, ("wide", 16))
    want = tkey.key_vi_values(layouts, GAMMA, n_sweeps)
    assert n_sweeps < 30 or (want > 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,max_doors,route", [
    ("MiniGrid-KeyCorridorS3R2-v0", 6, ("wide", 16)),
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
    """Clusters of 2, 4 and 8 CTAs and the wide route's cluster of 16
    (double-buffered at this shape) each match the plain version at
    DoorKey-8x8: the row split and the remote reads do not change the
    result."""
    layouts = tkey.extract_key_layout(_states(card, "MiniGrid-DoorKey-8x8-v0", 9, seed=5), 1)
    masks = cuda_vi.key_vi_masks(layouts)
    shape = (9, 65, 2, 4, 8, 8)
    want = tkey.key_vi_values(layouts, GAMMA, 33)
    for n in (2, 4, 8):
        got = cuda_vi._key_vi_kernel_cluster(masks, GAMMA, 33, shape, n)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert cuda_vi.key_vi_active_clusters(2, 8, 8, n) > 0
    assert not cuda_vi.key_vi_wide_in_place(2, 64)
    got = cuda_vi._key_vi_kernel_wide(masks, GAMMA, 33, shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert cuda_vi.key_vi_wide_active_clusters(2, 8, 8) > 0
    assert cuda_vi.key_vi_wide_active_clusters(2, 16, 16) > 0  # in place
    assert cuda_vi.key_vi_wide_active_clusters(64, 5, 7) > 0


@pytest.mark.cuda
def test_launch_plans_match_the_c_side(card):
    """The Python mirrors of each kernel's plan, which the CPU tests check,
    are the plans the .cu files compute."""
    import ctypes

    from minigrid_dynamicprogramming_tpu_torch import _kernels

    vi, key = _kernels.library("vi"), _kernels.library("key_vi")
    for f in (vi.vi_shared_bytes, key.key_vi_cluster_shared_bytes, key.key_vi_wide_shared_bytes):
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
    for hw, C in ((64, 2), (256, 2), (256, 4), (35, 64), (49, 128), (361, 2)):
        for in_place in (False, True):
            assert key.key_vi_wide_shared_bytes(C, hw, 16, int(in_place)) == (
                cuda_vi.key_vi_wide_shared_bytes(C, hw, 16, in_place)
            )
    key.key_vi_grid_shared_bytes.restype = ctypes.c_size_t
    for hw, C in ((256, 4), (49, 128), (64, 128), (361, 2), (361, 64), (256, 128)):
        n = cuda_vi.key_vi_grid_ctas(hw + 1, C, hw)
        resident = cuda_vi.key_vi_grid_resident(hw + 1, C, hw)
        assert key.key_vi_grid_shared_bytes(C, hw, n, int(resident)) == (
            cuda_vi.key_vi_grid_shared_bytes(C, hw, n, resident)
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
    LavaCrossingS9N1: observations, states, count tables, flags and rewards
    equal on the card and on the CPU at every step."""
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
        assert torch.equal(got[2].cpu(), want[2])
        assert torch.equal(got[3].cpu(), want[3]) and torch.equal(got[4].cpu(), want[4])
        core = cpu.inner
        pos = core.agent_pos.long()
        deaths += int((core.grid_obj[torch.arange(256), pos[:, 1], pos[:, 0]] == OBJ_LAVA).sum())
    assert deaths > 0  # agents on lava, their deaths cancelled


def _assert_lanes_equal(a, b, what: str):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{what} {f.name}"


@pytest.mark.cuda
def test_one_rank_nccl_rollout_equals_ungrouped(card):
    """NCCL takes one rank a card, so a one-rank group is what one card
    can hold: its sharded rollout (the scalars all-reduced) equals the
    ungrouped one from the same seed, bit for bit."""
    import torch.distributed as dist

    from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
    from minigrid_dynamicprogramming_tpu_torch.parallel.scaling import free_port
    from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import rank_seed, sharded_keys

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, local_device_ids=[0], max_retries=1,
                           backend="nccl", timeout_s=120)
    try:
        group = distributed.global_env_group()
        assert group.device == torch.device("cuda:0") and group.world_size == 1
        env = port.make("MiniGrid-Empty-5x5-v0")  # T above max_steps=100: every lane resets
        got = tlanes.lane_rollout(env, sharded_keys(0, group), 4096, 128, "pool", 4, group=group)
        g = torch.Generator(device=card).manual_seed(rank_seed(0, 0))
        want = tlanes.lane_rollout(env, g, 4096, 128, "pool", 4, device=card)
        _assert_lanes_equal(got.final_state, want.final_state, "final state")
        assert torch.equal(got.resets_per_env, want.resets_per_env)
        for name in ("total_reward", "episodes", "obs_checksum", "successes", "failures"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert int(got.resets_per_env.min()) > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_ppo_update_equals_ungrouped(card, deterministic):
    """A one-rank NCCL group's PPO updates, with deterministic algorithms:
    the trajectory all-gathered, the learner captured once with its
    all-reduces (the advantage's moments, the flat gradient) in its graph;
    two updates' metrics, then the parameters and Adam's state, equal the
    ungrouped run's from the same seed bit for bit."""
    import torch.distributed as dist

    from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
    from minigrid_dynamicprogramming_tpu_torch.parallel.scaling import free_port

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, local_device_ids=[0], max_retries=1,
                           backend="nccl", timeout_s=120)
    try:
        group = distributed.global_env_group()
        runs = []
        for grp in (None, group):
            ppo = _ppo_on_card(card, "BabyAI-GoToDoor-v0", group=grp)
            ts = ppo.init(4)
            seen = []
            for _ in range(2):
                ts, m = ppo.update(ts)
                seen += [x.clone() for x in m]
            assert all(torch.isfinite(x).all() for x in m), m
            assert ppo.captures == {"collector": 1, "learner": 1}, ppo.captures
            assert (ppo.gather_bytes > 0) == (grp is not None)
            runs.append(seen + [x.detach().clone() for x in _learner_state(ts)])
        ungrouped, grouped = runs
        for k, (x, y) in enumerate(zip(grouped, ungrouped)):
            assert torch.equal(x, y), k
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(card, tmp_path):
    """A PPO train state on the card: model, optimizer, env state, pool and
    both generators restored equal, each tensor back on the card; the
    restored run then collects the same actions."""
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu_torch.utils import checkpoint as ckpt

    ppo = PPO(port.make("BabyAI-GoToDoor-v0"), PPOConfig(num_envs=256, rollout_len=8), device=card)
    ts, _ = ppo.update(ppo.init(0))
    ckpt.save(str(tmp_path / "ts"), ts, env_state=ts.env_state)
    want = ppo._collect(ts)[3]
    got_ts = ckpt.restore(str(tmp_path / "ts"), ppo.init(1), env_state_of=lambda t: t.env_state)
    for (name, p), q in zip(ts.model.named_parameters(), got_ts.model.parameters()):
        assert q.is_cuda and torch.equal(p, q), name
    _assert_lanes_equal(got_ts.pool, ts.pool, "pool")
    assert got_ts.env_state.grid_obj.is_cuda
    assert torch.equal(got_ts.learner_generator.get_state(), ts.learner_generator.get_state())
    got = ppo._collect(got_ts)[3]
    assert torch.equal(got.actions, want.actions)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.cpu().view(torch.int32)


@pytest.mark.cuda
def test_success_reward_card_equals_cpu(card):
    """``success_reward`` and ``env_return`` on the card equal the CPU's bit
    for bit at every step count 0..m of every registered id's step limit m;
    the old division by the Python number differs on the card."""
    from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

    limits = sorted({port.make(i).params.max_steps for i in port.registered_ids()})
    assert len(limits) == 44
    for m in limits:
        steps = torch.arange(m + 1, dtype=torch.int32)
        want = success_reward(steps, m)
        assert torch.equal(_bits(success_reward(steps.to(card), m)), _bits(want)), m
        d = torch.arange(1, m + 6, dtype=torch.float64)
        v = (GAMMA ** (d - 1)).to(torch.float32)
        want_r = ttab.env_return(v, GAMMA, 0, m)
        assert torch.equal(_bits(ttab.env_return(v.to(card), GAMMA, 0, m)), _bits(want_r)), m
    steps = torch.arange(641, dtype=torch.int32)
    old = 1.0 - 0.9 * (steps.to(card).to(torch.float32) / 640)
    assert not torch.equal(_bits(old), _bits(success_reward(steps, 640)))


@pytest.mark.cuda
def test_bench_on_card_goes_through_the_kernels(card):
    """``bench_torch.main`` at a small size on the card: both kernel rows,
    B1 and B2 (on the cluster route) each launched for the warm-up and the
    timed runs; each PPO row's graphs captured once."""
    import bench_torch

    small = {
        **bench_torch.FULL,
        "batch": 1024, "horizon": 64, "pool_rounds": 2, "iters": 2,
        "family_batch": 256, "family_horizon": 16,
        "vi_batch": 64, "vi_sweeps": 16, "key_batch": 64, "key_sweeps": 16,
        "obstructed_batch": 1, "obstructed_sweeps": 4, "twokey_batch": 1, "twokey_sweeps": 4,
        "dp_runs": 2, "ppo_envs": 512, "ppo_len": 8, "ppo_warmup": 1, "ppo_timed": 2,
    }
    extra = bench_torch.main(small, device=card)["extra"]
    assert extra["vi_d1_cuda_sweeps_per_s"] > 0 and extra["vi_key_cuda_sweeps_per_s"] > 0
    assert extra["launches"] == {
        "vi": 3, "key_vi": {r: 3 if r == "cluster" else 0 for r in cuda_vi.ROUTES},
    }
    assert extra["device"]["name"] == torch.cuda.get_device_name(0)
    assert {"vi_d1_cuda_sweeps_per_s", "vi_key_cuda_sweeps_per_s"} <= set(extra["spread"])
    # One capture of each loop per PPO over its warm-up and timed updates.
    assert extra["ppo_graphs"]["epochs_2"]["captures"] == {"collector": 1, "learner": 1}
    assert extra["ppo_graphs"]["epochs_0"]["captures"] == {"collector": 1, "learner": 0}


def _rollout_pair(card, env_id: str, autoreset: str, given: bool, seed: int):
    """``lane_rollout`` (the step captured as a CUDA graph and replayed)
    and the same rollout with its step in a Python loop
    (``_lane_scan_eager``), each from a generator seeded alike; with each
    generator's next draw.  The step limit is cut to 64, below the
    horizon, so that lanes reset."""
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=min(env.params.max_steps, 64))
    b, horizon, rounds = 2048, 96, 3
    acts = None
    if given:
        acts = torch.randint(0, env.action_dim, (horizon, b), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(seed))
    runs = []
    for graphed in (True, False):
        g = torch.Generator(device=card).manual_seed(seed)
        captures = profiling.counter("lanes.captures")
        if graphed:
            res = tlanes.lane_rollout(env, g, b, horizon, autoreset, rounds, actions=acts,
                                      device=card)
        else:
            pool = tlanes.lane_pool(env, g, b, autoreset, rounds, card)
            res = tlanes._lane_scan_eager(env, g, pool, b, horizon, autoreset, rounds, acts)
        assert profiling.counter("lanes.captures") == captures + graphed
        runs.append((res, torch.randint(0, 1 << 30, (16,), generator=g, device=card)))
    return runs


def _assert_rollouts_equal(a, b) -> None:
    _assert_lanes_equal(a.final_state, b.final_state, "final state")
    assert torch.equal(a.resets_per_env, b.resets_per_env)
    for name in ("total_reward", "episodes", "successes", "failures", "obs_checksum"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.steps == b.steps


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,autoreset,given", [
    ("MiniGrid-DoorKey-8x8-v0", "pool", False),
    ("MiniGrid-DoorKey-8x8-v0", "pool", True),
    ("MiniGrid-DoorKey-8x8-v0", "cached", False),
    ("MiniGrid-DoorKey-8x8-v0", "cached", True),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", "pool", False),
    ("BabyAI-GoToLocal-v0", "pool", False),
    ("MiniGrid-DoorKey-8x8-v0", "regen", False),
    ("MiniGrid-DoorKey-8x8-v0", "regen", True),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", "regen", False),
    ("BabyAI-GoToLocal-v0", "regen", False),
])
def test_graphed_rollout_equals_eager(card, env_id, autoreset, given):
    """The graphed rollout equals the eager loop bit for bit, and leaves
    its generator where the eager loop does: the replays draw the actions
    and DynamicObstacles' ball moves from the caller's generator, and in
    "cached" mode read the pool's round 0 without writing it."""
    (graphed, g_next), (eager, e_next) = _rollout_pair(card, env_id, autoreset, given, seed=21)
    _assert_rollouts_equal(graphed, eager)
    assert torch.equal(g_next, e_next)
    assert int(eager.episodes) > 0


def _stepped_lanes(card, env_id: str, b: int, view: int, seed: int):
    """``b`` lanes of ``env_id`` (its view cut or widened to ``view``)
    stepped 24 times by random actions, so that agents have turned, moved
    and opened; then a third of them carry a random object of a random
    colour, for the overlay at the agent's cell."""
    env = port.make(env_id)
    env.params = env.params.replace(agent_view_size=view)
    g = torch.Generator(device=card).manual_seed(seed)
    ls = tlanes.to_lanes(env.generate(g, env.params, b, card))
    for _ in range(24):
        act = torch.randint(0, env.action_dim, (b,), generator=g, device=card, dtype=torch.int32)
        ls, _, _ = tlanes.step_lanes_env(env, ls, act, g)
    held = torch.randint(0, 3, (b,), generator=g, device=card) == 0

    def draw(lo, hi):
        return torch.randint(lo, hi, (b,), generator=g, device=card).to(torch.uint8)

    ls = ls.replace(carrying_obj=torch.where(held, draw(5, 8), ls.carrying_obj),
                    carrying_color=torch.where(held, draw(0, 6), ls.carrying_color))
    return env, ls


def _plain_checksum(params, ls) -> int:
    obj, color, obj_state, vis = tlanes.obs_lanes(params, ls)
    return int(((obj.to(torch.int64) + color + obj_state) * vis).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,view,b", [
    ("MiniGrid-DoorKey-8x8-v0", 7, 4096),
    ("MiniGrid-DoorKey-8x8-v0", 7, 1001),  # a part block, bytes staged one a load
    ("MiniGrid-DoorKey-16x16-v0", 7, 4096),  # 256 cells: read from device memory
    ("MiniGrid-Empty-8x8-v0", 7, 4096),  # see_through_walls
    ("BabyAI-GoToLocal-v0", 7, 4096),
    ("MiniGrid-DoorKey-8x8-v0", 3, 4096),
    ("MiniGrid-DoorKey-8x8-v0", 9, 4096),
    ("MiniGrid-DoorKey-16x16-v0", 9, 2050),
    ("MiniGrid-DoorKey-8x8-v0", 63, 1024),
    ("MiniGrid-Empty-8x8-v0", 63, 1024),
])
def test_obs_kernel_equals_plain(card, env_id, view, b):
    """``obs_checksum_lanes`` on the card (one launch of ``csrc/obs.cu``,
    counted under its instance) adds the plain path's checksum into its
    slot, bit for bit, and leaves the other slots alone."""
    env, ls = _stepped_lanes(card, env_id, b, view, seed=view + b)
    inst = tlanes.obs_instance(view)
    before = profiling.counter("obs.launches"), profiling.counter(f"obs.launches.{inst}")
    out = torch.full((3,), 5, dtype=torch.int64, device=card)
    tlanes.obs_checksum_lanes(env.params, ls, out, torch.ones(1, dtype=torch.int64, device=card))
    assert out.tolist() == [5, 5 + _plain_checksum(env.params, ls), 5]
    assert (profiling.counter("obs.launches"), profiling.counter(f"obs.launches.{inst}")) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_obs_kernel_refuses_other_inputs(card):
    """A view wider than ``MAX_VIEW``, a plane of another type or a
    strided plane raise before any launch."""
    env, ls = _stepped_lanes(card, "MiniGrid-DoorKey-8x8-v0", 256, 7, seed=1)
    out = torch.zeros(2, dtype=torch.int64, device=card)
    t = torch.zeros(1, dtype=torch.int64, device=card)
    launches = profiling.counter("obs.launches")
    with pytest.raises(ValueError, match="exceeds"):
        tlanes.obs_checksum_lanes(env.params.replace(agent_view_size=65), ls, out, t)
    with pytest.raises(ValueError, match="contiguous"):
        tlanes.obs_checksum_lanes(env.params, ls.replace(grid_obj=ls.grid_obj.to(torch.int32)),
                                  out, t)
    wide = torch.cat([ls.grid_color, ls.grid_color], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tlanes.obs_checksum_lanes(env.params, ls.replace(grid_color=wide), out, t)
    assert profiling.counter("obs.launches") == launches
    assert out.tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("autoreset", ["pool", "regen"])
def test_graphed_rollout_goes_through_obs_kernel(card, monkeypatch, autoreset):
    """The graphed rollout launches ``csrc/obs.cu`` twice (the capture's
    warm-up and the capture itself) and replays it every step; its result
    equals, bit for bit, the eager loop's with the plain observation in
    the kernel's place."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    env.params = env.params.replace(max_steps=64)
    b, horizon, rounds = 2048, 96, 3
    g = torch.Generator(device=card).manual_seed(4)
    launches = profiling.counter("obs.launches.v7")
    graphed = tlanes.lane_rollout(env, g, b, horizon, autoreset, rounds, device=card)
    assert profiling.counter("obs.launches.v7") == launches + 2

    def plain(params, ls, out, t):
        obj, color, obj_state, vis = tlanes.obs_lanes(params, ls)
        out.index_add_(0, t, ((obj.to(torch.int64) + color + obj_state) * vis).sum().view(1))

    monkeypatch.setattr(tlanes, "obs_checksum_lanes", plain)
    g = torch.Generator(device=card).manual_seed(4)
    pool = tlanes.lane_pool(env, g, b, autoreset, rounds, card)
    eager = tlanes._lane_scan_eager(env, g, pool, b, horizon, autoreset, rounds)
    assert profiling.counter("obs.launches.v7") == launches + 2
    _assert_rollouts_equal(graphed, eager)
    assert int(eager.episodes) > 0 and int(eager.obs_checksum) > 0


@pytest.mark.cuda
def test_second_rollout_in_a_process_is_the_same(card):
    """No graph or memory pool outlives a call: a rollout of another id and
    size in between, then the first one again, gives the first's result."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")

    def run(seed):
        g = torch.Generator(device=card).manual_seed(seed)
        return tlanes.lane_rollout(env, g, 4096, 700, "pool", 2, device=card)

    first = run(5)
    other = port.make("MiniGrid-Empty-5x5-v0")
    tlanes.lane_rollout(other, torch.Generator(device=card).manual_seed(6), 1024, 50, "cached", 1,
                        device=card)
    _assert_rollouts_equal(run(5), first)
    assert int(first.resets_per_env.min()) > 0


@pytest.mark.cuda
def test_zero_horizon_captures_nothing(card):
    """A rollout of no steps has no step to capture: it returns its pool's
    round 0 and counts nothing."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    captures = profiling.counter("lanes.captures")
    res = tlanes.lane_rollout(env, torch.Generator(device=card).manual_seed(1), 256, 0,
                              device=card)
    assert profiling.counter("lanes.captures") == captures
    assert res.steps == 0 and int(res.episodes) == 0 and int(res.obs_checksum) == 0
    assert int(res.final_state.step_count.max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("autoreset", ["pool", "regen"])
def test_traced_rollout_stamps_each_part_of_the_step(card, autoreset):
    """A graphed DoorKey-8x8 rollout under ``tracing()``: each in-graph
    span counts ``horizon`` replayed steps, and once more as an eager span
    in the capture's warm-up step; the parts' sum is at most the step's;
    the result equals the untraced call's bit for bit; the untraced call
    keeps no record, and its capture holds the traced one's nodes less the
    stamps, two a span.  DoorKey steps through ``csrc/step.cu``, whose
    autoreset is inside ``lanes.transition``: there is no ``lanes.select``."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    b, horizon, rounds = 4096, 100, 2
    parts = ["lanes.step", "lanes.transition", "lanes.observation"]
    if autoreset == "regen":
        parts.append("generator.generate")

    def run():
        g = torch.Generator(device=card).manual_seed(9)
        return tlanes.lane_rollout(env, g, b, horizon, autoreset, rounds, device=card)

    profiling.clear()
    off = run()
    assert profiling.records() == []
    with profiling.tracing():
        on = run()
    recs = profiling.records()
    profiling.clear()
    _assert_rollouts_equal(on, off)
    by_id = {r["id"]: r for r in recs}
    (cap,) = [r for r in recs if r["name"] == "lanes.capture"]

    def within_capture(r):
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            if r["name"] == "lanes.capture":
                return True
        return False

    for name in parts:
        graphed = [r for r in recs if r["name"] == name and r["attrs"].get("graph")]
        warmup = [r for r in recs if r["name"] == name and within_capture(r)]
        assert len(graphed) == 1 and graphed[0]["count"] == horizon, name
        assert len(warmup) == 1 and warmup[0]["count"] == 1, name
        assert graphed[0]["device_ms"] > 0, name
    (step,) = [r for r in recs if r["name"] == "lanes.step" and r["attrs"].get("graph")]
    children = [r for r in recs if r["parent"] == step["id"]]
    assert {r["name"] for r in children} == set(parts[1:])
    assert sum(r["device_ms"] for r in children) <= step["device_ms"]
    assert cap["attrs"]["stamp_nodes"] == 2 * len(parts)
    assert not [r for r in recs if r["name"] == "lanes.select"]

    g = torch.Generator(device=card).manual_seed(9)
    pool = tlanes.lane_pool(env, g, b, autoreset, rounds, card)
    scan = tlanes._Scan(env, g, pool, b, horizon, autoreset, rounds, None)
    stamps = profiling.GraphStamps(card)
    graph, _ = scan.capture(stamps)
    graph.reset()
    assert stamps.kernels == 0
    assert stamps.graph_nodes == cap["attrs"]["graph_nodes"] > 0


@pytest.mark.cuda
def test_traced_solve_spans_its_layers(card):
    """The key-domain solve under ``tracing()``: ``dp.extract``, ``dp.vi``
    holding ``dp.masks`` and ``dp.kernel`` (its route), ``dp.policy``, each
    timed by CUDA events, and the same V and policy as untraced."""
    states = _states(card, "MiniGrid-DoorKey-16x16-v0", 8, seed=3)

    def solve():
        layout = tkey.extract_key_layout(states, 1)
        v = cuda_vi.cuda_key_value_iteration(layout, GAMMA, 64)
        return v, tkey.key_greedy_policy(v, layout, GAMMA)

    profiling.clear()
    v_off, pol_off = solve()
    with profiling.tracing():
        v_on, pol_on = solve()
    recs = {r["name"]: r for r in profiling.records()}
    profiling.clear()
    assert torch.equal(v_on, v_off) and torch.equal(pol_on, pol_off)
    assert set(recs) == {"dp.extract", "dp.vi", "dp.masks", "dp.kernel", "dp.policy"}
    assert recs["dp.masks"]["parent"] == recs["dp.kernel"]["parent"] == recs["dp.vi"]["id"]
    assert recs["dp.kernel"]["attrs"] == {"route": "wide"}
    assert all(r["device_ms"] > 0 for r in recs.values())
    assert recs["dp.masks"]["device_ms"] + recs["dp.kernel"]["device_ms"] <= recs["dp.vi"]["device_ms"]


_PPO_IDS = ["BabyAI-GoToDoor-v0", "MiniGrid-DoorKey-5x5-v0", "MiniGrid-Dynamic-Obstacles-8x8-v0"]


def _ppo_on_card(card, env_id: str, epochs: int = 2, autoreset: str = "pool", group=None):
    from minigrid_dynamicprogramming_tpu_torch.models import PPO, PPOConfig

    env = port.make(env_id)
    env.params = env.params.replace(max_steps=min(env.params.max_steps, 24))  # lanes reset
    return PPO(env, PPOConfig(num_envs=2048, rollout_len=32, epochs=epochs, num_minibatches=4,
                              autoreset=autoreset), device=card, group=group)


def _next_draw(g: torch.Generator) -> torch.Tensor:
    """The generator's next draw, taken from a copy of its state."""
    copy = torch.Generator(device=g.device).set_state(g.get_state())
    return torch.randint(0, 1 << 30, (16,), generator=copy, device=g.device)


def _learner_state(ts) -> list:
    """The parameters, then Adam's state tensors, in order."""
    params = list(ts.model.parameters())
    return [*params, *(v for p in params for v in ts.optimizer.state[p].values())]


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for the test's duration: the
    embeddings' backward on the card sums with atomics by default, so two
    eager learners from one state differ in the last bits."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _ppo_graphed_against_eager(card, env_id: str, autoreset: str) -> None:
    """Two updates graphed (``update``) and, from the same seed, eager
    (``_update_eager``) twice, with deterministic algorithms: each
    update's trajectory, final state, reset counts and collector
    generator, then the parameters and Adam's state, equal bit for bit."""
    from minigrid_dynamicprogramming_tpu_torch.models import ppo as tppo

    runs = []
    for graphed in (True, False, False):
        ppo = _ppo_on_card(card, env_id, autoreset=autoreset)
        ts = ppo.init(4)
        seen = []
        for _ in range(2):
            ts, m = ppo.update(ts) if graphed else ppo._update_eager(ts)
            seen += [*(x.clone() for x in tppo._traj_tensors(ppo._traj)),
                     *(getattr(ts.env_state, f.name).clone() for f in dataclasses.fields(ts.env_state)),
                     ts.reset_count.clone(), _next_draw(ts.generator), *(x.clone() for x in m)]
        assert int(ts.reset_count.sum()) > 0, "lanes reset"
        assert all(torch.isfinite(x).all() for x in m), m
        assert ppo.captures == ({"collector": 1, "learner": 1} if graphed
                                else {"collector": 0, "learner": 0})
        runs.append(seen + [x.detach().clone() for x in _learner_state(ts)])
    graphed, eager, eager2 = runs
    assert all(torch.equal(x, y) for x, y in zip(eager, eager2)), "two eager runs agree"
    for k, (x, y) in enumerate(zip(graphed, eager)):
        assert torch.equal(x, y), k


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", _PPO_IDS)
def test_graphed_ppo_update_equals_eager(card, deterministic, env_id):
    _ppo_graphed_against_eager(card, env_id, "pool")


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", _PPO_IDS)
def test_graphed_regen_ppo_update_equals_eager(card, deterministic, env_id):
    """As above with the "regen" collector: ``generate`` in its graph."""
    _ppo_graphed_against_eager(card, env_id, "regen")


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", port.registered_ids())
def test_generate_graph_equals_eager(card, env_id):
    """``generate`` at B=64 captured once (the generator registered) and
    replayed twice: each replay equals an eager call from the generator
    state it started from, and the generators end alike.  The DoorKey ids
    generate through ``csrc/doorkey_gen.cu`` (the capture's warm-up, the
    capture and the two eager calls launch it), no other id does."""
    env = port.make(env_id)
    g = torch.Generator(device=card).manual_seed(9)
    start = g.get_state()
    launches = profiling.counter("generator.kernel.launches")
    out = {}

    def step():
        out["state"] = env.generate(g, env.params, 64, card)

    graph, _, pool_bytes = tlanes.capture_step(step, step, card, g)
    h = torch.Generator(device=card).set_state(start)
    try:
        for _ in range(2):
            graph.replay()
            want = env.generate(h, env.params, 64, card)
            for f in dataclasses.fields(want):
                assert torch.equal(getattr(out["state"], f.name), getattr(want, f.name)), f.name
    finally:
        graph.reset()
    assert pool_bytes > 0
    assert torch.equal(_next_draw(g), _next_draw(h))
    doorkey = env_id.startswith("MiniGrid-DoorKey-")
    assert profiling.counter("generator.kernel.launches") == launches + (4 if doorkey else 0)


@pytest.mark.cuda
def test_traced_ppo_update_stamps_its_steps(card):
    """GoToDoor's graphed update under ``tracing()``: both kept graphs are
    captured again with stamps; each update's records count its own
    replays (32 collector steps, 8 minibatch steps), each step's parts
    under it and within its time; an untraced update captures both again
    without stamps and keeps no record."""
    ppo = _ppo_on_card(card, _PPO_IDS[0])
    ts, _ = ppo.update(ppo.init(0))
    assert ppo.captures == {"collector": 1, "learner": 1}
    profiling.clear()
    with profiling.tracing():
        for n in range(2):
            ts, _ = ppo.update(ts)
            recs = profiling.records()
            profiling.clear()
            assert ppo.captures == {"collector": 2, "learner": 2}
            by_id = {r["id"]: r for r in recs}
            for loop, name, count, parts in (
                ("collector", "ppo.collect.step", 32,
                 {"ppo.collect.observation", "ppo.collect.policy", "ppo.collect.env"}),
                ("learner", "ppo.minibatch", 8, {"ppo.forward", "ppo.backward", "ppo.optimizer"}),
            ):
                (step,) = [r for r in recs if r["name"] == name and r["attrs"].get("graph")]
                assert by_id[step["parent"]]["name"] == f"ppo.{loop}.replay"
                assert step["count"] == count and step["device_ms"] > 0, (n, name)
                children = [r for r in recs if r["parent"] == step["id"]]
                assert {r["name"] for r in children} == parts
                assert all(r["count"] == count for r in children)
                assert sum(r["device_ms"] for r in children) <= step["device_ms"]
                caps = [r for r in recs if r["name"] == f"ppo.{loop}.capture"]
                if n == 0:
                    assert caps and caps[0]["attrs"]["graph_nodes"] > 0
                else:
                    assert not caps
    ppo.update(ts)
    assert ppo.captures == {"collector": 3, "learner": 3}
    assert profiling.records() == []


@pytest.mark.cuda
def test_ppo_captures_once_per_train_state(card, tmp_path):
    """Seven updates capture each graph once; an optimizer state restored
    from a checkpoint (new tensors) captures the learner again, a
    TrainState from another ``init`` both; zero epochs capture no
    learner."""
    from minigrid_dynamicprogramming_tpu_torch.utils import checkpoint as ckpt

    ppo = _ppo_on_card(card, _PPO_IDS[0])
    ts = ppo.init(0)
    for _ in range(7):
        ts, m = ppo.update(ts)
    assert ppo.captures == {"collector": 1, "learner": 1}
    assert all(ppo.pool_bytes[n] > 0 and ppo.capture_ms[n] > 0 for n in ppo.captures)
    ckpt.save(str(tmp_path / "opt"), ts.optimizer)
    ckpt.restore(str(tmp_path / "opt"), ts.optimizer)
    ts, _ = ppo.update(ts)
    assert ppo.captures == {"collector": 1, "learner": 2}
    ppo.update(ppo.init(1))
    assert ppo.captures == {"collector": 2, "learner": 3}
    assert all(torch.isfinite(x).all() for x in m), m

    rollout_only = _ppo_on_card(card, _PPO_IDS[0], epochs=0)
    ts = rollout_only.init(0)
    for _ in range(3):
        ts, m = rollout_only.update(ts)
    assert rollout_only.captures == {"collector": 1, "learner": 0}
    assert bool(torch.isfinite(m.mean_reward))


# --- the rollout step as one kernel (csrc/step.cu) -------------------------

_STEP_IDS = ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-DoorKey-16x16-v0", "MiniGrid-Playground-v0",
             "MiniGrid-MultiRoom-N6-v0", "MiniGrid-Empty-8x8-v0"]


def _carries_equal(a, b, what: str) -> None:
    """Every tensor of two carries equal; the rewards as bits, since slots
    not yet written hold whatever their memory held."""
    _assert_lanes_equal(a.ls, b.ls, what)
    assert torch.equal(_bits(a.rewards), _bits(b.rewards)), f"{what} rewards"
    for name in ("reset_count", "t", "dones", "wins", "ends", "checksums"):
        assert torch.equal(getattr(a, name), getattr(b, name)), f"{what} {name}"


def _kernel_steps_as_plain(scan, carry, steps: int, what: str):
    """``steps`` steps from ``carry`` by ``scan.step_plain`` on one copy and
    ``scan.step_kernel`` on another, each step from the same generator
    state: after every step the carries, and the generator's states, are
    equal bit for bit.  Returns the plain step's carry."""
    plain, kernel = carry.clone(), carry.clone()
    g = scan.generator
    for i in range(steps):
        start = None if g is None else g.get_state()
        scan.step_plain(plain)
        if g is not None:
            after = g.get_state()
            g.set_state(start)
        scan.step_kernel(kernel)
        if g is not None:
            assert torch.equal(g.get_state(), after), f"{what} step {i}: generator"
        _carries_equal(kernel, plain, f"{what} step {i}:")
    return plain


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("autoreset", ["pool", "cached", "regen"])
@pytest.mark.parametrize("env_id", _STEP_IDS)
def test_step_kernel_equals_plain(card, env_id, autoreset, given):
    """The kernel step (``csrc/step.cu``) and the plain step on the same
    carry, step by step: every field, the reset counts, the step's reward,
    done, won and ended counts, the observation checksum and the
    generator's state equal bit for bit.  The step limit is cut to 64, so
    every lane resets; Playground keeps its box planes."""
    env = port.make(env_id)
    env.params = env.params.replace(max_steps=64)
    b, horizon, rounds = 1024, 80, 3
    g = torch.Generator(device=card).manual_seed(31)
    pool = tlanes.lane_pool(env, g, b, autoreset, rounds, card)
    acts = None
    if given:
        acts = torch.randint(0, env.action_dim, (horizon, b), generator=g, device=card,
                             dtype=torch.int32)
    scan = tlanes._Scan(env, g, pool, b, horizon, autoreset, rounds, acts)
    assert scan.path == "kernel"
    plain = _kernel_steps_as_plain(scan, scan.carry, horizon, f"{env_id} {autoreset}")
    assert int(plain.reset_count.min()) > 0
    assert int(plain.checksums.sum()) > 0


# Front cells (obj, color, state, contains_obj, contains_color), None for
# the grid's edge; what the agent carries (obj, color, contains_obj,
# contains_color).
_FRONTS = [(1, 0, 0, 1, 0), (2, 5, 0, 1, 0), (3, 1, 0, 1, 0), (4, 4, 0, 1, 0), (4, 4, 1, 1, 0),
           (4, 4, 2, 1, 0), (4, 2, 2, 1, 0), (5, 4, 0, 1, 0), (6, 0, 0, 1, 0), (7, 2, 0, 5, 4),
           (7, 3, 0, 1, 0), (8, 1, 0, 1, 0), (9, 0, 0, 1, 0), None]
_CARRIED = [(1, 0, 1, 0), (5, 4, 1, 0), (6, 0, 1, 0), (7, 2, 6, 1)]
_DIRS = [(1, 0), (0, 1), (-1, 0), (0, -1)]


def _hand_made_lanes(device, max_steps: int, g: torch.Generator):
    """A 5x5 lane for each front cell of ``_FRONTS`` (an empty, wall and
    floor cell, an open, closed and locked yellow door, a locked blue one,
    a key, a ball, a box holding a key and an empty one, the goal, lava, and
    the grid's edge), each thing carried of ``_CARRIED``, each of the seven
    actions and each direction: the agent faces the centre cell, or, at the
    edge, faces out from the middle of a side.  Marks, aux and mission
    planes are random; every fifth lane is one step from its limit.
    Returns the lanes and their actions (B,) int64."""
    lanes = [(f, c, a, d) for f in _FRONTS for c in _CARRIED for a in range(7) for d in range(4)]
    b, hw = len(lanes), 25

    def rand(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=device, dtype=dtype)

    ls = tlanes.LaneState(
        grid_obj=torch.ones((hw, b), dtype=torch.uint8), grid_color=torch.zeros((hw, b), dtype=torch.uint8),
        grid_state=torch.zeros((hw, b), dtype=torch.uint8),
        contains_obj=torch.ones((hw, b), dtype=torch.uint8),
        contains_color=torch.zeros((hw, b), dtype=torch.uint8),
        marks=rand(1000, (hw, b)).cpu(), vmarks=rand(1000, (hw, b)).cpu(),
        agent_x=torch.zeros(b, dtype=torch.int32), agent_y=torch.zeros(b, dtype=torch.int32),
        agent_dir=torch.zeros(b, dtype=torch.int32),
        carrying_obj=torch.zeros(b, dtype=torch.uint8), carrying_color=torch.zeros(b, dtype=torch.uint8),
        carrying_contains_obj=torch.zeros(b, dtype=torch.uint8),
        carrying_contains_color=torch.zeros(b, dtype=torch.uint8),
        carrying_marks=rand(1000, (b,)).cpu(),
        step_count=torch.tensor([max_steps - 1 if i % 5 == 0 else i % (max_steps - 1)
                                 for i in range(b)], dtype=torch.int32),
        terminated=torch.zeros(b, dtype=torch.bool), truncated=torch.zeros(b, dtype=torch.bool),
        aux=rand(50, (24, b)).cpu(), mission=rand(50, (48, b)).cpu(),
    )
    actions = torch.zeros(b, dtype=torch.int64)
    for i, (front, carried, action, d) in enumerate(lanes):
        dx, dy = _DIRS[d]
        if front is None:  # at the middle of the side it faces, facing out
            x, y = 2 + 2 * dx, 2 + 2 * dy
        else:
            x, y = 2 - dx, 2 - dy
            for plane, v in zip(("grid_obj", "grid_color", "grid_state", "contains_obj",
                                 "contains_color"), front):
                getattr(ls, plane)[2 * 5 + 2, i] = v
        ls.agent_x[i], ls.agent_y[i], ls.agent_dir[i] = x, y, d
        for field, v in zip(("carrying_obj", "carrying_color", "carrying_contains_obj",
                             "carrying_contains_color"), carried):
            getattr(ls, field)[i] = v
        actions[i] = action
    return ls.map(lambda x: x.to(device)), actions.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kept", [False, True])
@pytest.mark.parametrize("autoreset", ["pool", "regen"])
def test_step_kernel_hand_made_fronts(card, autoreset, kept):
    """Three steps of the hand-made lanes (``_hand_made_lanes``: a box, a
    ball, a key, open, closed and locked doors, lava, the goal and the
    grid's edge in front, under all seven actions, given as int64), by the
    kernel and the plain step: equal bit for bit after each.  ``kept``
    keeps the box, mark, aux and mission planes (reset from random fresh
    layouts), else they are the family's fixed planes, as DoorKey's."""
    env = port.make("MiniGrid-Empty-5x5-v0")
    flags = {k: not kept for k in ("no_boxes", "no_marks", "fixed_mission", "fixed_aux")}
    env.params = env.params.replace(max_steps=100, see_through_walls=False).with_extra(**flags)
    g = torch.Generator(device=card).manual_seed(12)
    ls, first = _hand_made_lanes(card, env.params.max_steps, g)
    b, rounds, horizon = ls.agent_x.shape[0], 3, 3

    def random_like(x, lead=()):
        shape = (*lead, *x.shape)
        if x.dtype == torch.bool:
            return torch.randint(0, 2, shape, generator=g, device=card) == 1
        return torch.randint(0, 9, shape, generator=g, device=card, dtype=x.dtype)

    pool = ls.map(lambda x: random_like(x, (rounds,)))
    if autoreset == "regen":
        batch_first = tlanes.from_lanes(env.params, ls.map(random_like))
        env.generate = lambda generator, params, n, device: batch_first
    acts = torch.randint(0, 7, (horizon, b), generator=g, device=card, dtype=torch.int64)
    acts[0] = first
    scan = tlanes._Scan(env, g, pool, b, horizon, autoreset, rounds, acts)
    assert scan.path == "kernel"
    carry = scan.carry._replace(
        ls=ls, reset_count=torch.randint(0, 6, (b,), generator=g, device=card, dtype=torch.int32))
    plain = _kernel_steps_as_plain(scan, carry, horizon, f"hand-made {autoreset} kept={kept}")
    # The first step won, died in lava and truncated.
    assert int(plain.ends[0]) > int(plain.wins[0]) > 0
    assert int(plain.dones[0]) > int(plain.ends[0])


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,autoreset,kernel", [
    ("MiniGrid-DoorKey-8x8-v0", "pool", True),
    ("MiniGrid-DoorKey-8x8-v0", "regen", True),
    ("MiniGrid-Empty-5x5-v0", "cached", True),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", "pool", False),
    ("BabyAI-GoToLocal-v0", "pool", False),
])
def test_step_kernel_counts_its_launches(card, env_id, autoreset, kernel):
    """A graphed rollout launches the kernel step twice (the capture's
    warm-up and the capture), counted under its autoreset mode; a hooked
    family (Dynamic-Obstacles, a BabyAI id) calls the plain step twice
    instead and launches no kernel step."""
    env = port.make(env_id)
    names = ["lanes.step_kernel.launches", f"lanes.step_kernel.launches.{autoreset}",
             "lanes.plain_steps"]
    before = [profiling.counter(n) for n in names]
    tlanes.lane_rollout(env, torch.Generator(device=card).manual_seed(3), 512, 20, autoreset, 2,
                        device=card)
    got = [profiling.counter(n) - n0 for n, n0 in zip(names, before)]
    assert got == ([2, 2, 0] if kernel else [0, 0, 2])


@pytest.mark.cuda
def test_step_kernel_takes_a_rank_slice(card):
    """A rank's slice of a group's pool and actions (strided views, as
    ``shard_lanes`` gives them) steps through the kernel as a contiguous
    copy of them does."""
    env = port.make("MiniGrid-Empty-5x5-v0")  # T above max_steps=100: every lane resets
    b, horizon, rounds = 1024, 120, 2
    g = torch.Generator(device=card).manual_seed(5)
    pool = tlanes.lane_pool(env, g, 2 * b, "pool", rounds, card)
    acts = torch.randint(0, env.action_dim, (horizon, 2 * b), generator=g, device=card,
                         dtype=torch.int32)
    half = pool.map(lambda x: x[..., b:])
    assert not half.grid_obj.is_contiguous() and not acts[:, b:].is_contiguous()
    got = tlanes._lane_scan(env, None, half, b, horizon, "pool", rounds, acts[:, b:])
    want = tlanes._lane_scan(env, None, half.map(torch.Tensor.contiguous), b, horizon, "pool", rounds, acts[:, b:].contiguous())
    _assert_rollouts_equal(got, want)
    assert int(want.resets_per_env.min()) > 0


@pytest.mark.cuda
def test_step_kernel_refuses_other_inputs(card):
    """A plane or actions of another type, a pool of other rounds, a buffer
    on the CPU, a short or strided tensor, a batch-first layout in "pool"
    mode and a step limit set per episode raise before any launch, and
    leave the carry as it was; the inputs as the step passes them launch."""
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    b = 256
    g = torch.Generator(device=card).manual_seed(2)
    pool = tlanes.lane_pool(env, g, b, "pool", 2, card)
    scan = tlanes._Scan(env, g, pool, b, 4, "pool", 2, None)
    c = scan.carry
    acts = torch.zeros(b, dtype=torch.int32, device=card)
    before = c.ls.clone()
    launches = profiling.counter("lanes.step_kernel.launches")

    def call(**changes):
        kw = dict(params=env.params, ls=c.ls, reset_count=c.reset_count, fresh=pool, rounds=2,
                  actions=acts, t=c.t.view(1), reward=scan.reward, dones=c.dones, wins=c.wins,
                  ends=c.ends, autoreset="pool")
        kw.update(changes)
        tlanes.step_lanes_kernel(**kw)

    for changes in [
        dict(ls=c.ls.replace(grid_obj=c.ls.grid_obj.to(torch.int32))),
        dict(actions=acts.to(torch.int16)),
        dict(rounds=3),
        dict(reward=scan.reward.cpu()),
        dict(reset_count=c.reset_count[:-1]),
        dict(ls=c.ls.replace(agent_x=torch.stack([c.ls.agent_x, c.ls.agent_x], 1)[:, 0])),
        dict(fresh=env.generate(g, env.params, b, card)),
        dict(params=env.params.with_extra(dynamic_max_steps_slot=0)),
    ]:
        with pytest.raises(ValueError):
            call(**changes)
    assert profiling.counter("lanes.step_kernel.launches") == launches
    _assert_lanes_equal(c.ls, before, "refused")
    call()
    torch.cuda.synchronize()
    assert profiling.counter("lanes.step_kernel.launches") == launches + 1
    assert int(c.ls.step_count.min()) == 1


_DOORKEY_IDS = [f"MiniGrid-DoorKey-{n}x{n}-v0" for n in (5, 6, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "env_id, b",
    [(env_id, b) for env_id in _DOORKEY_IDS for b in (1, 127, 128, 4097, 65536)]
    + [("MiniGrid-DoorKey-8x8-v0", 262144)],
)
def test_doorkey_gen_kernel_equals_plain(card, env_id, b):
    """DoorKey's ``generate`` on the card (the five draws, then one launch
    of ``csrc/doorkey_gen.cu``) equals the plain generator from the same
    generator state, field by field, bit for bit, and the two generators'
    next draws are equal; at DoorKey-8x8 also at 262144 layouts, the pool
    rollout's launch."""
    from minigrid_dynamicprogramming_tpu_torch.envs import doorkey

    env = port.make(env_id)
    assert doorkey.generate_path(env, card) == "kernel"
    g = torch.Generator(device=card).manual_seed(11 + b)
    h = torch.Generator(device=card).set_state(g.get_state())
    launches = profiling.counter("generator.kernel.launches")
    got = env.generate(g, env.params, b, card)
    assert profiling.counter("generator.kernel.launches") == launches + 1
    want = doorkey.generate_plain(h, env.params, b, card)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), f.name
        assert torch.equal(x, y), f.name
    assert torch.equal(_next_draw(g), _next_draw(h))
    assert int((got.grid_obj == 5).sum()) == b  # 5: OBJ_KEY, one a layout


@pytest.mark.cuda
def test_doorkey_gen_counts_its_launches(card):
    """A regen rollout of DoorKey-8x8 launches the generator kernel once
    for its start layouts (``lane_pool``) and as often as its capture
    launches it (the warm-up step and the capture: 2), not once a replayed
    step; a GoToDoor ``generate`` launches it never."""
    names = ["generator.kernel.launches", "lanes.captures"]
    before = [profiling.counter(n) for n in names]
    env = port.make("MiniGrid-DoorKey-8x8-v0")
    tlanes.lane_rollout(env, torch.Generator(device=card).manual_seed(3), 512, 20, "regen",
                        device=card)
    torch.cuda.synchronize()
    got = [profiling.counter(n) - n0 for n, n0 in zip(names, before)]
    assert got == [3, 1]
    other = port.make("BabyAI-GoToDoor-v0")
    other.generate(torch.Generator(device=card).manual_seed(3), other.params, 64, card)
    assert profiling.counter("generator.kernel.launches") == before[0] + 3


@pytest.mark.cuda
def test_doorkey_gen_refuses_other_inputs(card):
    """Draws of another dtype, length, layout or device raise before any
    launch; the draws as ``generate`` makes them launch."""
    from minigrid_dynamicprogramming_tpu_torch.envs import doorkey

    env = port.make("MiniGrid-DoorKey-8x8-v0")
    b = 64
    g = torch.Generator(device=card).manual_seed(5)
    draws = dict(split=torch.randint(2, 6, (b,), generator=g, device=card, dtype=torch.int32),
                 agent_u=torch.rand(b, generator=g, device=card),
                 agent_dir=torch.randint(0, 4, (b,), generator=g, device=card, dtype=torch.int32),
                 door=torch.randint(1, 6, (b,), generator=g, device=card, dtype=torch.int32),
                 key_u=torch.rand(b, generator=g, device=card))
    launches = profiling.counter("generator.kernel.launches")
    for changes in [dict(split=draws["split"].long()), dict(agent_u=draws["agent_u"][:-1]),
                    dict(door=draws["door"].cpu()),
                    dict(key_u=torch.stack([draws["key_u"]] * 2, 1)[:, 0])]:
        with pytest.raises(ValueError):
            doorkey.layouts_kernel(env.params, **{**draws, **changes})
    assert profiling.counter("generator.kernel.launches") == launches
    state = doorkey.layouts_kernel(env.params, **draws)
    assert profiling.counter("generator.kernel.launches") == launches + 1
    assert bool((state.agent_pos[:, 0] < draws["split"]).all())
