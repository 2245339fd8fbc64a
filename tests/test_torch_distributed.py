"""The port's process groups and the sharded lane rollout.

* ``distributed.initialize`` forms a one-process gloo group, a second call
  does nothing, and ``process_summary`` reads ``process 0/1``.
* Two gloo processes run the sharded rollout on Empty-5x5 (batch 16,
  T=256, four pool rounds) from one fixed pool and one numpy action
  script: each rank's final state and resets equal its slice of the
  one-process run bit for bit; the all-reduced episodes, successes,
  failures and checksum equal the one-process run's exactly on both ranks,
  and the total reward is equal on both ranks and within 1e-6 relative of
  the one-process sum (float32 sums taken in another order); every rank
  has episodes.  This is JAX's ``tests/test_scaling.py`` two-process test
  and ``dryrun_multichip``'s legs 1 and 2.  With drawn inputs
  (``lane_rollout`` with a group, each rank's own generator) the ranks'
  streams differ and each rank has episodes; ``replicated`` gives rank 0's
  values on both ranks.
* The "regen" rollout with a group: each rank generates its own lanes
  from its own generator, so its final state and resets equal the
  ungrouped regen rollout of half the batch from the same seed, and the
  all-reduced episodes and checksum are the two halves' sums.
* ``shard_batch`` gives each rank the slice that JAX's ``P("env")`` puts
  on the same device of a mesh, on every axis it is used on.
"""

from __future__ import annotations

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import (
    EnvGroup,
    rank_seed,
    shard_batch,
    sharded_keys,
)

from ._torch_dist import PRELUDE, REPO, free_address, join, run_workers

torch.set_num_threads(1)

ENV_ID = "MiniGrid-Empty-5x5-v0"
B, T, ROUNDS = 16, 256, 4
REWARD_RTOL = 1e-6


def test_initialize_single_process():
    prog = PRELUDE + f"""
distributed.initialize(addr, num_processes=1, process_id=0, backend="gloo", max_retries=1,
                       timeout_s=60)
distributed.initialize()  # a second call does nothing
assert distributed.is_initialized()
group = distributed.global_env_group("cpu")
assert (group.rank, group.world_size, group.device.type) == (0, 1, "cpu"), group
print(distributed.process_summary())
"""
    out = subprocess.run(
        [sys.executable, "-c", prog, free_address(), "0", "-"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "process 0/1" in out.stdout
    assert "global_devices=1" in out.stdout


def test_initialize_needs_an_address(monkeypatch):
    from minigrid_dynamicprogramming_tpu_torch.parallel import distributed

    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.global_env_group()


_ROLLOUT_WORKER = join(2) + f"""
import numpy as np
import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import replicated, sharded_keys

group = distributed.global_env_group("cpu")
env = port.make("{ENV_ID}")
inputs = np.load(out + ".in.npz")
pool = from_numpy(L.LaneState, {{k[5:]: inputs[k] for k in inputs.files if k.startswith("pool_")}}, "cpu")
actions = torch.from_numpy(inputs["actions"])
res = L._lane_scan(
    env, None, L.shard_lanes(pool, group), {B} // 2, {T}, "pool", {ROUNDS},
    L.shard_batch(actions, group, axis=1), group,
)
drawn = L.lane_rollout(env, sharded_keys(5, group), {B}, {T}, "pool", {ROUNDS}, group=group)
rep = replicated(torch.tensor([rank, 10 + rank]), group)
np.savez(
    out,
    **{{"final_" + k: v for k, v in to_numpy(res.final_state).items()}},
    resets=res.resets_per_env.numpy(),
    scalars=np.array([int(res.episodes), int(res.successes), int(res.failures),
                      int(res.obs_checksum), res.steps]),
    total_reward=res.total_reward.numpy(),
    drawn_grid=drawn.final_state.grid_obj.numpy(),
    drawn_resets=drawn.resets_per_env.numpy(),
    drawn_episodes=int(drawn.episodes),
    replicated=rep.numpy(),
)
print("worker", rank, "ok", distributed.process_summary())
"""


def test_two_process_rollout_equals_one_process(tmp_path):
    env = port.make(ENV_ID)
    pool = L.lane_pool(env, torch.Generator().manual_seed(0), B, "pool", ROUNDS, torch.device("cpu"))
    actions = np.random.default_rng(0).integers(0, env.action_dim, (T, B)).astype(np.int64)
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    for o in outs:
        np.savez(str(o) + ".in.npz", actions=actions,
                 **{"pool_" + k: v for k, v in to_numpy(pool).items()})
    logs = run_workers(_ROLLOUT_WORKER, 2, outs)
    for r, log in enumerate(logs):
        assert f"worker {r} ok process {r}/2" in log, log

    single = L._lane_scan(env, None, pool, B, T, "pool", ROUNDS, torch.from_numpy(actions))
    want_final = to_numpy(single.final_state)
    want_scalars = [int(single.episodes), int(single.successes), int(single.failures),
                    int(single.obs_checksum), single.steps]
    dumps = [np.load(o) for o in outs]
    half = B // 2
    for r, d in enumerate(dumps):
        lanes = slice(r * half, (r + 1) * half)
        for name, want in want_final.items():
            np.testing.assert_array_equal(d["final_" + name], want[..., lanes], err_msg=f"rank {r} {name}")
        np.testing.assert_array_equal(d["resets"], single.resets_per_env.numpy()[lanes])
        assert d["resets"].sum() > 0, f"rank {r} ended no episode"
        assert d["scalars"].tolist() == want_scalars, (r, d["scalars"], want_scalars)
        np.testing.assert_allclose(d["total_reward"], single.total_reward.numpy(), rtol=REWARD_RTOL)
        assert d["drawn_episodes"] > 0 and d["drawn_resets"].sum() > 0, r
        np.testing.assert_array_equal(d["replicated"], [0, 10])
    assert want_scalars[0] > 0
    assert dumps[0]["total_reward"] == dumps[1]["total_reward"]
    assert dumps[0]["drawn_episodes"] == dumps[1]["drawn_episodes"]
    assert not np.array_equal(dumps[0]["drawn_grid"], dumps[1]["drawn_grid"]) or not np.array_equal(
        dumps[0]["drawn_resets"], dumps[1]["drawn_resets"]
    ), "the ranks drew the same stream"


_REGEN_WORKER = join(2) + f"""
import numpy as np
import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import sharded_keys

group = distributed.global_env_group("cpu")
env = port.make("MiniGrid-LavaGapS5-v0")
res = L.lane_rollout(env, sharded_keys(9, group), 16, 24, "regen", group=group)
np.savez(
    out,
    **{{"final_" + k: v for k, v in to_numpy(res.final_state).items()}},
    resets=res.resets_per_env.numpy(),
    scalars=np.array([int(res.episodes), int(res.obs_checksum), res.steps]),
)
print("worker", rank, "ok", distributed.process_summary())
"""


def test_two_process_regen_rollout_is_each_ranks_own(tmp_path):
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    logs = run_workers(_REGEN_WORKER, 2, outs)
    for r, log in enumerate(logs):
        assert f"worker {r} ok process {r}/2" in log, log
    env = port.make("MiniGrid-LavaGapS5-v0")
    episodes = checksum = 0
    for r, o in enumerate(outs):
        d = np.load(o)
        g = torch.Generator().manual_seed(rank_seed(9, r))
        own = L.lane_rollout(env, g, 8, 24, "regen", device="cpu")
        for name, want in to_numpy(own.final_state).items():
            np.testing.assert_array_equal(d["final_" + name], want, err_msg=f"rank {r} {name}")
        np.testing.assert_array_equal(d["resets"], own.resets_per_env.numpy())
        episodes += int(own.episodes)
        checksum += int(own.obs_checksum)
    for d in (np.load(o) for o in outs):
        assert d["scalars"].tolist() == [episodes, checksum % (1 << 32), 16 * 24]
    assert episodes > 0


def _groups(n: int):
    return [EnvGroup(None, r, n, torch.device("cpu")) for r in range(n)]


@pytest.mark.parametrize("shape, axis", [((8, 3, 5), 0), ((4, 8, 2), 1), ((3, 7, 8), -1)])
def test_shard_batch_equals_jax_env_layout(shape, axis):
    """Rank r's slice is what ``P("env")`` on the env axis puts on device r
    of a 4-device mesh (the suite's virtual CPU devices)."""
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    spec = [None] * len(shape)
    spec[axis] = "env"
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("env",))
    placed = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    tree = {"x": torch.from_numpy(x), "n": 3}
    for device, group in zip(mesh.devices, _groups(4)):
        got = shard_batch(tree, group, axis)
        np.testing.assert_array_equal(got["x"].numpy(), by_device[device])
        assert got["n"] == 3


def test_shard_batch_rejects_a_ragged_batch():
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros(6, 2), _groups(4)[1])
    with pytest.raises(ValueError, match="does not divide"):
        L.lane_rollout(port.make(ENV_ID), torch.Generator(), 6, 2, device="cpu", group=_groups(4)[0])


def test_sharded_keys_are_per_rank():
    a, b = (sharded_keys(3, g) for g in _groups(2))
    assert not torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert rank_seed(3, 0) == rank_seed(3, 0) != rank_seed(4, 0)
    one = EnvGroup(None, 0, 1, torch.device("cpu"))
    want = torch.Generator().manual_seed(rank_seed(3, 0))
    assert torch.equal(torch.rand(8, generator=sharded_keys(3, one)), torch.rand(8, generator=want))
