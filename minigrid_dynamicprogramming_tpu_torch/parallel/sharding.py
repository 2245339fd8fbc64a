"""Environment batches split over a ``torch.distributed`` process group.

Counterpart of ``minigrid_dynamicprogramming_tpu/parallel/sharding.py``.
JAX lays a batch out over a 1-D ``Mesh`` whose one axis, ``"env"``, spans
every device; here each rank of a process group drives one device and
holds a contiguous slice of the env axis: rank r of N holds envs
``[r*B/N, (r+1)*B/N)``, the layout JAX's ``P("env")`` gives.  Stepping
needs no communication (the envs are independent); collectives appear only
in the metric reductions, the learner's all-gather of the trajectory and
its gradient all-reduce.

:class:`EnvGroup` takes the place of the mesh: the process group, this
rank, the world size and the device the rank's tensors live on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

ENV_AXIS = "env"


@dataclass(frozen=True)
class EnvGroup:
    """One rank's view of the ``env`` axis: ``group`` is the process group
    (None for the default one), ``rank`` and ``world_size`` are within it,
    ``device`` holds this rank's envs."""

    group: Optional[Any]
    rank: int
    world_size: int
    device: torch.device

    def slice(self, n: int) -> slice:
        """This rank's part of an axis of ``n`` envs."""
        if n % self.world_size:
            raise ValueError(
                f"a batch of {n} envs does not divide over {self.world_size} ranks"
            )
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


def env_group(device, group=None) -> EnvGroup:
    """The :class:`EnvGroup` of this process in ``group`` (the default
    group if None), its envs on ``device``.  The group must exist."""
    return EnvGroup(
        group=group,
        rank=dist.get_rank(group),
        world_size=dist.get_world_size(group),
        device=torch.device(device),
    )


def _map(fn, tree):
    """``fn`` over every tensor of a nested dict, list, tuple, NamedTuple or
    dataclass; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(
            **{f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(tree, group: EnvGroup, axis: int = 0):
    """This rank's contiguous slice of every tensor's env axis ``axis``, on
    the rank's device; raises ``ValueError`` where the axis does not divide
    by the world size.  ``axis`` is -1 for a lane-major state (its envs are
    the last axis) and 1 for a ``(T, B, ...)`` trajectory."""

    def take(x: torch.Tensor) -> torch.Tensor:
        s = group.slice(x.shape[axis])
        return x.narrow(axis, s.start, s.stop - s.start).to(group.device)

    return _map(take, tree)


def replicated(tree, group: EnvGroup):
    """Every tensor of ``tree`` on the rank's device, equal on every rank:
    rank 0's values, broadcast."""
    src = dist.get_global_rank(group.group, 0) if group.group is not None else 0

    def bcast(x: torch.Tensor) -> torch.Tensor:
        x = x.to(group.device).contiguous()
        if group.world_size > 1:
            dist.broadcast(x, src=src, group=group.group)
        return x

    return _map(bcast, tree)


def all_reduce(t: torch.Tensor, group: Optional[EnvGroup]) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place; as it is without a
    group."""
    if group is not None:
        dist.all_reduce(t, group=group.group)
    return t


def all_gather(out: torch.Tensor, t: torch.Tensor, group: EnvGroup) -> torch.Tensor:
    """Every rank's ``t`` into ``out``, a contiguous tensor of
    ``world_size`` times ``t``'s elements: viewed as ``(world_size,
    *t.shape)``, it holds rank r's ``t`` at ``[r]``.  Every rank gives the
    same shape.  Returns ``out``."""
    # The one call of fixed size; torch renames it all_gather_single.
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out.view(-1, *t.shape[1:]), t.contiguous(), group=group.group)
    return out


def captures_collectives(group: Optional[EnvGroup]) -> bool:
    """Whether a CUDA graph can hold the group's collectives on its
    device: NCCL's run on the card's streams and can; gloo's on CUDA
    tensors go through the host and cannot.  True without a group, which
    has none."""
    if group is None:
        return True
    backend = dist.get_backend(group.group)
    # One backend ("nccl"), or one a device type ("cpu:gloo,cuda:nccl").
    per_type = dict(b.split(":") for b in backend.split(",") if ":" in b)
    return per_type.get(group.device.type, backend) == "nccl"


def rank_seed(seed: int, rank: int) -> int:
    """A 63-bit seed mixed from ``(seed, rank)``: the streams of two ranks,
    or of two seeds, are unrelated."""
    state = np.random.SeedSequence(seed, spawn_key=(rank,)).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def sharded_keys(seed: int, group: EnvGroup) -> torch.Generator:
    """The rank's own generator on its device, seeded from ``(seed,
    rank)``: what JAX's keys split along the ``env`` axis give each shard.
    A one-rank group's generator is ``rank_seed(seed, 0)``'s, so it draws
    what an ungrouped run seeded alike draws."""
    return torch.Generator(device=group.device).manual_seed(rank_seed(seed, group.rank))
