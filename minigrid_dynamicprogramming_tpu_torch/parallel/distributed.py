"""Multi-process group initialization.

Counterpart of ``minigrid_dynamicprogramming_tpu/parallel/distributed.py``.
JAX's multi-controller runtime has every host run the same program and
``jax.distributed.initialize`` form the group; here every rank runs the
same program and :func:`initialize` forms a ``torch.distributed`` process
group over a TCP rendezvous.  A rank drives one device; the env axis is
split over the ranks (``parallel/sharding.py``), so stepping needs no
communication and only metric reductions and the learner's gradient
all-reduce cross ranks.

Usage (same script on every rank)::

    from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
    distributed.initialize()            # from torchrun's environment
    group = distributed.global_env_group()
    res = lane_rollout(env, sharded_keys(0, group), batch, horizon, group=group)

Without arguments :func:`initialize` reads ``torchrun``'s variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``); elsewhere pass ``coordinator_address`` ("host:port"),
``num_processes`` and ``process_id``.  The backend is NCCL where CUDA is
available and gloo otherwise; pass ``backend="gloo"`` for CPU tensors on
a machine with a card, or for two ranks that share one card (NCCL refuses
them).  Importing this module touches no device.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import EnvGroup, env_group

# The default bound of every rendezvous and collective, in seconds.
TIMEOUT_S = 300.0

_local_device_ids: Optional[Sequence[int]] = None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    max_retries: int = 3,
    retry_delay_s: float = 5.0,
    backend: Optional[str] = None,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """Join (or form) the process group, with bounded retries.

    A coordinator that is still coming up is retried ``max_retries`` times,
    ``retry_delay_s`` apart, before this raises.  Every rendezvous and
    collective of the group is bounded by ``timeout_s``.  A second call
    does nothing.  ``local_device_ids[0]`` is the card this rank drives
    (default: ``LOCAL_RANK``, else 0)."""
    global _local_device_ids
    if is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "pass coordinator_address, num_processes and process_id, or run under "
            "torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)"
        )
    if local_device_ids is None:
        local_device_ids = [_env_int("LOCAL_RANK") or 0]
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(resolve_device(f"cuda:{local_device_ids[0]}"))
    last_err: Optional[Exception] = None
    for attempt in range(max_retries):
        try:
            dist.init_process_group(
                backend,
                init_method=f"tcp://{coordinator_address}",
                world_size=num_processes,
                rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s),
            )
            _local_device_ids = list(local_device_ids)
            return
        except (RuntimeError, ValueError) as err:  # DistNetworkError is a RuntimeError
            last_err = err
            if attempt + 1 < max_retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(
        f"torch.distributed.init_process_group failed after {max_retries} attempts"
    ) from last_err


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_env_group(device=None) -> EnvGroup:
    """The :class:`EnvGroup` over every rank of the default group, this
    rank's envs on ``device``: ``cuda:{local device}`` by default, the CPU
    only when asked (``device="cpu"``)."""
    if not is_initialized():
        raise RuntimeError("call distributed.initialize() first")
    if device is None:
        device = f"cuda:{(_local_device_ids or [0])[0]}"
    return env_group(resolve_device(device))


def process_summary() -> str:
    """One line for start-up logs.  A rank drives one device, so the group
    spans ``world_size`` devices."""
    rank = dist.get_rank() if is_initialized() else 0
    world = dist.get_world_size() if is_initialized() else 1
    return f"process {rank}/{world} local_devices=1 global_devices={world}"
