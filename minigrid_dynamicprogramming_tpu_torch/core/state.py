"""Struct-of-tensors environment state, batch-first.

Counterpart of ``minigrid_dynamicprogramming_tpu/core/state.py``.  The JAX
``EnvState`` is one env's pytree that ``vmap`` batches; here the batch axis
is written out: planes are ``(B, H, W)``, per-env vectors ``(B, N)`` and
scalars ``(B,)``.  The generator builds this layout; the rollout runs on the
lane-major mirror in ``parallel/lanes.py``.

Two differences from the JAX record, both at the dtype level:

* ``marks``/``vmarks``/``carrying_marks`` are uint16 in JAX and int32 here
  (PyTorch on the CPU lacks compares and selects for uint16);
  ``bridge.py`` widens and narrows at the boundary.
* the per-env ``rng`` key is left out: no DoorKey hook consumes it, and
  random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_EMPTY

AUX_SLOTS = 24
MISSION_SLOTS = 48


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none.

    Entry points call this first, so a missing card is an error and never a
    silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclass
class EnvState:
    """Batch of environment states, batch-first."""

    grid_obj: torch.Tensor  # (B, H, W) u8
    grid_color: torch.Tensor  # (B, H, W) u8
    grid_state: torch.Tensor  # (B, H, W) u8
    contains_obj: torch.Tensor  # (B, H, W) u8
    contains_color: torch.Tensor  # (B, H, W) u8
    marks: torch.Tensor  # (B, H, W) i32 (u16 in JAX)
    vmarks: torch.Tensor  # (B, H, W) i32 (u16 in JAX)

    agent_pos: torch.Tensor  # (B, 2) i32 — (x, y)
    agent_dir: torch.Tensor  # (B,) i32
    carrying_obj: torch.Tensor  # (B,) u8
    carrying_color: torch.Tensor  # (B,) u8
    carrying_contains_obj: torch.Tensor  # (B,) u8
    carrying_contains_color: torch.Tensor  # (B,) u8
    carrying_marks: torch.Tensor  # (B,) i32 (u16 in JAX)

    step_count: torch.Tensor  # (B,) i32
    terminated: torch.Tensor  # (B,) bool
    truncated: torch.Tensor  # (B,) bool

    aux: torch.Tensor  # (B, AUX_SLOTS) i32
    mission: torch.Tensor  # (B, MISSION_SLOTS) i32

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def new_state(
    batch: int, height: int, width: int, device: torch.device
) -> EnvState:
    """Blank batch: all-empty grids, unplaced agents."""
    u8, i32 = torch.uint8, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    plane = (batch, height, width)
    return EnvState(
        grid_obj=full(plane, OBJ_EMPTY, u8),
        grid_color=full(plane, 0, u8),
        grid_state=full(plane, 0, u8),
        contains_obj=full(plane, OBJ_EMPTY, u8),
        contains_color=full(plane, 0, u8),
        marks=full(plane, 0, i32),
        vmarks=full(plane, 0, i32),
        agent_pos=full((batch, 2), -1, i32),
        agent_dir=full((batch,), -1, i32),
        carrying_obj=full((batch,), OBJ_EMPTY, u8),
        carrying_color=full((batch,), 0, u8),
        carrying_contains_obj=full((batch,), OBJ_EMPTY, u8),
        carrying_contains_color=full((batch,), 0, u8),
        carrying_marks=full((batch,), 0, i32),
        step_count=full((batch,), 0, i32),
        terminated=full((batch,), False, torch.bool),
        truncated=full((batch,), False, torch.bool),
        aux=full((batch, AUX_SLOTS), 0, i32),
        mission=full((batch, MISSION_SLOTS), 0, i32),
    )


@dataclass(frozen=True)
class EnvParams:
    """Static configuration shared by all env families (hashable).

    Family-specific extras live in ``extra``, a sorted tuple of key/value
    pairs, exactly as in the JAX record."""

    width: int = 8
    height: int = 8
    max_steps: int = 100
    see_through_walls: bool = False
    agent_view_size: int = 7
    extra: tuple = ()

    def opt(self, name: str, default: Any = None) -> Any:
        for k, v in self.extra:
            if k == name:
                return v
        return default

    def with_extra(self, **kwargs) -> "EnvParams":
        merged = dict(self.extra)
        merged.update(kwargs)
        return dataclasses.replace(self, extra=tuple(sorted(merged.items())))

    def replace(self, **changes) -> "EnvParams":
        return dataclasses.replace(self, **changes)
