"""Environment registry: the ported ids, under the reference's names.

Counterpart of ``minigrid_dynamicprogramming_tpu/registry.py`` for the ids
ported so far (the four DoorKey sizes), with the same static plane-gate
flags that ``_reg`` attaches to each MiniGrid family.
"""

from __future__ import annotations

from typing import Callable, Dict

from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.doorkey import make_doorkey

_REGISTRY: Dict[str, Callable[[], Environment]] = {}

# Families that can never hold a Box, whose mission vector is one per-id
# constant, and that never write the aux vector: the step and the autoreset
# select skip those planes (parallel/lanes.py).
_BOX_FREE_FAMILIES = frozenset({"doorkey"})
_FIXED_MISSION_FAMILIES = frozenset({"doorkey"})
_FIXED_AUX_FAMILIES = frozenset({"doorkey"})


def _reg(env_id: str, factory, **kwargs) -> None:
    fam = factory.__name__.removeprefix("make_")

    def build() -> Environment:
        env = factory(env_id, **kwargs)
        flags = {"no_marks": True}
        if fam in _BOX_FREE_FAMILIES:
            flags["no_boxes"] = True
        if fam in _FIXED_MISSION_FAMILIES:
            flags["fixed_mission"] = True
        if fam in _FIXED_AUX_FAMILIES:
            flags["fixed_aux"] = True
        env.params = env.params.with_extra(**flags)
        return env

    _REGISTRY[env_id] = build


for _size in (5, 6, 8, 16):
    _reg(f"MiniGrid-DoorKey-{_size}x{_size}-v0", make_doorkey, size=_size)


def make(env_id: str) -> Environment:
    if env_id not in _REGISTRY:
        raise KeyError(
            f"environment id {env_id!r} is not ported to the PyTorch package "
            f"yet; ported ids: {registered_ids()}"
        )
    return _REGISTRY[env_id]()


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)
