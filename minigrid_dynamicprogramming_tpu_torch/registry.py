"""Environment registry: the ported ids, under the reference's names.

Counterpart of ``minigrid_dynamicprogramming_tpu/registry.py`` for the ids
ported so far: all 75 of the JAX package's MiniGrid ids, with the same
kwargs and the same static plane-gate flags that ``_reg`` attaches to
each MiniGrid family.
"""

from __future__ import annotations

from typing import Callable, Dict

from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.crossing import make_crossing
from minigrid_dynamicprogramming_tpu_torch.envs.distshift import make_distshift
from minigrid_dynamicprogramming_tpu_torch.envs.doorkey import make_doorkey
from minigrid_dynamicprogramming_tpu_torch.envs.dynamicobstacles import (
    make_dynamicobstacles,
)
from minigrid_dynamicprogramming_tpu_torch.envs.empty import make_empty
from minigrid_dynamicprogramming_tpu_torch.envs.fetch import make_fetch
from minigrid_dynamicprogramming_tpu_torch.envs.fourrooms import make_fourrooms
from minigrid_dynamicprogramming_tpu_torch.envs.gotodoor import make_gotodoor
from minigrid_dynamicprogramming_tpu_torch.envs.gotoobject import make_gotoobject
from minigrid_dynamicprogramming_tpu_torch.envs.keycorridor import make_keycorridor
from minigrid_dynamicprogramming_tpu_torch.envs.lavagap import make_lavagap
from minigrid_dynamicprogramming_tpu_torch.envs.lockedroom import make_lockedroom
from minigrid_dynamicprogramming_tpu_torch.envs.memory import make_memory
from minigrid_dynamicprogramming_tpu_torch.envs.multiroom import make_multiroom
from minigrid_dynamicprogramming_tpu_torch.envs.obstructedmaze import (
    make_obstructedmaze_1d,
    make_obstructedmaze_full,
)
from minigrid_dynamicprogramming_tpu_torch.envs.playground import make_playground
from minigrid_dynamicprogramming_tpu_torch.envs.putnear import make_putnear
from minigrid_dynamicprogramming_tpu_torch.envs.redbluedoors import make_redbluedoors
from minigrid_dynamicprogramming_tpu_torch.envs.unlock import (
    make_blockedunlockpickup,
    make_unlock,
    make_unlockpickup,
)

_REGISTRY: Dict[str, Callable[[], Environment]] = {}

# Families that can never hold a Box (nor, being MiniGrid, a verifier
# mark), whose mission vector is one per-id constant, and that never write
# the aux vector: the step and the autoreset select skip those planes
# (parallel/lanes.py).  The JAX package's sets, whole: a set wider than
# JAX's would carry a stale target across a reset.
_BOX_FREE_FAMILIES = frozenset({
    "empty", "doorkey", "fourrooms", "crossing", "distshift", "lavagap",
    "dynamicobstacles", "fetch", "gotodoor", "lockedroom", "memory",
    "multiroom", "redbluedoors", "keycorridor",
})
_FIXED_MISSION_FAMILIES = frozenset({
    "empty", "doorkey", "fourrooms", "crossing", "distshift", "lavagap",
    "dynamicobstacles", "multiroom", "redbluedoors", "memory", "playground",
})
_FIXED_AUX_FAMILIES = frozenset({
    "empty", "doorkey", "fourrooms", "crossing", "distshift", "lavagap",
    "multiroom", "playground", "lockedroom",
})


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


# The reference's MiniGrid registration table, same ids and kwargs.
for _size, _n in [(9, 1), (9, 2), (9, 3), (11, 5)]:
    _reg(f"MiniGrid-LavaCrossingS{_size}N{_n}-v0", make_crossing,
         size=_size, num_crossings=_n, obstacle="lava")
    _reg(f"MiniGrid-SimpleCrossingS{_size}N{_n}-v0", make_crossing,
         size=_size, num_crossings=_n, obstacle="wall")

_reg("MiniGrid-DistShift1-v0", make_distshift, strip2_row=2)
_reg("MiniGrid-DistShift2-v0", make_distshift, strip2_row=5)

for _size in (5, 6, 8, 16):
    _reg(f"MiniGrid-DoorKey-{_size}x{_size}-v0", make_doorkey, size=_size)

_reg("MiniGrid-Dynamic-Obstacles-5x5-v0", make_dynamicobstacles, size=5, n_obstacles=2)
_reg("MiniGrid-Dynamic-Obstacles-Random-5x5-v0", make_dynamicobstacles,
     size=5, agent_start_pos=None, n_obstacles=2)
_reg("MiniGrid-Dynamic-Obstacles-6x6-v0", make_dynamicobstacles, size=6, n_obstacles=3)
_reg("MiniGrid-Dynamic-Obstacles-Random-6x6-v0", make_dynamicobstacles,
     size=6, agent_start_pos=None, n_obstacles=3)
_reg("MiniGrid-Dynamic-Obstacles-8x8-v0", make_dynamicobstacles, size=8)
_reg("MiniGrid-Dynamic-Obstacles-16x16-v0", make_dynamicobstacles, size=16, n_obstacles=8)

for _size in (5, 6, 8, 16):
    _reg(f"MiniGrid-Empty-{_size}x{_size}-v0", make_empty, size=_size)
for _size in (5, 6):
    _reg(f"MiniGrid-Empty-Random-{_size}x{_size}-v0", make_empty,
         size=_size, agent_start_pos=None)

_reg("MiniGrid-Fetch-5x5-N2-v0", make_fetch, size=5, num_objs=2)
_reg("MiniGrid-Fetch-6x6-N2-v0", make_fetch, size=6, num_objs=2)
_reg("MiniGrid-Fetch-8x8-N3-v0", make_fetch)

_reg("MiniGrid-FourRooms-v0", make_fourrooms)

for _size in (5, 6, 8):
    _reg(f"MiniGrid-GoToDoor-{_size}x{_size}-v0", make_gotodoor, size=_size)

_reg("MiniGrid-GoToObject-6x6-N2-v0", make_gotoobject)
_reg("MiniGrid-GoToObject-8x8-N2-v0", make_gotoobject, size=8, num_objs=2)

for _size in (5, 6, 7):
    _reg(f"MiniGrid-LavaGapS{_size}-v0", make_lavagap, size=_size)

_reg("MiniGrid-LockedRoom-v0", make_lockedroom)

_reg("MiniGrid-MemoryS17Random-v0", make_memory, size=17, random_length=True)
_reg("MiniGrid-MemoryS13Random-v0", make_memory, size=13, random_length=True)
for _size in (13, 11, 9, 7):
    _reg(f"MiniGrid-MemoryS{_size}-v0", make_memory, size=_size)

_reg("MiniGrid-Playground-v0", make_playground)

_reg("MiniGrid-PutNear-6x6-N2-v0", make_putnear)
_reg("MiniGrid-PutNear-8x8-N3-v0", make_putnear, size=8, num_objs=3)

_reg("MiniGrid-RedBlueDoors-6x6-v0", make_redbluedoors, size=6)
_reg("MiniGrid-RedBlueDoors-8x8-v0", make_redbluedoors)

for _rs, _nr in [(3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)]:
    _reg(f"MiniGrid-KeyCorridorS{_rs}R{_nr}-v0", make_keycorridor,
         room_size=_rs, num_rows=_nr)

# MultiRoom-N4-S5 registers six rooms, as the reference does.
_reg("MiniGrid-MultiRoom-N2-S4-v0", make_multiroom,
     min_num_rooms=2, max_num_rooms=2, max_room_size=4)
_reg("MiniGrid-MultiRoom-N4-S5-v0", make_multiroom,
     min_num_rooms=6, max_num_rooms=6, max_room_size=5)
_reg("MiniGrid-MultiRoom-N6-v0", make_multiroom, min_num_rooms=6, max_num_rooms=6)

_reg("MiniGrid-ObstructedMaze-1Dl-v0", make_obstructedmaze_1d,
     key_in_box=False, blocked=False)
_reg("MiniGrid-ObstructedMaze-1Dlh-v0", make_obstructedmaze_1d,
     key_in_box=True, blocked=False)
_reg("MiniGrid-ObstructedMaze-1Dlhb-v0", make_obstructedmaze_1d,
     key_in_box=True, blocked=True)
_reg("MiniGrid-ObstructedMaze-2Dl-v0", make_obstructedmaze_full, agent_room=(2, 1),
     key_in_box=False, blocked=False, num_quarters=1, num_rooms_visited=4)
_reg("MiniGrid-ObstructedMaze-2Dlh-v0", make_obstructedmaze_full, agent_room=(2, 1),
     key_in_box=True, blocked=False, num_quarters=1, num_rooms_visited=4)
for _ver in ("v0", "v1"):
    _v1 = _ver == "v1"
    _reg(f"MiniGrid-ObstructedMaze-2Dlhb-{_ver}", make_obstructedmaze_full,
         agent_room=(2, 1), key_in_box=True, blocked=True, num_quarters=1,
         num_rooms_visited=4, v1=_v1)
    _reg(f"MiniGrid-ObstructedMaze-1Q-{_ver}", make_obstructedmaze_full,
         agent_room=(1, 1), key_in_box=True, blocked=True, num_quarters=1,
         num_rooms_visited=5, v1=_v1)
    _reg(f"MiniGrid-ObstructedMaze-2Q-{_ver}", make_obstructedmaze_full,
         agent_room=(2, 1), key_in_box=True, blocked=True, num_quarters=2,
         num_rooms_visited=11, v1=_v1)
    _reg(f"MiniGrid-ObstructedMaze-Full-{_ver}", make_obstructedmaze_full, v1=_v1)

_reg("MiniGrid-Unlock-v0", make_unlock)
_reg("MiniGrid-UnlockPickup-v0", make_unlockpickup)
_reg("MiniGrid-BlockedUnlockPickup-v0", make_blockedunlockpickup)


def make(env_id: str) -> Environment:
    if env_id not in _REGISTRY:
        raise KeyError(
            f"environment id {env_id!r} is not ported to the PyTorch package "
            f"yet; ported ids: {registered_ids()}"
        )
    return _REGISTRY[env_id]()


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)
