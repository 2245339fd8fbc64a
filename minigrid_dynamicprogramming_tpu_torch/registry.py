"""Environment registry: every id, under the reference's names.

Counterpart of ``minigrid_dynamicprogramming_tpu/registry.py``: all 171 of
the JAX package's ids (75 MiniGrid, 96 BabyAI), with the same kwargs and
the same static plane-gate flags that ``_reg`` attaches to each MiniGrid
family.  BabyAI ids get none of those flags: the verifier writes the
mark planes, the mission and the aux slots.
"""

from __future__ import annotations

from typing import Callable, Dict

from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.goto import (
    make_goto,
    make_goto_door,
    make_goto_imp_unlock,
    make_goto_local,
    make_goto_obj,
    make_goto_obj_door,
    make_goto_red_ball,
    make_goto_red_ball_grey,
    make_goto_red_blue_ball,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.levelgen import make_levelgen
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.open import (
    make_open,
    make_open_door,
    make_open_doors_order,
    make_open_red_door,
    make_open_two_doors,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.other import (
    make_action_obj_door,
    make_find_obj,
    make_key_corridor,
    make_move_two_across,
    make_one_room,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.pickup import (
    make_pickup,
    make_pickup_above,
    make_pickup_dist,
    make_putnext,
    make_putnext_local,
    make_unblock_pickup,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.unlock import (
    make_blocked_unlock_pickup,
    make_key_in_box,
    make_unlock_local,
    make_unlock_to_unlock,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.unlock import make_unlock as make_babyai_unlock
from minigrid_dynamicprogramming_tpu_torch.envs.babyai.unlock import (
    make_unlock_pickup as make_babyai_unlock_pickup,
)
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
_FAMILY: Dict[str, str] = {}  # env id -> family slug (factory name)


def register(env_id: str, factory: Callable[[], Environment]) -> None:
    """Register ``factory`` (no arguments, returns an :class:`Environment`)
    under ``env_id``, replacing any earlier registration."""
    _REGISTRY[env_id] = factory


def family(env_id: str) -> str:
    """Family slug of an id: its factory's name without ``make_``
    ("misc" for ids registered through :func:`register`)."""
    return _FAMILY.get(env_id, "misc")

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
        if env_id.startswith("BabyAI-"):
            return env
        flags = {"no_marks": True}
        if fam in _BOX_FREE_FAMILIES:
            flags["no_boxes"] = True
        if fam in _FIXED_MISSION_FAMILIES:
            flags["fixed_mission"] = True
        if fam in _FIXED_AUX_FAMILIES:
            flags["fixed_aux"] = True
        env.params = env.params.with_extra(**flags)
        return env

    register(env_id, build)
    _FAMILY[env_id] = fam


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

# BabyAI ids (the reference's minigrid/__init__.py:694-1130).
_reg("BabyAI-GoToRedBallGrey-v0", make_goto_red_ball_grey)
_reg("BabyAI-GoToRedBall-v0", make_goto_red_ball)
_reg("BabyAI-GoToRedBallNoDists-v0", make_goto_red_ball, num_dists=0)
_reg("BabyAI-GoToObj-v0", make_goto_obj)
_reg("BabyAI-GoToObjS4-v0", make_goto_obj, room_size=4)
_reg("BabyAI-GoToObjS6-v1", make_goto_obj, room_size=6)
_reg("BabyAI-GoToLocal-v0", make_goto_local)
for _rs, _nd in [(5, 2), (6, 2), (6, 3), (6, 4), (7, 4), (7, 5),
                 (8, 2), (8, 3), (8, 4), (8, 5), (8, 6), (8, 7)]:
    _reg(f"BabyAI-GoToLocalS{_rs}N{_nd}-v0", make_goto_local, room_size=_rs, num_dists=_nd)
_reg("BabyAI-GoTo-v0", make_goto)
_reg("BabyAI-GoToOpen-v0", make_goto, doors_open=True)
_reg("BabyAI-GoToObjMaze-v0", make_goto, num_dists=1)
_reg("BabyAI-GoToObjMazeOpen-v0", make_goto, num_dists=1, doors_open=True)
_reg("BabyAI-GoToObjMazeS4R2-v0", make_goto, num_dists=1, room_size=4, num_rows=2, num_cols=2)
for _rs in (4, 5, 6, 7):
    _reg(f"BabyAI-GoToObjMazeS{_rs}-v0", make_goto, num_dists=1, room_size=_rs)
_reg("BabyAI-GoToImpUnlock-v0", make_goto_imp_unlock)
_reg("BabyAI-GoToRedBlueBall-v0", make_goto_red_blue_ball)
_reg("BabyAI-GoToDoor-v0", make_goto_door)
_reg("BabyAI-GoToObjDoor-v0", make_goto_obj_door)

_reg("BabyAI-Open-v0", make_open)
_reg("BabyAI-OpenRedDoor-v0", make_open_red_door)
_reg("BabyAI-OpenDoor-v0", make_open_door)
_reg("BabyAI-OpenDoorColor-v0", make_open_door, select_by="color")
_reg("BabyAI-OpenDoorLoc-v0", make_open_door, select_by="loc")
_reg("BabyAI-OpenDoorDebug-v0", make_open_door, debug=True, select_by=None)
_reg("BabyAI-OpenTwoDoors-v0", make_open_two_doors)
_reg("BabyAI-OpenRedBlueDoors-v0", make_open_two_doors, first_color="red", second_color="blue")
_reg("BabyAI-OpenRedBlueDoorsDebug-v0", make_open_two_doors,
     first_color="red", second_color="blue", strict=True)
for _n in (2, 4):
    _reg(f"BabyAI-OpenDoorsOrderN{_n}-v0", make_open_doors_order, num_doors=_n)
    _reg(f"BabyAI-OpenDoorsOrderN{_n}Debug-v0", make_open_doors_order, num_doors=_n, debug=True)

_reg("BabyAI-Pickup-v0", make_pickup)
_reg("BabyAI-UnblockPickup-v0", make_unblock_pickup)
_reg("BabyAI-PickupDist-v0", make_pickup_dist)
_reg("BabyAI-PickupDistDebug-v0", make_pickup_dist, debug=True)
_reg("BabyAI-PickupAbove-v0", make_pickup_above)
_reg("BabyAI-PutNextLocal-v0", make_putnext_local)
_reg("BabyAI-PutNextLocalS5N3-v0", make_putnext_local, room_size=5, num_objs=3)
_reg("BabyAI-PutNextLocalS6N4-v0", make_putnext_local, room_size=6, num_objs=4)
for _rs, _n in [(4, 1), (5, 1), (5, 2), (6, 3), (7, 4)]:
    _reg(f"BabyAI-PutNextS{_rs}N{_n}-v0", make_putnext, room_size=_rs, objs_per_room=_n)
for _rs, _n in [(5, 2), (6, 3), (7, 4)]:
    _reg(f"BabyAI-PutNextS{_rs}N{_n}Carrying-v0", make_putnext,
         room_size=_rs, objs_per_room=_n, start_carrying=True)

_reg("BabyAI-Unlock-v0", make_babyai_unlock)
_reg("BabyAI-UnlockLocal-v0", make_unlock_local)
_reg("BabyAI-UnlockLocalDist-v0", make_unlock_local, distractors=True)
_reg("BabyAI-KeyInBox-v0", make_key_in_box)
_reg("BabyAI-UnlockPickup-v0", make_babyai_unlock_pickup)
_reg("BabyAI-UnlockPickupDist-v0", make_babyai_unlock_pickup, distractors=True)
_reg("BabyAI-BlockedUnlockPickup-v0", make_blocked_unlock_pickup)
_reg("BabyAI-UnlockToUnlock-v0", make_unlock_to_unlock)

_reg("BabyAI-ActionObjDoor-v0", make_action_obj_door)
for _rs in (5, 6, 7):
    _reg(f"BabyAI-FindObjS{_rs}-v0", make_find_obj, room_size=_rs)
_reg("BabyAI-KeyCorridor-v0", make_key_corridor)
for _rs, _nr in [(3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)]:
    _reg(f"BabyAI-KeyCorridorS{_rs}R{_nr}-v0", make_key_corridor, room_size=_rs, num_rows=_nr)
for _rs in (8, 12, 16, 20):
    _reg(f"BabyAI-OneRoomS{_rs}-v0", make_one_room, room_size=_rs)
_reg("BabyAI-MoveTwoAcrossS5N2-v0", make_move_two_across, room_size=5, objs_per_room=2)
_reg("BabyAI-MoveTwoAcrossS8N9-v0", make_move_two_across, room_size=8, objs_per_room=9)

_reg("BabyAI-GoToSeq-v0", make_levelgen, action_kinds=("goto",),
     locked_room_prob=0, locations=False, unblocking=False)
_reg("BabyAI-GoToSeqS5R2-v0", make_levelgen, action_kinds=("goto",),
     locked_room_prob=0, locations=False, unblocking=False,
     room_size=5, num_rows=2, num_cols=2, num_dists=4)
_reg("BabyAI-PickupLoc-v0", make_levelgen, action_kinds=("pickup",),
     instr_kinds=("action",), num_rows=1, num_cols=1, num_dists=8,
     locked_room_prob=0, locations=True, unblocking=False)
_reg("BabyAI-Synth-v0", make_levelgen, instr_kinds=("action",),
     locations=False, unblocking=True, implicit_unlock=False)
_reg("BabyAI-SynthS5R2-v0", make_levelgen, instr_kinds=("action",),
     locations=False, unblocking=True, implicit_unlock=False, room_size=5, num_rows=2)
_reg("BabyAI-SynthLoc-v0", make_levelgen, instr_kinds=("action",),
     locations=True, unblocking=True, implicit_unlock=False)
_reg("BabyAI-SynthSeq-v0", make_levelgen, locations=True, unblocking=True, implicit_unlock=False)
_reg("BabyAI-MiniBossLevel-v0", make_levelgen, num_cols=2, num_rows=2,
     room_size=5, num_dists=7, locked_room_prob=0.25)
_reg("BabyAI-BossLevel-v0", make_levelgen)
_reg("BabyAI-BossLevelNoUnlock-v0", make_levelgen, locked_room_prob=0, implicit_unlock=False)


def make(env_id: str) -> Environment:
    if env_id not in _REGISTRY:
        raise KeyError(
            f"unknown environment id {env_id!r}; registered ids: {registered_ids()}"
        )
    return _REGISTRY[env_id]()


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)
