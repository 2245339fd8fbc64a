"""Mission space: sampling and validation of mission strings.

Counterpart of ``minigrid_dynamicprogramming_tpu/core/mission.py`` (pure
Python and numpy, copied: the port imports nothing of the JAX package).
Host-side analog of the reference's ``MissionSpace``
(``minigrid/core/mission.py:14-203``) without the gymnasium
dependency: a template (``mission_func``) over ordered placeholder lists,
with ``sample()`` drawing placeholders through a NumPy PCG64 generator
(the same draw the reference makes, mission.py:67-78) and ``contains()``
performing the placeholder-parsing validation (mission.py:80-163),
including its edge-case semantics for overlapping and repeated
placeholders (those of the reference's ``tests/test_envs.py:262-306``).

On-device missions are integer code vectors (``EnvState.mission``); this
class is the *string-facing* surface for user code and space validation —
``mission_space_for(env_id)`` returns the space for any registered id,
with every template cited to the reference env that defines it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from minigrid_dynamicprogramming_tpu_torch.core.constants import COLOR_NAMES

__all__ = ["MissionSpace", "mission_space_for"]


class MissionSpace:
    """Space of mission strings generated by ``mission_func`` over ordered
    placeholder lists; ``contains`` validates by parsing placeholders back
    out of a candidate string."""

    def __init__(
        self,
        mission_func: Callable[..., str],
        ordered_placeholders: Optional[List[List[str]]] = None,
        seed: Optional[int] = None,
    ):
        if ordered_placeholders is not None:
            n_args = mission_func.__code__.co_argcount
            if len(ordered_placeholders) != n_args:
                raise ValueError(
                    f"{len(ordered_placeholders)} placeholder lists for a "
                    f"mission function of {n_args} parameters"
                )
            for lst in ordered_placeholders:
                if len(set(lst)) != len(lst):
                    raise ValueError(f"duplicate placeholders in {lst}")
        elif mission_func.__code__.co_argcount != 0:
            raise ValueError(
                "mission function must be parameterless without placeholders"
            )
        self.ordered_placeholders = ordered_placeholders
        self.mission_func = mission_func
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def sample(self) -> str:
        """One placeholder draw per list, in order (mission.py:67-78)."""
        if self.ordered_placeholders is None:
            return self.mission_func()
        picks = [
            lst[int(self._rng.integers(0, len(lst)))]
            for lst in self.ordered_placeholders
        ]
        return self.mission_func(*picks)

    def contains(self, x: str) -> bool:
        """Validate by locating placeholder occurrences in ``x``, dropping
        occurrences shadowed by longer overlapping ones, checking the
        surviving sequence against the ordered lists, and re-rendering."""
        if self.ordered_placeholders is None:
            return bool(self.mission_func() == x)

        # Every occurrence of every known placeholder: (start, end, text).
        seen = set()
        occurrences = []
        for lst in self.ordered_placeholders:
            for ph in lst:
                if ph in seen:
                    continue
                seen.add(ph)
                start = 0
                while True:
                    i = x.find(ph, start)
                    if i < 0:
                        break
                    occurrences.append((i, i + len(ph) - 1, ph))
                    start = i + 1
        occurrences.sort()

        # Overlapping occurrences: keep the longest (e.g. "go get the"
        # shadows "get the" at the same site, mission.py:118-137).
        kept = []
        for occ in occurrences:
            if kept and occ[0] <= kept[-1][1]:
                if len(occ[2]) > len(kept[-1][2]):
                    kept[-1] = occ
                continue
            kept.append(occ)
        finals = [ph for _, _, ph in kept]

        # The surviving placeholders must come from the right lists in
        # order (mission.py:144-152; extra/missing placeholders surface as
        # a render mismatch below).
        for lst, ph in zip(self.ordered_placeholders, finals):
            if ph not in lst:
                return False
        try:
            rendered = self.mission_func(*finals)
        except Exception:
            return False
        return bool(rendered == x)

    def __repr__(self) -> str:
        return f"MissionSpace({self.mission_func}, {self.ordered_placeholders})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, MissionSpace):
            return False
        a, b = self.ordered_placeholders, other.ordered_placeholders
        if (a is None) != (b is None):
            return False
        if a is None:
            return self.mission_func() == other.mission_func()
        if len(a) != len(b) or any(set(i) != set(j) for i, j in zip(a, b)):
            return False
        probe = [""] * len(a)
        return self.mission_func(*probe) == other.mission_func(*probe)


class _AcceptAll(MissionSpace):
    """BabyAI mission space: any string is a member
    (BabyAIMissionSpace, roomgrid_level.py:26-42)."""

    def __init__(self):
        super().__init__(mission_func=lambda: "go")

    def contains(self, x: str) -> bool:
        return True


# -- per-family spaces (each template cites its reference definition) --------

_OBJ_TYPES_FETCH = ["key", "ball"]  # fetch.py:76
_OBJ_TYPES3 = ["key", "ball", "box"]  # putnear.py:73, gotoobject.py:71
_FETCH_SYNTAX = [  # fetch.py:78-84
    "get a",
    "go get a",
    "fetch a",
    "go fetch a",
    "you must fetch a",
]


def _fixed(text: str) -> Callable[[], MissionSpace]:
    return lambda: MissionSpace(mission_func=lambda: text)


_FAMILY_SPACES: Sequence[tuple] = (
    # (id prefix/match fn, space factory)
    ("MiniGrid-Empty", _fixed("get to the green goal square")),  # empty.py:94-95
    (
        "MiniGrid-Dynamic-Obstacles",
        _fixed("get to the green goal square"),  # dynamicobstacles.py:108-109
    ),
    ("MiniGrid-DistShift", _fixed("get to the green goal square")),  # distshift.py:96-97
    (
        "MiniGrid-DoorKey",
        _fixed("use the key to open the door and then get to the goal"),  # doorkey.py:72-73
    ),
    ("MiniGrid-FourRooms", _fixed("reach the goal")),  # fourrooms.py:76-77
    (
        "MiniGrid-LavaCrossing",
        _fixed("avoid the lava and get to the green goal square"),  # crossing.py:115-116
    ),
    (
        "MiniGrid-SimpleCrossing",
        _fixed("find the opening and get to the green goal square"),  # crossing.py:119-120
    ),
    (
        "MiniGrid-LavaGap",
        _fixed("avoid the lava and get to the green goal square"),  # lavagap.py:94-95
    ),
    (
        "MiniGrid-Memory",
        _fixed("go to the matching object at the end of the hallway"),  # memory.py:91-92
    ),
    (
        "MiniGrid-MultiRoom",
        _fixed("traverse the rooms to get to the goal"),  # multiroom.py:109-110
    ),
    ("MiniGrid-Playground", _fixed("")),  # playground.py:28-29
    (
        "MiniGrid-RedBlueDoors",
        _fixed("open the red door then the blue door"),  # redbluedoors.py:78-79
    ),
    ("MiniGrid-Unlock-", _fixed("open the door")),  # unlock.py:73-74
    (
        "MiniGrid-Fetch",
        lambda: MissionSpace(  # fetch.py:86-89, :105-106
            mission_func=lambda syntax, color, obj_type: f"{syntax} {color} {obj_type}",
            ordered_placeholders=[_FETCH_SYNTAX, COLOR_NAMES, _OBJ_TYPES_FETCH],
        ),
    ),
    (
        "MiniGrid-GoToDoor",
        lambda: MissionSpace(  # gotodoor.py:69-72, :88-89
            mission_func=lambda color: f"go to the {color} door",
            ordered_placeholders=[COLOR_NAMES],
        ),
    ),
    (
        "MiniGrid-GoToObject",
        lambda: MissionSpace(  # gotoobject.py:73-76, :92-93
            mission_func=lambda color, obj_type: f"go to the {color} {obj_type}",
            ordered_placeholders=[COLOR_NAMES, _OBJ_TYPES3],
        ),
    ),
    (
        "MiniGrid-PutNear",
        lambda: MissionSpace(  # putnear.py:74-81, :98-101
            mission_func=lambda mc, mt, tc, tt: f"put the {mc} {mt} near the {tc} {tt}",
            ordered_placeholders=[COLOR_NAMES, _OBJ_TYPES3, COLOR_NAMES, _OBJ_TYPES3],
        ),
    ),
    (
        "MiniGrid-KeyCorridor",
        lambda: MissionSpace(  # keycorridor.py:84-87 (obj_type="ball", :78)
            mission_func=lambda color, obj_type: f"pick up the {color} {obj_type}",
            ordered_placeholders=[COLOR_NAMES, ["ball"]],
        ),
    ),
    (
        "MiniGrid-LockedRoom",
        lambda: MissionSpace(  # lockedroom.py:84-87, :97-101
            mission_func=lambda lc, kc, dc: (
                f"get the {lc} key from the {kc} room,"
                f" unlock the {dc} door and go to the goal"
            ),
            ordered_placeholders=[COLOR_NAMES] * 3,
        ),
    ),
    (
        "MiniGrid-UnlockPickup",
        lambda: MissionSpace(  # unlockpickup.py:62-65, :80-81
            mission_func=lambda color: f"pick up the {color} box",
            ordered_placeholders=[COLOR_NAMES],
        ),
    ),
    (
        "MiniGrid-BlockedUnlockPickup",
        lambda: MissionSpace(  # blockedunlockpickup.py:68-71, :87-88
            mission_func=lambda color, obj_type: f"pick up the {color} {obj_type}",
            ordered_placeholders=[COLOR_NAMES, ["box", "key"]],
        ),
    ),
    (
        "MiniGrid-ObstructedMaze",
        lambda: MissionSpace(  # obstructedmaze.py:94-97, :109-110
            mission_func=lambda color: f"pick up the {color} ball",
            ordered_placeholders=[[COLOR_NAMES[0]]],
        ),
    ),
    ("BabyAI-", _AcceptAll),
)


def mission_space_for(env_id: str) -> MissionSpace:
    """The mission space of any registered env id."""
    for prefix, factory in _FAMILY_SPACES:
        if env_id.startswith(prefix):
            return factory()
    raise KeyError(f"no mission space known for {env_id!r}")
