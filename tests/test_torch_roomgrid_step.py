"""The port's lane-major step, post-step hooks included, and observation
against the JAX package's on all 26 ids of the RoomGrid families, MultiRoom
and Playground (``_torch_families.step_obs_parity`` says how): bit for bit,
the reward within 1e-6.

Each case requires the event its hook exists for.  A random walk seldom
reaches a target behind a locked door, so the JAX layouts are first set up
in every other lane where the cell allows it: for the pickup-target
families (KeyCorridor, UnlockPickup, BlockedUnlockPickup, ObstructedMaze)
the agent stands next to the target facing it, and a pickup pays; for
Unlock the agent carries the door's key and faces the locked door from
its left, and a toggle opens it and pays.  MultiRoom and
Playground have no hook: their event is the step limit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    DIR_TO_VEC,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    STATE_OPEN,
)

from ._torch_families import step_obs_parity

torch.set_num_threads(1)


def target_in_reach(s: dict) -> dict:
    """In every other lane, the agent stands next to the target named by
    aux 0-1, facing it: on an empty neighbour of the target or, where the
    target has none (KeyCorridorS3R1's one-cell rooms), in the door next
    to it, opened."""
    obj, st = s["grid_obj"], s["grid_state"].copy()
    pos, d = s["agent_pos"].copy(), s["agent_dir"].copy()
    for b in range(0, len(obj), 2):
        y, x = np.argwhere((obj[b] == s["aux"][b, 0]) & (s["grid_color"][b] == s["aux"][b, 1]))[0]
        stands = [(x - DIR_TO_VEC[k, 0], y - DIR_TO_VEC[k, 1], k) for k in range(4)]
        for kind in (OBJ_EMPTY, OBJ_DOOR):
            free = [(sx, sy, k) for sx, sy, k in stands if obj[b, sy, sx] == kind]
            if free:
                sx, sy, k = free[0]
                break
        st[b, sy, sx] = STATE_OPEN if kind == OBJ_DOOR else st[b, sy, sx]
        pos[b], d[b] = (sx, sy), k
    return {**s, "grid_state": st, "agent_pos": pos, "agent_dir": d}


def unlock_ready(s: dict) -> dict:
    """In every other lane, the agent carries the door's key and faces the
    locked door (aux 0-1) from the cell left of it, where that cell is
    free once the key is lifted."""
    obj, color = s["grid_obj"].copy(), s["grid_color"].copy()
    pos, d = s["agent_pos"].copy(), s["agent_dir"].copy()
    carry, carry_color = s["carrying_obj"].copy(), s["carrying_color"].copy()
    ready = 0
    for b in range(0, len(obj), 2):
        x, y = s["aux"][b, 0], s["aux"][b, 1]
        key = np.argwhere(obj[b] == OBJ_KEY)[0]
        stand = obj[b, y, x - 1]
        if stand != OBJ_EMPTY and (key[0], key[1]) != (y, x - 1):
            continue
        obj[b, key[0], key[1]], color[b, key[0], key[1]] = OBJ_EMPTY, 0
        carry[b], carry_color[b] = OBJ_KEY, color[b, y, x]
        pos[b], d[b] = (x - 1, y), 0
        ready += 1
    assert ready > 0
    return {
        **s, "grid_obj": obj, "grid_color": color, "agent_pos": pos, "agent_dir": d,
        "carrying_obj": carry, "carrying_color": carry_color,
    }


_OBSTRUCTED = [
    "1Dl-v0", "1Dlh-v0", "1Dlhb-v0", "2Dl-v0", "2Dlh-v0", "2Dlhb-v0", "2Dlhb-v1",
    "1Q-v0", "1Q-v1", "2Q-v0", "2Q-v1", "Full-v0", "Full-v1",
]
# (id, the events its hook must produce, the set-up of its layouts)
CASES = (
    [(f"MiniGrid-KeyCorridorS{s}R{r}-v0", ("reward",), target_in_reach)
     for s, r in [(3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)]]
    + [(f"MiniGrid-ObstructedMaze-{v}", ("reward",), target_in_reach) for v in _OBSTRUCTED]
    + [
        ("MiniGrid-Unlock-v0", ("reward",), unlock_ready),
        ("MiniGrid-UnlockPickup-v0", ("reward",), target_in_reach),
        ("MiniGrid-BlockedUnlockPickup-v0", ("reward",), target_in_reach),
        ("MiniGrid-MultiRoom-N2-S4-v0", ("truncated",), None),
        ("MiniGrid-MultiRoom-N4-S5-v0", ("truncated",), None),
        ("MiniGrid-MultiRoom-N6-v0", ("truncated",), None),
        ("MiniGrid-Playground-v0", ("truncated",), None),
    ]
)


# ObstructedMaze's 13 ids run in test_torch_roomgrid_step_obstructed.py,
# so that each file stays short on one worker.
HERE = [c for c in CASES if "ObstructedMaze" not in c[0]]


@pytest.mark.parametrize("env_id, events, prep", HERE, ids=[c[0] for c in HERE])
def test_step_obs_bit_identical(env_id, events, prep):
    step_obs_parity(env_id, events, prep)


def test_cases_cover_every_new_id():
    import minigrid_dynamicprogramming_tpu_torch as port

    families = ("KeyCorridor", "MultiRoom", "ObstructedMaze", "Unlock", "Playground")
    new = {i for i in port.registered_ids() if i.startswith("MiniGrid-") and any(f in i for f in families)}
    assert {c[0] for c in CASES} == new and len(new) == 26
