"""Plain reference of BabyAI's GoToDoor level, written from the rules of
Farama Minigrid v2.3.1 (``minigrid/envs/babyai/goto.py:GoToDoor`` over
``minigrid/envs/babyai/core/roomgrid_level.py``, ``core/verifier.py``
and ``minigrid/core/roomgrid.py``).

A 3x3 grid of rooms of ``ROOM`` = 7 cells (19 x 19, grey walls on every
sixth row and column), four doors, one in each wall of the centre room
(``add_door(1, 1)``: a uniform colour, locked on a fair coin), the agent
in the centre room, and the mission "go to the {color} door" naming one
of the four.  MiniGrid's step rules, the 7x7 egocentric view and the
wire layout of the observation are the DoorKey reference's
(``reference/doorkey.py``), which this file steps and observes through;
the verifier (``GoToInstr.verify_action``) ends an episode with the
reward ``1 - 0.9 * step_count / max_steps`` once the agent, after an
action, faces a door of the named colour.

The mission is the observation's 48-int code vector, the wire format of
the port and of the JAX package (``mission_codes``).  A state is
``reference/doorkey.py``'s dict with one more field, ``codes`` (B, 48)
int64, the episode's mission.

Departures from the published description: the mission is its code
vector, not its string; upstream's ``max_steps`` is set at reset from
the instruction (one navigation: ``room_size**2 * 9`` = 441), which here
is a number the caller passes.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from portbench.reference import doorkey as dk

ROOM = 7
SIZE = 3 * (ROOM - 1) + 1
CENTRE = (ROOM - 1, 2 * (ROOM - 1))  # the centre room's wall rows / columns
MISSION_SLOTS = 48
# The code vector (the port's ``envs/babyai/core.py`` layout): a single
# clause of one GoTo leaf whose first descriptor is (door, color, no
# location, plural); the second descriptor is unused, its colour "any".
KIND_SLOT, TYPE_SLOT, COLOR_SLOT, PLURAL_SLOT, UNUSED_COLOR_SLOT = 3, 5, 6, 8, 10
KIND_GOTO, COLOR_ANY, COLORS = 1, 6, 6
FIELDS = dk.FIELDS + ("codes",)

State = Dict[str, torch.Tensor]


def mission_codes(color: torch.Tensor, plural: torch.Tensor) -> torch.Tensor:
    """(B, 48) int64 codes of "go to the {color} door"; ``plural`` where
    more than one door of that colour is in the grid."""
    codes = torch.zeros(color.shape[0], MISSION_SLOTS, dtype=torch.int64, device=color.device)
    codes[:, KIND_SLOT] = KIND_GOTO
    codes[:, TYPE_SLOT] = dk.DOOR
    codes[:, COLOR_SLOT] = color.to(torch.int64)
    codes[:, PLURAL_SLOT] = plural.to(torch.int64)
    codes[:, UNUSED_COLOR_SLOT] = COLOR_ANY
    return codes


def _doors_of(obj: torch.Tensor, color: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """(B,) how many doors of colour ``which`` the grids hold."""
    return ((obj == dk.DOOR) & (color.to(torch.int64) == which[:, None, None])).sum((1, 2))


def invalid_layouts(s: State) -> torch.Tensor:
    """(B,) bool: the fresh episodes that break a GoToDoor rule.  A valid
    one has nothing carried, step 0 and is not done; its grid is exactly
    the grey walls of the 3x3 rooms and four doors, one on each wall of
    the centre room away from its corners, each closed or locked, of any
    colour, every other cell empty; the agent stands inside the centre
    room facing one of the four directions; its codes name the colour of
    one of the doors, with the plural flag of that colour."""
    obj, color, st = s["obj"], s["color"], s["state"]
    b, h, w = obj.shape
    dev = obj.device
    if (h, w) != (SIZE, SIZE):
        return torch.ones(b, dtype=torch.bool, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    wall = (ys % (ROOM - 1) == 0) | (xs % (ROOM - 1) == 0)
    lo, hi = CENTRE
    inner_y = (ys > lo) & (ys < hi)
    inner_x = (xs > lo) & (xs < hi)
    # The four door segments: right, down, left, up (RoomGrid's order).
    segments = [(xs == hi) & inner_y, (ys == hi) & inner_x, (xs == lo) & inner_y, (ys == lo) & inner_x]
    is_door = obj == dk.DOOR
    one_each = torch.stack([(is_door & seg).sum((1, 2)) == 1 for seg in segments], 1).all(1)
    door_ok = (~is_door | (((st == dk.CLOSED) | (st == dk.LOCKED)) & (color < COLORS))).reshape(b, -1).all(1)
    walls_ok = torch.where(is_door, True, torch.where(
        wall, (obj == dk.WALL) & (color == dk.GREY) & (st == 0),
        (obj == dk.EMPTY) & (color == 0) & (st == 0))).reshape(b, -1).all(1)
    codes = s["codes"].to(torch.int64)
    named = codes[:, COLOR_SLOT]
    count = _doors_of(obj, color, named)
    codes_ok = (codes == mission_codes(named, count > 1)).all(1) & (count >= 1)
    ax, ay = s["ax"], s["ay"]
    ok = (
        one_each & (is_door.reshape(b, -1).sum(1) == 4) & door_ok & walls_ok & codes_ok
        & (ax > lo) & (ax < hi) & (ay > lo) & (ay < hi)
        & (s["adir"] >= 0) & (s["adir"] < 4)
        & (s["carry_obj"] == dk.EMPTY) & (s["carry_color"] == 0)
        & (s["steps"] == 0) & ~s["terminated"] & ~s["truncated"]
    )
    return ~ok


def inconsistent_states(s: State, layout: State, max_steps: int) -> torch.Tensor:
    """(B,) bool: the states that cannot lie in the episode that started
    from ``layout``: the grid, the codes and every door's colour as the
    layout's; a door that started locked still locked (GoToDoor holds no
    key), one that started closed closed or open; nothing carried; the
    agent on an empty cell or an open door; a step count below
    ``max_steps`` and not done."""
    obj, st = s["obj"], s["state"]
    b, h, w = obj.shape
    door = layout["obj"] == dk.DOOR
    toggled = door & (layout["state"] == dk.CLOSED) & (st == dk.OPEN)
    grid_ok = ((obj == layout["obj"]) & (s["color"] == layout["color"])
               & ((st == layout["state"]) | toggled)).reshape(b, -1).all(1)
    ax, ay = s["ax"], s["ay"]
    inside = (ax >= 0) & (ax < w) & (ay >= 0) & (ay < h)
    under = dk._cell(obj, ax.clamp(0, w - 1), ay.clamp(0, h - 1))
    under_state = dk._cell(st, ax.clamp(0, w - 1), ay.clamp(0, h - 1))
    ok = (
        grid_ok & (s["codes"].to(torch.int64) == layout["codes"].to(torch.int64)).all(1)
        & inside & ((under == dk.EMPTY) | ((under == dk.DOOR) & (under_state == dk.OPEN)))
        & (s["adir"] >= 0) & (s["adir"] < 4)
        & (s["carry_obj"] == dk.EMPTY) & (s["carry_color"] == 0)
        & (s["steps"] >= 0) & (s["steps"] < max_steps) & ~s["terminated"] & ~s["truncated"]
    )
    return ~ok


def step(s: State, action: torch.Tensor, max_steps: int, reward_dtype=torch.float64):
    """One ``RoomGridLevel.step`` of every layout: MiniGrid's step (the
    DoorKey reference's rules; this level has no goal, lava or object to
    pick up), then the verifier: success, termination and the reward
    ``1 - 0.9 * step_count / max_steps`` (in ``reward_dtype``) where the
    agent faces a door of the mission's colour.  Returns (state, reward,
    terminated)."""
    new, _, _ = dk.step(s, action, max_steps, reward_dtype)
    new["codes"] = s["codes"]
    b, h, w = new["obj"].shape
    fx, fy = dk._front(new)
    inb = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    cx, cy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    success = (inb & (dk._cell(new["obj"], cx, cy) == dk.DOOR)
               & (dk._cell(new["color"], cx, cy).to(torch.int64) == s["codes"][:, COLOR_SLOT].to(torch.int64)))
    steps = new["steps"].to(reward_dtype)
    reward = torch.where(success, 1 - 0.9 * (steps / max_steps), torch.zeros((), dtype=reward_dtype,
                                                                           device=steps.device))
    new["terminated"] = success
    return new, reward, success


def observe(s: State) -> Dict[str, torch.Tensor]:
    """The observation in the wire layout: ``image`` (B, 7, 7, 3) uint8
    indexed [b, i, j] (i the view's column), unseen cells all zero;
    ``direction`` (B,) and ``mission`` (B, 48), int64."""
    obj, color, state, vis = dk.observe(s)
    image = torch.stack([obj, color, state], -1) * vis[..., None]
    return {"image": image.to(torch.uint8), "direction": s["adir"].to(torch.int64),
            "mission": s["codes"].to(torch.int64)}


def select(done: torch.Tensor, fresh: State, cur: State) -> State:
    out = {}
    for k in FIELDS:
        d = done.reshape((-1,) + (1,) * (cur[k].dim() - 1))
        out[k] = torch.where(d, fresh[k].to(cur[k].dtype), cur[k])
    return out


def replay(start: State, actions: torch.Tensor, max_steps: int,
           fresh: Callable[[torch.Tensor], State], reward_dtype=torch.float64) -> dict:
    """``actions.shape[0]`` steps of every env from ``start``, observed
    before each step.  A finished episode (terminated or truncated)
    restarts from ``fresh(resets)``, given each env's count of resets so
    far this replay.  Returns the observations ``obs`` (each stacked over
    the steps, (T, B, ...)), ``rewards`` (T, B) in ``reward_dtype``,
    ``dones`` (T, B), the final state ``state``, its observation
    ``last_obs`` and ``resets`` (B,)."""
    s = start
    resets = torch.zeros(s["obj"].shape[0], dtype=torch.int64, device=s["obj"].device)
    obs, rewards, dones = [], [], []
    for t in range(actions.shape[0]):
        obs.append(observe(s))
        s, reward, term = step(s, actions[t], max_steps, reward_dtype)
        done = term | s["truncated"]
        resets = resets + done.to(torch.int64)
        s = select(done, fresh(resets), s)
        rewards.append(reward)
        dones.append(done)
    return {
        "obs": {k: torch.stack([o[k] for o in obs]) for k in obs[0]},
        "rewards": torch.stack(rewards), "dones": torch.stack(dones), "state": s,
        "last_obs": observe(s), "resets": resets,
    }
