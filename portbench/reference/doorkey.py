"""Plain reference of MiniGrid's DoorKey environments, written from the rules
of Farama Minigrid v2.3.1 (``minigrid/envs/doorkey.py`` over
``minigrid/minigrid_env.py`` and ``minigrid/core/grid.py``).

Nothing here comes from the program under test: the codes are upstream's
``OBJECT_TO_IDX``, ``COLOR_TO_IDX`` and door states, and every rule is
upstream's, vectorised over a leading batch of layouts in plain PyTorch
(the step, the egocentric view with ``process_vis``, the reward), or in
NumPy (the layout maker).

A state is a dict of tensors, batch first:

* ``obj``, ``color``, ``state``: (B, H, W) uint8 planes indexed [b, y, x];
* ``ax``, ``ay``, ``adir``: (B,) int64 agent column, row and direction;
* ``carry_obj``, ``carry_color``: (B,) uint8, ``EMPTY`` and 0 when the
  agent carries nothing;
* ``steps``: (B,) int64; ``terminated``, ``truncated``: (B,) bool.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

EMPTY, WALL, FLOOR, DOOR, KEY, BALL, BOX, GOAL, LAVA = 1, 2, 3, 4, 5, 6, 7, 8, 9
GREEN, YELLOW, GREY = 1, 4, 5
OPEN, CLOSED, LOCKED = 0, 1, 2
LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE = range(7)
VIEW = 7
DIR_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))  # right, down, left, up

State = Dict[str, torch.Tensor]
FIELDS = ("obj", "color", "state", "ax", "ay", "adir", "carry_obj", "carry_color",
          "steps", "terminated", "truncated")


# --- the layout maker (DoorKeyEnv._gen_grid) --------------------------------

def make_layouts(rng: np.random.Generator, n: int, size: int) -> Dict[str, np.ndarray]:
    """``n`` DoorKey layouts of ``size`` x ``size`` as upstream draws them:
    border walls, the goal at (size-2, size-2), a wall column at
    ``split`` in [2, size-2) with a locked yellow door at row ``door`` in
    [1, size-2), the agent on a uniform empty cell left of the wall with a
    uniform direction, then the yellow key on a uniform empty cell left of
    the wall.  Arrays: obj, color, state (n, H, W) uint8, agent_pos (n, 2)
    int32 (x, y), agent_dir (n,) int32."""
    h = w = size
    obj = np.full((n, h, w), EMPTY, np.uint8)
    color = np.zeros((n, h, w), np.uint8)
    state = np.zeros((n, h, w), np.uint8)
    obj[:, [0, -1], :] = WALL
    obj[:, :, [0, -1]] = WALL
    obj[:, h - 2, w - 2] = GOAL
    color[:, h - 2, w - 2] = GREEN
    rows = np.arange(n)
    split = rng.integers(2, w - 2, n)
    obj[rows[:, None], np.arange(h)[None, :], split[:, None]] = WALL
    # The agent: uniform over the (split - 1) x (h - 2) empty cells left of the wall.
    cells = (split - 1) * (h - 2)
    a = (rng.random(n) * cells).astype(np.int64)
    ax, ay = 1 + a % (split - 1), 1 + a // (split - 1)
    adir = rng.integers(0, 4, n)
    door = rng.integers(1, w - 2, n)
    obj[rows, door, split] = DOOR
    state[rows, door, split] = LOCKED
    # The key: uniform over the same cells less the agent's.
    k = (rng.random(n) * (cells - 1)).astype(np.int64)
    k = k + (k >= a)
    obj[rows, 1 + k // (split - 1), 1 + k % (split - 1)] = KEY
    color[obj == WALL] = GREY
    color[obj == DOOR] = YELLOW
    color[obj == KEY] = YELLOW
    return {
        "obj": obj, "color": color, "state": state,
        "agent_pos": np.stack([ax, ay], axis=1).astype(np.int32),
        "agent_dir": adir.astype(np.int32),
    }


def start_state(obj, color, state, ax, ay, adir) -> State:
    """A fresh episode's state from layout tensors (B, H, W) and (B,)."""
    b = obj.shape[0]
    dev = obj.device
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    return {
        "obj": obj.to(torch.uint8), "color": color.to(torch.uint8), "state": state.to(torch.uint8),
        "ax": ax.to(torch.int64), "ay": ay.to(torch.int64), "adir": adir.to(torch.int64),
        "carry_obj": torch.full((b,), EMPTY, dtype=torch.uint8, device=dev),
        "carry_color": torch.zeros(b, dtype=torch.uint8, device=dev),
        "steps": zeros, "terminated": zeros.bool(), "truncated": zeros.bool(),
    }


def invalid_layouts(s: State) -> torch.Tensor:
    """(B,) bool: the layouts that break a DoorKey rule.  A valid one is a
    fresh episode (nothing carried, step 0, not done) whose grid is
    exactly: grey border walls, a grey wall column at ``split`` in
    [2, W-2) whose one gap is a locked yellow door at a row in [1, W-2),
    the green goal at (W-2, H-2), one yellow key left of the wall, every
    other cell empty; the agent on an empty cell left of the wall, facing
    one of the four directions."""
    obj, color, st = s["obj"], s["color"], s["state"]
    b, h, w = obj.shape
    dev = obj.device
    flat = torch.arange(h * w, device=dev)
    is_door = (obj == DOOR).reshape(b, -1)
    is_key = (obj == KEY).reshape(b, -1)
    door_at = torch.where(is_door, flat, h * w).amin(1).clamp(max=h * w - 1)
    key_at = torch.where(is_key, flat, h * w).amin(1).clamp(max=h * w - 1)
    split, door_row = door_at % w, door_at // w
    kx, ky = key_at % w, key_at // w
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    wall = (ys == 0) | (ys == h - 1) | (xs == 0) | (xs == w - 1) | (xs == split[:, None, None])
    door = (xs == split[:, None, None]) & (ys == door_row[:, None, None])
    goal = (xs == w - 2) & (ys == h - 2)
    key = (xs == kx[:, None, None]) & (ys == ky[:, None, None])
    want_obj = torch.full_like(obj, EMPTY)
    want_color = torch.zeros_like(color)
    for mask, o, c in ((wall, WALL, GREY), (door, DOOR, YELLOW), (goal, GOAL, GREEN),
                       (key, KEY, YELLOW)):
        mask = mask.expand(b, h, w)
        want_obj = torch.where(mask, o, want_obj)
        want_color = torch.where(mask, c, want_color)
    want_state = torch.where(door, LOCKED, 0).to(st.dtype).expand(b, h, w)
    grid_ok = ((obj == want_obj) & (color == want_color) & (st == want_state)).reshape(b, -1).all(1)
    ax, ay = s["ax"], s["ay"]
    agent_cell = obj.reshape(b, -1).gather(1, (ay.clamp(0, h - 1) * w + ax.clamp(0, w - 1))[:, None])[:, 0]
    ok = (
        grid_ok
        & (is_door.sum(1) == 1) & (is_key.sum(1) == 1)
        & (split >= 2) & (split < w - 2) & (door_row >= 1) & (door_row < w - 2)
        & (kx >= 1) & (kx < split)
        & (ax >= 1) & (ax < split) & (ay >= 1) & (ay < h - 1) & (agent_cell == EMPTY)
        & (s["adir"] >= 0) & (s["adir"] < 4)
        & (s["carry_obj"] == EMPTY) & (s["carry_color"] == 0)
        & (s["steps"] == 0) & ~s["terminated"] & ~s["truncated"]
    )
    return ~ok


def split_door_pairs(s: State) -> torch.Tensor:
    """(B,) index ``split * W + door_row`` of each layout's door: the
    generator's two draws, for a check that a batch covers them."""
    b, h, w = s["obj"].shape
    flat = torch.arange(h * w, device=s["obj"].device)
    door_at = torch.where((s["obj"] == DOOR).reshape(b, -1), flat, 0).amax(1)
    return (door_at % w) * w + door_at // w


def unseen_pairs(pairs: torch.Tensor, size: int) -> int:
    """How many of the (split, door row) pairs a DoorKey generator may
    draw at ``size`` are missing from ``pairs``."""
    seen = set(pairs.unique().tolist())
    allowed = {x * size + y for x in range(2, size - 2) for y in range(1, size - 2)}
    return len(allowed - seen)


# --- the transition (MiniGridEnv.step) ---------------------------------------

def _front(s: State):
    dx = torch.tensor([v[0] for v in DIR_VEC], device=s["adir"].device)[s["adir"]]
    dy = torch.tensor([v[1] for v in DIR_VEC], device=s["adir"].device)[s["adir"]]
    return s["ax"] + dx, s["ay"] + dy


def _cell(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    b, h, w = plane.shape
    return plane.reshape(b, -1).gather(1, (y * w + x)[:, None])[:, 0]


def step(s: State, action: torch.Tensor, max_steps: int, reward_dtype=torch.float64):
    """One ``MiniGridEnv.step`` of every layout: returns (state, reward,
    terminated).  The reward on reaching the goal is
    ``1 - 0.9 * step_count / max_steps``, computed in ``reward_dtype``
    (upstream computes it in Python floats, float64)."""
    b, h, w = s["obj"].shape
    action = action.to(torch.int64)
    steps = s["steps"] + 1
    fx, fy = _front(s)
    inb = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    cx, cy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    fobj = torch.where(inb, _cell(s["obj"], cx, cy), WALL)
    fcol = torch.where(inb, _cell(s["color"], cx, cy), GREY)
    fst = torch.where(inb, _cell(s["state"], cx, cy), 0)

    adir = torch.where(action == LEFT, (s["adir"] + 3) % 4,
                       torch.where(action == RIGHT, (s["adir"] + 1) % 4, s["adir"]))
    overlap = ((fobj == EMPTY) | (fobj == FLOOR) | (fobj == GOAL) | (fobj == LAVA)
               | ((fobj == DOOR) & (fst == OPEN)))
    move = (action == FORWARD) & overlap & inb
    goal = move & (fobj == GOAL)
    terminated = goal | (move & (fobj == LAVA))
    limit = torch.tensor(float(max_steps), dtype=reward_dtype, device=steps.device)
    one = torch.ones((), dtype=reward_dtype, device=steps.device)
    reward = torch.where(goal, one - 0.9 * (steps.to(reward_dtype) / limit),
                         torch.zeros((), dtype=reward_dtype, device=steps.device))

    empty_hands = s["carry_obj"] == EMPTY
    pickup = (action == PICKUP) & inb & empty_hands & ((fobj == KEY) | (fobj == BALL) | (fobj == BOX))
    drop = (action == DROP) & inb & ~empty_hands & (fobj == EMPTY)
    is_door = (action == TOGGLE) & inb & (fobj == DOOR)
    unlock = is_door & (fst == LOCKED) & (s["carry_obj"] == KEY) & (s["carry_color"] == fcol)
    flip = is_door & (fst != LOCKED)
    if bool(((action == TOGGLE) & inb & (fobj == BOX)).any()):
        raise NotImplementedError("boxes are not part of DoorKey")

    new_obj = torch.where(pickup, EMPTY, torch.where(drop, s["carry_obj"], fobj))
    new_col = torch.where(pickup, 0, torch.where(drop, s["carry_color"], fcol))
    new_st = torch.where(pickup | drop, 0,
                         torch.where(unlock, OPEN,
                                     torch.where(flip, torch.where(fst == OPEN, CLOSED, OPEN), fst)))
    changed = (pickup | drop | unlock | flip)[:, None]
    idx = (cy * w + cx)[:, None]

    def put(plane, val):
        flat = plane.reshape(b, -1)
        old = flat.gather(1, idx)
        return flat.scatter(1, idx, torch.where(changed, val[:, None].to(plane.dtype), old)).reshape(b, h, w)

    out = {
        "obj": put(s["obj"], new_obj), "color": put(s["color"], new_col),
        "state": put(s["state"], new_st),
        "ax": torch.where(move, fx, s["ax"]), "ay": torch.where(move, fy, s["ay"]), "adir": adir,
        "carry_obj": torch.where(pickup, fobj, torch.where(drop, EMPTY, s["carry_obj"])).to(torch.uint8),
        "carry_color": torch.where(pickup, fcol, torch.where(drop, 0, s["carry_color"])).to(torch.uint8),
        "steps": steps, "terminated": terminated, "truncated": steps >= max_steps,
    }
    return out, reward, terminated


# --- the observation (MiniGridEnv.gen_obs_grid, Grid.process_vis, encode) ---

def observe(s: State):
    """The 7x7 egocentric view of every layout: (obj, color, state, vis),
    each (B, 7, 7) indexed [b, i, j] as upstream's grid (i the view's
    column, j its row; the agent at (3, 6) facing j = 0).  Cells outside
    the world read as grey walls; ``vis`` is ``process_vis``; the agent's
    cell shows what it carries (empty if nothing)."""
    b, h, w = s["obj"].shape
    dev = s["obj"].device
    dx = torch.tensor([v[0] for v in DIR_VEC], device=dev)[s["adir"]][:, None, None]
    dy = torch.tensor([v[1] for v in DIR_VEC], device=dev)[s["adir"]][:, None, None]
    rx, ry = -dy, dx  # the agent's right
    i = torch.arange(VIEW, device=dev)[None, :, None]
    j = torch.arange(VIEW, device=dev)[None, None, :]
    ahead, aside = VIEW - 1 - j, i - VIEW // 2
    wx = s["ax"][:, None, None] + dx * ahead + rx * aside
    wy = s["ay"][:, None, None] + dy * ahead + ry * aside
    inb = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    idx = (wy.clamp(0, h - 1) * w + wx.clamp(0, w - 1)).reshape(b, -1)

    def look(plane, outside):
        got = plane.reshape(b, -1).gather(1, idx).reshape(b, VIEW, VIEW).to(torch.int64)
        return torch.where(inb, got, outside)

    obj, color, state = look(s["obj"], WALL), look(s["color"], GREY), look(s["state"], 0)
    state = torch.where(obj == DOOR, state, 0)  # only doors encode a state
    see_behind = ~((obj == WALL) | ((obj == DOOR) & (state != OPEN)))

    mask = torch.zeros(b, VIEW, VIEW, dtype=torch.bool, device=dev)
    mask[:, VIEW // 2, VIEW - 1] = True
    for jj in reversed(range(VIEW)):
        for ii in range(VIEW - 1):
            go = mask[:, ii, jj] & see_behind[:, ii, jj]
            mask[:, ii + 1, jj] |= go
            if jj > 0:
                mask[:, ii + 1, jj - 1] |= go
                mask[:, ii, jj - 1] |= go
        for ii in reversed(range(1, VIEW)):
            go = mask[:, ii, jj] & see_behind[:, ii, jj]
            mask[:, ii - 1, jj] |= go
            if jj > 0:
                mask[:, ii - 1, jj - 1] |= go
                mask[:, ii, jj - 1] |= go

    carried = s["carry_obj"].to(torch.int64)
    obj[:, VIEW // 2, VIEW - 1] = carried
    color[:, VIEW // 2, VIEW - 1] = torch.where(carried == EMPTY, 0, s["carry_color"].to(torch.int64))
    state[:, VIEW // 2, VIEW - 1] = 0
    return obj, color, state, mask


def obs_checksum(s: State) -> torch.Tensor:
    """() int64: the sum over the batch's visible view cells of object +
    color + state codes."""
    obj, color, state, vis = observe(s)
    return ((obj + color + state) * vis).sum()


# --- the autoreset rollout ----------------------------------------------------

def select(done: torch.Tensor, fresh: State, cur: State) -> State:
    out = {}
    for k in FIELDS:
        d = done.reshape((-1,) + (1,) * (cur[k].dim() - 1))
        out[k] = torch.where(d, fresh[k].to(cur[k].dtype), cur[k])
    return out


def rollout(start: State, actions: torch.Tensor, max_steps: int,
            fresh: Callable[[int, torch.Tensor], State], reward_dtype=torch.float64) -> dict:
    """``actions.shape[0]`` steps of every layout from ``start``.  After each
    step a finished episode (terminated or truncated) restarts from
    ``fresh(t, resets)`` (its layouts for step t, given each lane's count
    of resets so far), and the view of the new state is observed.

    Returns the final state, each lane's resets, and the sums over the
    steps: reward (in ``reward_dtype``), finished episodes, successes
    (terminations with a positive reward), failures (the other
    terminations) and the view checksum (int64, before any modulus)."""
    s = start
    b = s["obj"].shape[0]
    dev = s["obj"].device
    resets = torch.zeros(b, dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=reward_dtype, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)  # episodes, successes, ends, checksum
    for t in range(actions.shape[0]):
        s, reward, term = step(s, actions[t], max_steps, reward_dtype)
        done = term | s["truncated"]
        resets = resets + done.to(torch.int64)
        s = select(done, fresh(t, resets), s)
        reward_sum = reward_sum + reward.sum()
        counts += torch.stack([done.sum(), (term & (reward > 0)).sum(), term.sum(), obs_checksum(s)])
    episodes, successes, ends, checksum = counts.tolist()
    return {
        "state": s, "resets": resets, "reward": float(reward_sum), "episodes": episodes,
        "successes": successes, "failures": ends - successes, "checksum": checksum,
    }
