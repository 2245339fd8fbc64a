"""Plain reference of exact value iteration over the key domain of a
MiniGrid layout, in plain PyTorch.

One layout's states are ``(k, c, d, y, x)``: where the key is (a raster
cell ``y * W + x``, or ``H * W`` when carried; K = H * W + 1), which of the
first ``D`` doors (raster order) have been opened (a bit each, C = 2**D
configurations), the agent's direction (right, down, left, up) and cell.
The goal objective: moving onto the goal pays 1 and ends the episode,
moving onto lava pays 0 and ends it; every other transition pays 0 and is
discounted by ``gamma``.  The seven actions follow upstream's rules over
the objects involved:

* left, right: turn; done: stay;
* forward: onto the front cell if it is walkable in configuration c
  (empty, floor, goal, lava, the key's start cell, or a door that is open
  at the start or opened in c) and the key does not lie there;
* pickup: the key, if it lies in front (hands are then full);
* drop: the carried key onto the front cell, if that cell is empty at
  the start or held the key (and is no door);
* toggle: a closed door in front opens; a locked one opens if the key is
  carried and has the door's color; an opened door stays open (closing it
  never helps).

V after ``n`` synchronous sweeps from 0 is what ``value_iteration``
returns; ``q_values`` is one backup.  Layouts come as raw grids (upstream
codes) and nothing is taken from the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.doorkey import DOOR, EMPTY, FLOOR, GOAL, KEY, LAVA, LOCKED, OPEN, WALL

DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))


@dataclass
class Tables:
    """Per-layout tables, leading batch B; ``[..., y, x]`` planes."""

    walk: torch.Tensor  # (B, C, H, W) walkable in configuration c, the key aside
    goal: torch.Tensor  # (B, H, W)
    lava: torch.Tensor  # (B, H, W)
    droppable: torch.Tensor  # (B, H, W) the key may land here
    door_bit: torch.Tensor  # (B, H, W) int64 the config bit of the door here, 0 if none
    closed: torch.Tensor  # (B, C, H, W) a closed (not locked) door in configuration c
    unlockable: torch.Tensor  # (B, C, H, W) a locked door that the layout's key opens


def tables(obj: torch.Tensor, color: torch.Tensor, state: torch.Tensor,
           carry_obj: torch.Tensor, carry_color: torch.Tensor, max_doors: int) -> Tables:
    """The tables of raw layouts: ``obj``, ``color``, ``state`` (B, H, W)
    in upstream codes, the carried object and its color (B,).  Doors past
    ``max_doors`` in raster order count as walls unless open (none in
    DoorKey)."""
    b, h, w = obj.shape
    dev = obj.device
    obj, color, state = obj.long(), color.long(), state.long()
    is_door = obj == DOOR
    rank = torch.cumsum(is_door.reshape(b, -1).long(), 1).reshape(b, h, w) - 1
    slot = torch.where(is_door & (rank < max_doors), rank, -1)
    overflow = is_door & (slot < 0)
    base = ((obj == EMPTY) | (obj == FLOOR) | (obj == GOAL) | (obj == LAVA) | (obj == KEY)
            | is_door) & ~(overflow & (state != OPEN))
    # The key's color: the first key cell in raster order, else the carried one.
    is_key = (obj == KEY).reshape(b, -1)
    flat = torch.arange(h * w, device=dev)
    first = torch.where(is_key, flat, h * w).amin(1)
    key_color = torch.where(first < h * w,
                            color.reshape(b, -1).gather(1, first.clamp(max=h * w - 1)[:, None])[:, 0],
                            carry_color.long())
    n_cfg = 1 << max_doors
    cfg = torch.arange(n_cfg, device=dev)[None, :, None, None]
    bit = torch.where(slot >= 0, 1 << slot.clamp(min=0), 0)  # (B, H, W)
    opened = ((cfg & bit[:, None]) != 0) | (state == OPEN)[:, None]
    has_slot = (slot >= 0)[:, None]
    locked = has_slot & ~opened & (state == LOCKED)[:, None]
    closed = has_slot & ~opened & ~locked
    blocked = has_slot & ~opened
    matches = (color == key_color[:, None, None])[:, None]
    return Tables(
        walk=base[:, None] & ~blocked,
        goal=obj == GOAL,
        lava=obj == LAVA,
        droppable=((obj == EMPTY) | (obj == KEY)) & ~is_door,
        door_bit=bit,
        closed=closed,
        unlockable=locked & matches,
    )


def _ahead(v: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = v[..., y + dy, x + dx] for direction d; ``fill``
    beyond the border."""
    dx, dy = DIRS[d]
    h, w = v.shape[-2:]
    out = torch.full_like(v, fill)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        v[..., max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


def _front_cell(h: int, w: int, d: int, dev) -> torch.Tensor:
    """(H, W) raster index of the cell in front, -1 beyond the border."""
    dx, dy = DIRS[d]
    ys = torch.arange(h, device=dev)[:, None] + dy
    xs = torch.arange(w, device=dev)[None, :] + dx
    return torch.where((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w), ys * w + xs, -1)


def q_values(v: torch.Tensor, t: Tables, gamma: float) -> torch.Tensor:
    """One backup: V (B, K, C, 4, H, W) -> Q (B, 7, K, C, 4, H, W), actions
    left, right, forward, pickup, drop, toggle, done.  ``gamma`` and the
    arithmetic take V's dtype."""
    b, K, C, _, h, w = v.shape
    dev, dt = v.device, v.dtype
    g = torch.tensor(gamma, dtype=dt, device=dev)
    carried = K - 1
    kloc = torch.arange(K, device=dev)
    q = torch.empty((b, 7) + tuple(v.shape[1:]), dtype=dt, device=dev)
    q[:, 0] = g * torch.roll(v, 1, dims=3)   # left: from d - 1
    q[:, 1] = g * torch.roll(v, -1, dims=3)  # right: from d + 1
    q[:, 6] = g * v
    cfgs = torch.arange(C, device=dev)
    for d in range(4):
        vd = v[:, :, :, d]  # (B, K, C, H, W)
        front = _front_cell(h, w, d, dev)
        key_in_front = (kloc[:, None, None] == front[None]) & (front >= 0)[None]  # (K, H, W)
        walk = _ahead(t.walk, d, False)[:, None] & ~key_in_front[None, :, None]
        fwd = g * torch.where(walk, _ahead(vd, d), vd)
        fwd = torch.where(_ahead(t.lava, d, False)[:, None, None], torch.zeros((), dtype=dt, device=dev), fwd)
        fwd = torch.where(_ahead(t.goal, d, False)[:, None, None], torch.ones((), dtype=dt, device=dev), fwd)
        q[:, 2, :, :, d] = fwd
        q[:, 3, :, :, d] = g * torch.where(key_in_front[None, :, None], vd[:, carried:], vd)
        drop = g * vd
        can_drop = _ahead(t.droppable, d, False) & (front >= 0)
        landed = vd.gather(1, front.clamp(min=0).expand(b, 1, C, h, w))[:, 0]
        drop[:, carried] = g * torch.where(can_drop[:, None], landed, vd[:, carried])
        q[:, 4, :, :, d] = drop
        to_cfg = (cfgs[None, :, None, None] | _ahead(t.door_bit, d, 0)[:, None]).long()
        opened = vd.gather(2, to_cfg[:, None].expand(b, K, C, h, w))
        allow = (_ahead(t.closed, d, False)[:, None]
                 | (_ahead(t.unlockable, d, False)[:, None] & (kloc == carried)[None, :, None, None, None]))
        q[:, 5, :, :, d] = g * torch.where(allow, opened, vd)
    return q


def value_iteration(t: Tables, gamma: float, n_sweeps: int, dtype=torch.float32) -> torch.Tensor:
    """V after ``n_sweeps`` synchronous sweeps from 0, in ``dtype``:
    (B, K, C, 4, H, W)."""
    b, C, h, w = t.walk.shape
    v = torch.zeros((b, h * w + 1, C, 4, h, w), dtype=dtype, device=t.walk.device)
    for _ in range(n_sweeps):
        v = q_values(v, t, gamma).amax(1)
    return v


def greedy_policy(v: torch.Tensor, t: Tables, gamma: float) -> torch.Tensor:
    """The first best action of one backup over ``v``: int8 of V's shape."""
    return q_values(v, t, gamma).argmax(1).to(torch.int8)


def policy_value_gap(v_ref: torch.Tensor, t: Tables, gamma: float, v: torch.Tensor,
                     policy: torch.Tensor) -> float:
    """The widest gap between the value ``v`` states and the value that the
    action ``policy`` takes earns in one backup over the reference's V.
    It is 0 where ``v`` is the reference's converged V and ``policy``
    takes a best action; a wrong value or a worse action shows."""
    taken = q_values(v_ref, t, gamma).gather(1, policy.long().unsqueeze(1))[:, 0]
    return float((v.float() - taken).abs().max())
