"""Exact DP over the obstructed domain: a key that may hide in a box, and
one movable ball.

Counterpart of ``minigrid_dynamicprogramming_tpu/dp/tabular_obstructed.py``.
``dp/tabular_key.py`` tracks the key's position; two reference
sub-families fall outside it:

* keys hidden in boxes (ObstructedMaze's ``h`` variants): toggling the box
  replaces it with its key, so "in the box" is one more key location;
* a movable blocking ball (ObstructedMaze's ``b`` variants and
  BlockedUnlockPickup): the agent must pick it off the door's approach and
  drop it elsewhere, so the ball's position is part of the state.

The state space of one layout is

    (ball-loc, key-loc, door-config, dir, y, x)

with ball-loc in {cell 0..HW-1, CARRIED = HW, ABSENT = HW+1} and key-loc in
{cell 0..HW-1, CARRIED = HW, IN_BOX = HW+1}; the box never moves, and its
cell empties when the key leaves it.  One carry slot is shared, so states
with both objects carried are unreachable.  Not modelled, as in JAX
(neither ever shortens a path in these families): picking up the key's box
itself, and closing doors.

V is ``(N, Bl, K, Cd, 4, H, W)`` float32 over a leading layout batch N.  A
sweep is a loop over the four directions; within one, each action's
backup is a shift, select or gather over the whole (Bl, K, Cd) block, and
the max over the seven actions is taken as they come, so at most one
action's values are held beside V.  The JAX package has no kernel for
this domain; nor has the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp.tabular import (
    _DIRS,
    _at,
    _door_slots,
    _first_index,
    _shift_from,
    _slot_door_id,
)
from minigrid_dynamicprogramming_tpu_torch.dp.tabular_key import (
    _door_tables,
    _front_index,
)

__all__ = [
    "ObstructedLayout",
    "extract_obstructed_layout",
    "obstructed_vi_values",
    "obstructed_value_iteration",
    "obstructed_state_index",
    "obstructed_greedy_action",
    "obstructed_state_value",
    "obstructed_steps_to_go",
]


@dataclass
class ObstructedLayout:
    """Static per-layout data with a leading layout batch N.

    ``K = H*W + 2`` key locations (cell, CARRIED = H*W, IN_BOX = H*W+1);
    ``Bl = H*W + 2`` ball locations (cell, CARRIED = H*W, ABSENT = H*W+1);
    ``Cd = 2^D`` door configs (bit k: door k has been opened)."""

    base_walk: torch.Tensor  # (N, H, W) bool — walkable ignoring doors, key, ball
    base_empty: torch.Tensor  # (N, H, W) bool — may become a drop target
    goal: torch.Tensor  # (N, H, W) bool
    lava: torch.Tensor  # (N, H, W) bool
    target_pos: torch.Tensor  # (N, 2) i32 (x, y); (-1, -1) = goal objective
    door_pos: torch.Tensor  # (N, D, 2) i32; (-1, -1) = unused slot
    door_id: torch.Tensor  # (N, H, W) i32; -1 where no door
    door_init: torch.Tensor  # (N, D) i32 — grid door state at t=0
    door_unlockable: torch.Tensor  # (N, D) bool
    box_idx: torch.Tensor  # (N,) i32 — the key box's raster cell, -1 if none
    key0: torch.Tensor  # (N,) i32 — initial key loc (IN_BOX included), -1 none
    ball0: torch.Tensor  # (N,) i32 — initial movable-ball loc (ABSENT included)

    @property
    def n_doors(self) -> int:
        return self.door_pos.shape[-2]


def _target_cell(target_pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W) bool: the target's cell; none where target_pos is -1."""
    dev = target_pos.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    return (xs == target_pos[:, 0, None, None]) & (ys == target_pos[:, 1, None, None])


def extract_obstructed_layout(
    state: EnvState,
    max_doors: int = 7,
    target_type=-1,
    target_color=-1,
) -> ObstructedLayout:
    """Derive the obstructed-domain layouts from a batch-first state.

    ``target_type``/``target_color`` (ints or (N,) tensors) name the
    pickup-terminal object; -1/-1 means a goal-reaching task.  The key is
    found bare on the grid, carried, or in the first box holding a key.
    The movable ball is the first ball that is not the target; any other
    ball is a static blocker."""
    obj = state.grid_obj
    n, h, w = obj.shape
    hw = h * w
    dev = obj.device

    def per_env(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(-1, 1, 1)

    t_type, t_color = per_env(target_type), per_env(target_color)
    is_target = (
        (obj.to(torch.int32) == t_type)
        & (state.grid_color.to(torch.int32) == t_color)
        & (t_type >= 0)
    )
    tidx, has_target = _first_index(is_target.reshape(n, hw))
    target_pos = torch.where(
        has_target[:, None], torch.stack([tidx % w, tidx // w], dim=-1), -1
    ).to(torch.int32)
    target_cell = _target_cell(target_pos, h, w)

    is_door = obj == OBJ_DOOR
    is_key = obj == OBJ_KEY
    is_keybox = (obj == OBJ_BOX) & (state.contains_obj == OBJ_KEY)
    is_movable_ball = (obj == OBJ_BALL) & ~target_cell
    # Walkable but for the tracked occupants (doors, key, box, ball), which
    # their own axes handle.
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | is_key
        | is_keybox
        | is_movable_ball
        | is_door
    ) & ~target_cell
    # A drop needs a literally empty front cell once vacated.
    base_empty = (obj == OBJ_EMPTY) | is_key | is_keybox | is_movable_ball

    slots, slot_valid = _door_slots(is_door.reshape(n, hw), max_doors)
    door_pos = torch.stack(
        [torch.where(slot_valid, slots % w, -1), torch.where(slot_valid, slots // w, -1)],
        dim=-1,
    ).to(torch.int32)
    door_id = _slot_door_id(slots, slot_valid, hw).reshape(n, h, w)
    overflow = is_door & (door_id < 0)
    base_walk = base_walk & ~(overflow & (state.grid_state != STATE_OPEN))
    door_init = torch.where(
        slot_valid, _at(state.grid_state, door_pos).to(torch.int32), STATE_OPEN
    ).to(torch.int32)

    bxidx, has_box = _first_index(is_keybox.reshape(n, hw))
    box_idx = torch.where(has_box, bxidx, -1).to(torch.int32)

    # Key location: a bare cell, else in the box, else carried.
    kidx, has_key_cell = _first_index(is_key.reshape(n, hw))
    carrying_key = state.carrying_obj == OBJ_KEY
    key0 = torch.where(
        has_key_cell, kidx, torch.where(has_box, hw + 1, torch.where(carrying_key, hw, -1))
    ).to(torch.int32)

    def cell_of(plane, idx):
        return plane.reshape(n, hw).gather(1, idx[:, None])[:, 0].to(torch.int32)

    key_color = torch.where(
        has_key_cell,
        cell_of(state.grid_color, kidx),
        torch.where(
            has_box, cell_of(state.contains_color, bxidx), state.carrying_color.to(torch.int32)
        ),
    )
    door_color = _at(state.grid_color, door_pos).to(torch.int32)
    door_unlockable = slot_valid & (door_color == key_color[:, None])

    blidx, has_ball = _first_index(is_movable_ball.reshape(n, hw))
    carrying_ball = state.carrying_obj == OBJ_BALL
    ball0 = torch.where(
        has_ball, blidx, torch.where(carrying_ball, hw, hw + 1)
    ).to(torch.int32)

    return ObstructedLayout(
        base_walk=base_walk,
        base_empty=base_empty,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        target_pos=target_pos,
        door_pos=door_pos,
        door_id=door_id,
        door_init=door_init,
        door_unlockable=door_unlockable,
        box_idx=box_idx,
        key0=key0,
        ball0=ball0,
    )


class _Dir(NamedTuple):
    """The layout seen from each cell facing one direction; (N, ...) each
    unless noted."""

    fidx: torch.Tensor  # (H, W) int64 raster index of the front cell, -1 off the grid
    walk: torch.Tensor  # (N, Bl, K, Cd, H, W) the agent can step forward
    goal: torch.Tensor  # (N, 1, 1, 1, H, W) the goal in front
    lava: torch.Tensor  # (N, 1, 1, 1, H, W) lava in front
    key_pick: torch.Tensor  # (1, Bl, K, 1, H, W) the key in front, hands empty
    ball_pick: torch.Tensor  # (1, Bl, K, 1, H, W) the ball in front, hands empty
    target_pick: torch.Tensor  # (N, Bl, K, 1, H, W) the target in front, hands empty
    key_drop: torch.Tensor  # (N, Bl, K, 1, H, W) the carried key may land in front
    ball_drop: torch.Tensor  # (N, Bl, K, 1, H, W) the carried ball may land in front
    toggle: torch.Tensor  # (N, 1, K, Cd, H, W) a closed door, or a locked one the key opens
    new_cfg: torch.Tensor  # (N, Bl, K, Cd, H, W) int64 the config once the door opens
    reveal: torch.Tensor  # (N, 1, K, 1, H, W) the key's box in front, the key inside


def _tables(layout: ObstructedLayout, bl: int, K: int) -> Tuple[_Dir, ...]:
    """Everything a sweep reads that does not depend on V, per direction."""
    n, h, w = layout.base_walk.shape
    hw = h * w
    dev = layout.base_walk.device
    CARRIED, IN_BOX = hw, hw + 1
    Cd = 1 << layout.n_doors
    _, door_block, bitmask, locked_cell, closed_cell = _door_tables(layout)
    safe = layout.door_id.clamp(0, layout.n_doors - 1).reshape(n, hw).long()
    unlock_cell = locked_cell & layout.door_unlockable.gather(1, safe).reshape(n, 1, h, w)

    cell_idx = torch.arange(hw, device=dev).reshape(h, w)
    kloc = torch.arange(K, device=dev)[:, None, None]  # (K, 1, 1)
    bloc = torch.arange(bl, device=dev)[:, None, None]  # (Bl, 1, 1)
    box = layout.box_idx.long()[:, None, None, None]  # (N, 1, 1, 1)
    box_cell = (cell_idx == box) & (box >= 0)  # (N, 1, H, W)
    key_block = (kloc == cell_idx)[None] | ((kloc == IN_BOX)[None] & box_cell)  # (N, K, H, W)
    ball_block = bloc == cell_idx  # (Bl, H, W)
    walk = (
        (layout.base_walk[:, None, None, None] & ~door_block[:, None, None])
        & ~key_block[:, None, :, None]
        & ~ball_block[None, :, None, None]
    )  # (N, Bl, K, Cd, H, W)
    target_cell = _target_cell(layout.target_pos, h, w)
    # Hands are empty unless the ball or the key is carried.
    hands = ((bloc[:, 0, 0] != CARRIED)[:, None] & (kloc[:, 0, 0] != CARRIED)[None])
    hands = hands[None, :, :, None, None, None]  # (1, Bl, K, 1, 1, 1)
    k_carried = (kloc == CARRIED)[None, None, :, :, :, None]  # (1, 1, K, 1, 1, 1)
    b_carried = (bloc == CARRIED)[None, :, None, :, :, None]  # (1, Bl, 1, 1, 1, 1)
    cfg = torch.arange(Cd, device=dev)[None, :, None, None]

    out = []
    for dxy in _DIRS:
        fidx = _front_index(h, w, dxy, dev)
        on_grid = fidx >= 0
        key_front = (kloc == fidx) & on_grid  # (K, H, W)
        ball_front = (bloc == fidx) & on_grid  # (Bl, H, W)
        front_ok = _shift_from(layout.base_empty, dxy) & on_grid  # (N, H, W)
        key_at_f = (kloc == fidx)[None] | (
            (kloc == IN_BOX)[None] & (fidx == box) & (box >= 0)
        )  # (N, K, H, W)
        droppable = (
            front_ok[:, None, None, None]
            & ~key_at_f[:, None, :, None]
            & ~(bloc == fidx)[None, :, None, None]
        )  # (N, Bl, K, 1, H, W)
        toggle = _shift_from(closed_cell, dxy)[:, None, None] | (
            _shift_from(unlock_cell, dxy)[:, None, None] & k_carried
        )  # (N, 1, K, Cd, H, W)
        bit = _shift_from(bitmask, dxy).long()[:, None]  # (N, 1, H, W)
        out.append(_Dir(
            fidx=fidx,
            walk=_shift_from(walk, dxy),
            goal=_shift_from(layout.goal, dxy)[:, None, None, None],
            lava=_shift_from(layout.lava, dxy)[:, None, None, None],
            key_pick=key_front[None, None, :, None] & hands,
            ball_pick=ball_front[None, :, None, None] & hands,
            target_pick=_shift_from(target_cell, dxy)[:, None, None, None] & hands,
            key_drop=k_carried & droppable,
            ball_drop=b_carried & ~k_carried & droppable,
            toggle=toggle,
            new_cfg=(cfg | bit)[:, None, None].expand(n, bl, K, Cd, h, w),
            reveal=(kloc == IN_BOX)[None, None, :, None]
            & ((fidx == box) & (box >= 0))[:, None, None],
        ))
    return tuple(out)


def _action_values(
    v: torch.Tensor, t: _Dir, d: int, box_idx: torch.Tensor, gamma: float
) -> Iterator[torch.Tensor]:
    """The backups of the agents facing direction d, (N, Bl, K, Cd, H, W)
    each, in action order: left, right, forward, pickup, drop, toggle,
    done."""
    n, bl, K, Cd, _, h, w = v.shape
    hw = h * w
    CARRIED = hw
    vd = v[:, :, :, :, d]
    dxy = _DIRS[d]
    yield gamma * v[:, :, :, :, (d - 1) % 4]  # left
    yield gamma * v[:, :, :, :, (d + 1) % 4]  # right

    qd = gamma * torch.where(t.walk, _shift_from(vd, dxy), vd)
    qd = torch.where(t.lava, 0.0, qd)
    yield torch.where(t.goal, 1.0, qd)  # forward

    # pickup: the key or the ball goes to CARRIED; the target pays 1.
    g_vd = gamma * vd
    qp = torch.where(t.key_pick, gamma * vd[:, :, CARRIED:CARRIED + 1], g_vd)
    qp = torch.where(t.ball_pick, gamma * vd[:, CARRIED:CARRIED + 1], qp)
    yield torch.where(t.target_pick, 1.0, qp)

    # drop: the carried key or ball lands on the front cell.
    idx = t.fidx.clamp(0, hw - 1)
    v_k_drop = vd.gather(2, idx.expand(n, bl, 1, Cd, h, w))
    v_b_drop = vd.gather(1, idx.expand(n, 1, K, Cd, h, w))
    qdrop = torch.where(t.key_drop, gamma * v_k_drop, g_vd)
    yield torch.where(t.ball_drop, gamma * v_b_drop, qdrop)

    # toggle: open a door; or open the key's box, leaving the key on its cell.
    qt = gamma * torch.where(t.toggle, vd.gather(3, t.new_cfg), vd)
    at_box = box_idx.clamp(0, hw - 1).long().reshape(n, 1, 1, 1, 1, 1)
    v_revealed = vd.gather(2, at_box.expand(n, bl, 1, Cd, h, w))
    yield torch.where(t.reveal, gamma * v_revealed, qt)

    yield g_vd  # done, and every action that fails


def _empty_v(layout: ObstructedLayout) -> torch.Tensor:
    n, h, w = layout.base_walk.shape
    size = h * w + 2
    return torch.zeros(
        (n, size, size, 1 << layout.n_doors, 4, h, w),
        dtype=torch.float32, device=layout.base_walk.device,
    )


def obstructed_vi_values(
    layout: ObstructedLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """V after ``n_sweeps`` Jacobi sweeps from 0: (N, Bl, K, Cd, 4, H, W)."""
    v = _empty_v(layout)
    tables = _tables(layout, v.shape[1], v.shape[2])
    for _ in range(n_sweeps):
        nxt = torch.empty_like(v)
        for d, t in enumerate(tables):
            best = None
            for q in _action_values(v, t, d, layout.box_idx, gamma):
                best = q if best is None else torch.maximum(best, q)
            nxt[:, :, :, :, d] = best
        v = nxt
    return v


def obstructed_value_iteration(
    layout: ObstructedLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact VI over the obstructed domain: (V (N, Bl, K, Cd, 4, H, W) f32,
    greedy policy of the same shape int8, the first best action)."""
    v = obstructed_vi_values(layout, gamma, n_sweeps)
    tables = _tables(layout, v.shape[1], v.shape[2])
    policy = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    for d, t in enumerate(tables):
        best = arg = None
        for a, q in enumerate(_action_values(v, t, d, layout.box_idx, gamma)):
            if best is None:
                best, arg = q, torch.zeros(q.shape, dtype=torch.int8, device=q.device)
            else:
                better = q > best
                best = torch.where(better, q, best)
                arg = torch.where(better, a, arg).to(torch.int8)
        policy[:, :, :, :, d] = arg
    return v, policy


def obstructed_state_index(layout: ObstructedLayout, state: EnvState):
    """(ball, key, cfg, dir, y, x) of each env under its layout, each (N,)."""
    obj = state.grid_obj
    n, h, w = obj.shape
    hw = h * w
    kidx, on_grid = _first_index((obj == OBJ_KEY).reshape(n, hw))
    in_box = ((obj == OBJ_BOX) & (state.contains_obj == OBJ_KEY)).reshape(n, hw).any(dim=1)
    carrying_key = state.carrying_obj == OBJ_KEY
    k = torch.where(
        on_grid, kidx, torch.where(in_box, hw + 1, torch.where(carrying_key, hw, -1))
    )
    is_ball = (obj == OBJ_BALL) & ~_target_cell(layout.target_pos, h, w)
    blidx, has_ball = _first_index(is_ball.reshape(n, hw))
    carrying_ball = state.carrying_obj == OBJ_BALL
    b = torch.where(has_ball, blidx, torch.where(carrying_ball, hw, hw + 1))
    sigma = _at(state.grid_state, layout.door_pos).to(torch.int32)
    opened = (sigma == STATE_OPEN) & (layout.door_init != STATE_OPEN)
    opened = opened & (layout.door_pos[..., 0] >= 0)
    shifts = torch.arange(layout.n_doors, dtype=torch.int32, device=obj.device)
    cfg = (opened.to(torch.int32) << shifts).sum(dim=1)
    return b, k, cfg, state.agent_dir, state.agent_pos[:, 1], state.agent_pos[:, 0]


def _pick(table, layout, state):
    idx = (i.to(torch.int64) for i in obstructed_state_index(layout, state))
    rows = torch.arange(table.shape[0], device=table.device)
    return table[(rows, *idx)]


def obstructed_greedy_action(
    policy: torch.Tensor, layout: ObstructedLayout, state: EnvState
) -> torch.Tensor:
    return _pick(policy, layout, state).to(torch.int32)


def obstructed_state_value(v: torch.Tensor, layout: ObstructedLayout, state: EnvState):
    return _pick(v, layout, state)


def obstructed_steps_to_go(v: torch.Tensor, gamma: float) -> torch.Tensor:
    d = 1.0 + torch.log(torch.clamp(v, min=1e-30)) / math.log(gamma)
    return torch.where(v > 0, torch.round(d), math.inf)
