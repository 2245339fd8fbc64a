"""Exact DP over the key-tracking domain.

Counterpart of ``minigrid_dynamicprogramming_tpu/dp/tabular_key.py``.  The
state space of one layout is

    (key-loc, door-config, dir, y, x),   key-loc in {cell 0..H*W-1, CARRIED}

with doors as a binary config axis (bit k = door k has been opened;
closing an open door never helps, so it is a value-neutral self-loop).
This domain expresses dropping the key: the dropped key lands on a real
cell and blocks it.  Objectives: reach a goal cell (``target_pos =
(-1, -1)``) or pick up a target object.  Every backup is a structured
shift/select/gather over a leading layout batch ``B``.

``key_value_iteration`` is the plain version of the CUDA kernel in
``dp/cuda_vi.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    STATE_LOCKED,
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

__all__ = [
    "KeyTabularLayout",
    "extract_key_layout",
    "key_value_iteration",
    "key_state_index",
    "key_greedy_action",
    "key_state_value",
    "key_steps_to_go",
]


@dataclass
class KeyTabularLayout:
    """Static per-layout data with a leading layout batch B.

    ``K = H*W + 1`` key locations (raster cell index, or ``H*W`` =
    carried); ``Cd = 2^D`` door configs."""

    base_walk: torch.Tensor  # (B, H, W) bool — walkable ignoring doors/key
    base_empty: torch.Tensor  # (B, H, W) bool — cells the key may drop on
    goal: torch.Tensor  # (B, H, W) bool
    lava: torch.Tensor  # (B, H, W) bool
    target_pos: torch.Tensor  # (B, 2) i32 (x, y); (-1, -1) = goal objective
    door_pos: torch.Tensor  # (B, D, 2) i32; (-1, -1) = unused slot
    door_id: torch.Tensor  # (B, H, W) i32; -1 where no door
    door_init: torch.Tensor  # (B, D) i32 — grid door state at t=0
    door_unlockable: torch.Tensor  # (B, D) bool
    key0: torch.Tensor  # (B,) i32 — initial key loc (H*W carried, -1 none)

    @property
    def n_doors(self) -> int:
        return self.door_pos.shape[-2]


def extract_key_layout(
    state: EnvState,
    max_doors: int = 7,
    target_type=-1,
    target_color=-1,
) -> KeyTabularLayout:
    """Derive the key-tracking DP layouts from a batch-first state.

    ``target_type``/``target_color`` (ints or (B,) tensors) select the
    pickup-terminal object; -1/-1 means a goal-reaching task.  The target's
    cell is not walkable; the key's cell is handled per key-loc."""
    obj = state.grid_obj
    b, h, w = obj.shape
    hw = h * w
    dev = obj.device
    is_door = obj == OBJ_DOOR
    is_key = obj == OBJ_KEY
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | is_key
        | is_door
    )
    # A carried key may be dropped only on a literally empty front cell.
    base_empty = (obj == OBJ_EMPTY) | is_key

    slots, slot_valid = _door_slots(is_door.reshape(b, hw), max_doors)
    door_pos = torch.stack(
        [
            torch.where(slot_valid, slots % w, -1),
            torch.where(slot_valid, slots // w, -1),
        ],
        dim=-1,
    ).to(torch.int32)
    door_id = _slot_door_id(slots, slot_valid, hw).reshape(b, h, w)
    overflow = is_door & (door_id < 0)
    base_walk = base_walk & ~(overflow & (state.grid_state != STATE_OPEN))

    door_init = torch.where(
        slot_valid, _at(state.grid_state, door_pos).to(torch.int32), STATE_OPEN
    ).to(torch.int32)

    kidx, has_key_cell = _first_index(is_key.reshape(b, hw))
    carrying_key = state.carrying_obj == OBJ_KEY
    key0 = torch.where(
        has_key_cell, kidx, torch.where(carrying_key, hw, -1)
    ).to(torch.int32)
    key_color = torch.where(
        has_key_cell,
        state.grid_color.reshape(b, hw).gather(1, kidx[:, None])[:, 0],
        state.carrying_color,
    ).to(torch.int32)
    door_color = _at(state.grid_color, door_pos).to(torch.int32)
    door_unlockable = slot_valid & (door_color == key_color[:, None])

    # Target object: first cell matching (type, color); its cell blocks.
    def per_env(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(-1, 1, 1)

    t_type, t_color = per_env(target_type), per_env(target_color)
    is_target = (
        (obj.to(torch.int32) == t_type)
        & (state.grid_color.to(torch.int32) == t_color)
        & (t_type >= 0)
    )
    tidx, has_target = _first_index(is_target.reshape(b, hw))
    target_pos = torch.where(
        has_target[:, None], torch.stack([tidx % w, tidx // w], dim=-1), -1
    ).to(torch.int32)
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    target_cell = (xs == target_pos[:, 0, None, None]) & (
        ys == target_pos[:, 1, None, None]
    )
    base_walk = base_walk & ~target_cell

    return KeyTabularLayout(
        base_walk=base_walk,
        base_empty=base_empty,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        target_pos=target_pos,
        door_pos=door_pos,
        door_id=door_id,
        door_init=door_init,
        door_unlockable=door_unlockable,
        key0=key0,
    )


def _front_index(h: int, w: int, dxy, device) -> torch.Tensor:
    """(H, W) raster index of the front cell per agent cell; -1 if OOB."""
    dx, dy = dxy
    ys = torch.arange(h, device=device)[:, None] + dy
    xs = torch.arange(w, device=device)[None, :] + dx
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return torch.where(ok, ys * w + xs, -1)


def _door_tables(layout: KeyTabularLayout):
    """Per-(config, cell) door openness and toggle data, each (B, Cd, H, W)
    bool except ``bitmask`` (B, H, W) int32: (open_cell, door_block,
    bitmask, locked_cell, closed_cell)."""
    D = layout.n_doors
    Cd = 1 << D
    did = layout.door_id
    b, h, w = did.shape
    cfg = torch.arange(Cd, dtype=torch.int32, device=did.device)
    safe = did.clamp(0, D - 1)
    opened_bit = (cfg[None, :, None, None] >> safe[:, None]) & 1
    init_cell = layout.door_init.gather(1, safe.reshape(b, h * w).long()).reshape(b, h, w)
    is_door_cell = (did >= 0)[:, None]
    open_cell = is_door_cell & (
        (opened_bit == 1) | (init_cell == STATE_OPEN)[:, None]
    )
    locked_cell = (
        is_door_cell & (opened_bit == 0) & (init_cell == STATE_LOCKED)[:, None]
    )
    closed_cell = is_door_cell & ~open_cell & ~locked_cell
    door_block = is_door_cell & ~open_cell
    bitmask = torch.where(did >= 0, 1 << safe, 0).to(torch.int32)
    return open_cell, door_block, bitmask, locked_cell, closed_cell


def _unlock_cell(layout: KeyTabularLayout, locked_cell):
    """Locked door cells whose door the layout's key unlocks."""
    b, h, w = layout.door_id.shape
    safe = layout.door_id.clamp(0, layout.n_doors - 1).reshape(b, h * w).long()
    unlockable = layout.door_unlockable.gather(1, safe).reshape(b, h, w)
    return locked_cell & unlockable[:, None]


class _Front(NamedTuple):
    """The layout seen from each cell facing one direction."""

    walk: torch.Tensor  # (B, Cd, H, W) front cell walkable in config c, the key aside
    goal: torch.Tensor  # (B, H, W) goal in front
    lava: torch.Tensor  # (B, H, W) lava in front
    target: torch.Tensor  # (B, H, W) target object in front
    droppable: torch.Tensor  # (B, H, W) the key may be dropped in front
    closed: torch.Tensor  # (B, Cd, H, W) a closed door in front
    unlock: torch.Tensor  # (B, Cd, H, W) a locked door the key opens in front
    bit: torch.Tensor  # (B, H, W) int32 config bit of the door in front


def _front_tables(layout: KeyTabularLayout) -> Tuple[_Front, ...]:
    """The layout decoded per facing direction, one :class:`_Front` each."""
    _, door_block, bitmask, locked_cell, closed_cell = _door_tables(layout)
    unlock_cell = _unlock_cell(layout, locked_cell)
    h, w = layout.door_id.shape[1:]
    dev = layout.door_id.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    target_cell = (xs == layout.target_pos[:, 0, None, None]) & (
        ys == layout.target_pos[:, 1, None, None]
    )
    walk = layout.base_walk[:, None] & ~door_block  # (B, Cd, H, W)
    fronts = []
    for dxy in _DIRS:
        in_grid = (_front_index(h, w, dxy, dev) >= 0)[None]
        fronts.append(_Front(
            walk=_shift_from(walk, dxy),
            goal=_shift_from(layout.goal, dxy),
            lava=_shift_from(layout.lava, dxy),
            target=_shift_from(target_cell, dxy),
            droppable=_shift_from(layout.base_empty, dxy)
            & in_grid
            & ~_shift_from(layout.door_id >= 0, dxy),
            closed=_shift_from(closed_cell, dxy),
            unlock=_shift_from(unlock_cell, dxy),
            bit=_shift_from(bitmask, dxy),
        ))
    return tuple(fronts)


def _backup(v: torch.Tensor, layout: KeyTabularLayout, gamma: float):
    """One Bellman backup over V: (B, K, Cd, 4, H, W) -> q: (B, A, K, Cd,
    4, H, W), action order left, right, forward, pickup, drop, toggle, done."""
    b, K, Cd, _, h, w = v.shape
    dev = v.device
    CARRIED = h * w
    kloc = torch.arange(K, device=dev)
    carried = (kloc == CARRIED)[None, :, None, None, None]  # (1, K, 1, 1, 1)

    q_left = gamma * torch.roll(v, 1, dims=3)
    q_right = gamma * torch.roll(v, -1, dims=3)
    cfg = torch.arange(Cd, dtype=torch.int32, device=dev)[None, :, None, None]

    q_fwd, q_pick, q_drop, q_tog = [], [], [], []
    for d, (dxy, f) in enumerate(zip(_DIRS, _front_tables(layout))):
        vd = v[:, :, :, d]  # (B, K, Cd, H, W)
        fidx = _front_index(h, w, dxy, dev)
        key_front = (kloc[:, None, None] == fidx[None]) & (fidx >= 0)[None]  # (K, H, W)

        # forward: blocked where the key lies in front.
        walk_n = f.walk[:, None] & ~key_front[None, :, None]  # (B, K, Cd, H, W)
        qd = gamma * torch.where(walk_n, _shift_from(vd, dxy), vd)
        qd = torch.where(f.lava[:, None, None], 0.0, qd)
        qd = torch.where(f.goal[:, None, None], 1.0, qd)
        q_fwd.append(qd)

        # pickup: key -> carried, or target -> terminal reward 1; both need
        # empty hands (k != CARRIED).
        v_carried = vd[:, CARRIED:CARRIED + 1]
        qp = torch.where(key_front[None, :, None], gamma * v_carried, gamma * vd)
        qp = torch.where(f.target[:, None, None] & ~carried, 1.0, qp)
        q_pick.append(qp)

        # drop: only the carried slice changes; the key lands on the front
        # cell (empty, not a door), i.e. key-loc jumps CARRIED -> front.
        idx = fidx.clamp(0, K - 1).expand(b, 1, Cd, h, w)
        v_at_drop = vd.gather(1, idx)[:, 0]  # (B, Cd, H, W)
        q_carried = gamma * torch.where(
            f.droppable[:, None], v_at_drop, vd[:, CARRIED]
        )
        qdrop = gamma * vd
        qdrop[:, CARRIED] = q_carried
        q_drop.append(qdrop)

        # toggle: closed -> open always; locked -> open iff carrying the
        # matching key; open -> value-neutral self-loop.
        allowed = f.closed[:, None] | (f.unlock[:, None] & carried)
        new_cfg = (cfg | f.bit[:, None]).long()  # (B, Cd, H, W)
        v_open = vd.gather(2, new_cfg[:, None].expand(b, K, Cd, h, w))
        q_tog.append(gamma * torch.where(allowed, v_open, vd))

    q_fwd = torch.stack(q_fwd, dim=3)
    q_pick = torch.stack(q_pick, dim=3)
    q_drop = torch.stack(q_drop, dim=3)
    q_tog = torch.stack(q_tog, dim=3)
    q_stay = gamma * v
    return torch.stack(
        [q_left, q_right, q_fwd, q_pick, q_drop, q_tog, q_stay], dim=1
    )


def key_vi_values(
    layout: KeyTabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """V after ``n_sweeps`` Jacobi sweeps from 0: (B, K, Cd, 4, H, W)."""
    b, h, w = layout.base_walk.shape
    K = h * w + 1
    Cd = 1 << layout.n_doors
    v = torch.zeros(
        (b, K, Cd, 4, h, w), dtype=torch.float32, device=layout.base_walk.device
    )
    for _ in range(n_sweeps):
        v = _backup(v, layout, gamma).amax(dim=1)
    return v


def key_value_iteration(
    layout: KeyTabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact VI over the key-tracking domain: (V: (B, K, Cd, 4, H, W) f32,
    policy: same shape int8)."""
    v = key_vi_values(layout, gamma, n_sweeps)
    policy = _backup(v, layout, gamma).argmax(dim=1).to(torch.int8)
    return v, policy


def key_state_index(layout: KeyTabularLayout, state: EnvState):
    """(k, cfg, dir, y, x) of each env under its layout, each (B,)."""
    b, h, w = layout.base_walk.shape
    D = layout.n_doors
    kidx, on_grid = _first_index((state.grid_obj == OBJ_KEY).reshape(b, h * w))
    k = torch.where(on_grid, kidx, h * w)  # carried otherwise
    sigma = _at(state.grid_state, layout.door_pos).to(torch.int32)
    opened = (sigma == STATE_OPEN) & (layout.door_init != STATE_OPEN)
    opened = opened & (layout.door_pos[..., 0] >= 0)
    shifts = torch.arange(D, dtype=torch.int32, device=sigma.device)
    cfg = (opened.to(torch.int32) << shifts).sum(dim=1)
    return k, cfg, state.agent_dir, state.agent_pos[:, 1], state.agent_pos[:, 0]


def _pick(table, layout, state):
    k, c, d, y, x = (i.to(torch.int64) for i in key_state_index(layout, state))
    b = torch.arange(table.shape[0], device=table.device)
    return table[b, k, c, d, y, x]


def key_greedy_action(
    policy: torch.Tensor, layout: KeyTabularLayout, state: EnvState
) -> torch.Tensor:
    return _pick(policy, layout, state).to(torch.int32)


def key_state_value(v: torch.Tensor, layout: KeyTabularLayout, state: EnvState):
    return _pick(v, layout, state)


def key_steps_to_go(v: torch.Tensor, gamma: float) -> torch.Tensor:
    d = 1.0 + torch.log(torch.clamp(v, min=1e-30)) / math.log(gamma)
    return torch.where(v > 0, torch.round(d), math.inf)
