"""Exact DP over two-key chain tasks: (key1-loc, key2-loc, doors, pose).

Counterpart of ``minigrid_dynamicprogramming_tpu/dp/tabular_twokey.py``:
unlock door A with key A to reach key B, which unlocks door B on the way
to the target, as in BabyAI UnlockToUnlock (the reference's
``envs/babyai/unlock.py:395-471``).  The state space of one layout is

    (k1, k2, door-config, dir, y, x)

with ``k_i`` in {cell 0..HW-1, CARRIED = HW, IN_BOX = HW+1}.  A key is
known by its color (the reference draws two distinct ones), and unlocks
exactly the doors of that color.  One carry slot is shared, so the states
with both keys carried are unreachable.  Not modelled, as in JAX: carrying
a box and closing doors (neither ever shortens a path here).

V is ``(N, K1, K2, Cd, 4, H, W)`` float32 over a leading layout batch N,
``K = H*W + 2``: 59.0 MB a layout at the registered 16x6 with two doors.
A sweep is a loop over the four directions; within one, each action's
backup is a shift, select or gather over the whole (K1, K2, Cd) block and
the max over the seven actions is taken as they come, so one direction's
action values at a time are held beside V (as ``dp/tabular_obstructed.py``
does).  The JAX package runs this domain as XLA only, with no kernel;
the port runs it in plain PyTorch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
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
from minigrid_dynamicprogramming_tpu_torch.dp.tabular_key import _door_tables, _front_index

__all__ = [
    "TwoKeyLayout",
    "extract_twokey_layout",
    "twokey_vi_values",
    "twokey_value_iteration",
    "twokey_state_index",
    "twokey_greedy_action",
    "twokey_state_value",
    "twokey_steps_to_go",
]


@dataclass
class TwoKeyLayout:
    """Static per-layout data with a leading layout batch N.

    ``K = H*W + 2`` locations per key (cell, CARRIED = H*W, IN_BOX =
    H*W+1); ``Cd = 2^D`` door configs (bit d: door d has been opened)."""

    base_walk: torch.Tensor  # (N, H, W) bool — walkable ignoring doors and keys
    base_empty: torch.Tensor  # (N, H, W) bool — may become a drop target
    goal: torch.Tensor  # (N, H, W) bool
    lava: torch.Tensor  # (N, H, W) bool
    target_pos: torch.Tensor  # (N, 2) i32 (x, y); (-1, -1) = goal objective
    door_pos: torch.Tensor  # (N, D, 2) i32; (-1, -1) = unused slot
    door_id: torch.Tensor  # (N, H, W) i32; -1 where no door
    door_init: torch.Tensor  # (N, D) i32 — grid door state at t=0
    door_unlockable: torch.Tensor  # (N, 2, D) bool — per key
    key_color: torch.Tensor  # (N, 2) i32 — key identity (distinct colors)
    box_idx: torch.Tensor  # (N, 2) i32 — per-key box raster cell, -1 none
    key0: torch.Tensor  # (N, 2) i32 — initial key locs (IN_BOX included), -1 none

    @property
    def n_doors(self) -> int:
        return self.door_pos.shape[-2]


def _target_cell(target_pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W) bool: the target's cell; none where target_pos is -1."""
    dev = target_pos.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    return (xs == target_pos[:, 0, None, None]) & (ys == target_pos[:, 1, None, None])


def extract_twokey_layout(
    state: EnvState, max_doors: int = 2, target_type=-1, target_color=-1
) -> TwoKeyLayout:
    """Derive the two-key layouts from a batch-first state.

    ``target_type``/``target_color`` (ints or (N,) tensors) name the
    pickup-terminal object; -1/-1 means a goal-reaching task.  Key sources
    (bare keys and boxes holding a key) are taken in raster order; the
    first two become key slots 0 and 1, known by color from then on.  A
    carried key fills the first empty slot, with the carried color."""
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
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | is_key
        | is_keybox
        | is_door
    ) & ~target_cell
    base_empty = (obj == OBJ_EMPTY) | is_key | is_keybox

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
    door_color = _at(state.grid_color, door_pos).to(torch.int32)

    # Key sources in raster order: bare keys and key boxes (a cell holds at
    # most one of them).
    src = (is_key | is_keybox).reshape(n, hw)
    i1, has1 = _first_index(src)
    flat = torch.arange(hw, device=dev)
    i2, has2 = _first_index(src & (flat[None, :] > i1[:, None]))
    carrying_key = state.carrying_obj == OBJ_KEY
    carry_color = state.carrying_color.to(torch.int32)

    def cell_of(plane, idx):
        return plane.reshape(n, hw).gather(1, idx[:, None])[:, 0].to(torch.int32)

    def slot(idx, has):
        boxed = is_keybox.reshape(n, hw).gather(1, idx[:, None])[:, 0] & has
        loc = torch.where(has, torch.where(boxed, hw + 1, idx), -1)
        color = torch.where(
            boxed, cell_of(state.contains_color, idx), cell_of(state.grid_color, idx)
        )
        return loc, torch.where(has, color, -1), torch.where(boxed, idx, -1)

    loc1, color1, box1 = slot(i1, has1)
    loc2, color2, box2 = slot(i2, has2)
    fills_2 = carrying_key & has1 & ~has2
    loc2 = torch.where(fills_2, hw, loc2)
    color2 = torch.where(fills_2, carry_color, color2)
    fills_1 = carrying_key & ~has1
    loc1 = torch.where(fills_1, hw, loc1)
    color1 = torch.where(fills_1, carry_color, color1)

    key_color = torch.stack([color1, color2], dim=1).to(torch.int32)
    door_unlockable = (
        slot_valid[:, None, :]
        & (door_color[:, None, :] == key_color[:, :, None])
        & (key_color[:, :, None] >= 0)
    )
    return TwoKeyLayout(
        base_walk=base_walk,
        base_empty=base_empty,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        target_pos=target_pos,
        door_pos=door_pos,
        door_id=door_id,
        door_init=door_init,
        door_unlockable=door_unlockable,
        key_color=key_color,
        box_idx=torch.stack([box1, box2], dim=1).to(torch.int32),
        key0=torch.stack([loc1, loc2], dim=1).to(torch.int32),
    )


class _Dir(NamedTuple):
    """The layouts seen from each cell facing one direction; shapes over
    (N, K1, K2, Cd, H, W), 1 where a table does not vary."""

    fidx: torch.Tensor  # (H, W) int64 raster index of the front cell, -1 off the grid
    walk: torch.Tensor  # (N, K1, K2, Cd, H, W) the agent can step forward
    goal: torch.Tensor  # (N, 1, 1, 1, H, W) the goal in front
    lava: torch.Tensor  # (N, 1, 1, 1, H, W) lava in front
    key1_pick: torch.Tensor  # (1, K1, K2, 1, H, W) key 1 in front, hands empty
    key2_pick: torch.Tensor  # (1, K1, K2, 1, H, W) key 2 in front, hands empty
    target_pick: torch.Tensor  # (N, K1, K2, 1, H, W) the target in front, hands empty
    key1_drop: torch.Tensor  # (N, K1, K2, 1, H, W) carried key 1 may land in front
    key2_drop: torch.Tensor  # (N, K1, K2, 1, H, W) carried key 2 may land in front
    toggle: torch.Tensor  # (N, K1, K2, Cd, H, W) a closed door, or a locked one a carried key opens
    new_cfg: torch.Tensor  # (N, K1, K2, Cd, H, W) int64 the config once the door opens
    reveal1: torch.Tensor  # (N, K1, 1, 1, H, W) key 1's box in front, key 1 inside
    reveal2: torch.Tensor  # (N, 1, K2, 1, H, W) key 2's box in front, key 2 inside


def _tables(layout: TwoKeyLayout, K: int) -> Tuple[_Dir, ...]:
    """Everything a sweep reads that does not depend on V, per direction."""
    n, h, w = layout.base_walk.shape
    hw = h * w
    dev = layout.base_walk.device
    CARRIED, IN_BOX = hw, hw + 1
    Cd = 1 << layout.n_doors
    _, door_block, bitmask, locked_cell, closed_cell = _door_tables(layout)
    safe = layout.door_id.clamp(0, layout.n_doors - 1).reshape(n, 1, hw).long().expand(n, 2, hw)
    unlock = locked_cell[:, None] & layout.door_unlockable.gather(2, safe).reshape(n, 2, 1, h, w)

    cell_idx = torch.arange(hw, device=dev).reshape(h, w)
    kloc = torch.arange(K, device=dev)[:, None, None]  # (K, 1, 1)
    box = layout.box_idx.long()[:, :, None, None]  # (N, 2, 1, 1)
    box_cell = (cell_idx == box) & (box >= 0)  # (N, 2, H, W)
    # (N, K, H, W): the cells key 1 (key 2) blocks at each of its locations.
    k1_block = (kloc == cell_idx)[None] | ((kloc == IN_BOX)[None] & box_cell[:, 0:1])
    k2_block = (kloc == cell_idx)[None] | ((kloc == IN_BOX)[None] & box_cell[:, 1:2])
    walk = (
        (layout.base_walk[:, None, None, None] & ~door_block[:, None, None])
        & ~k1_block[:, :, None, None]
        & ~k2_block[:, None, :, None]
    )  # (N, K1, K2, Cd, H, W)
    target_cell = _target_cell(layout.target_pos, h, w)
    k1c = (kloc[:, 0, 0] == CARRIED)[None, :, None, None, None, None]  # (1, K1, 1, 1, 1, 1)
    k2c = (kloc[:, 0, 0] == CARRIED)[None, None, :, None, None, None]  # (1, 1, K2, 1, 1, 1)
    hands = ~k1c & ~k2c  # (1, K1, K2, 1, 1, 1)
    cfg = torch.arange(Cd, device=dev)[None, :, None, None]

    out = []
    for dxy in _DIRS:
        fidx = _front_index(h, w, dxy, dev)
        on_grid = fidx >= 0
        key_front = ((kloc == fidx) & on_grid)  # (K, H, W)
        front_ok = _shift_from(layout.base_empty, dxy) & on_grid  # (N, H, W)
        box_front = (fidx == box) & (box >= 0)  # (N, 2, H, W)
        at_f = (kloc == fidx)[None, None] | (
            (kloc == IN_BOX)[None, None] & box_front[:, :, None]
        )  # (N, 2, K, H, W)
        droppable = (
            front_ok[:, None, None, None]
            & ~at_f[:, 0, :, None, None]
            & ~at_f[:, 1, None, :, None]
        )  # (N, K1, K2, 1, H, W)
        unlock_n = _shift_from(unlock, dxy)  # (N, 2, Cd, H, W)
        toggle = _shift_from(closed_cell, dxy)[:, None, None] | (
            (unlock_n[:, 0, None, None] & k1c) | (unlock_n[:, 1, None, None] & k2c)
        )
        bit = _shift_from(bitmask, dxy).long()[:, None]  # (N, 1, H, W)
        out.append(_Dir(
            fidx=fidx,
            walk=_shift_from(walk, dxy),
            goal=_shift_from(layout.goal, dxy)[:, None, None, None],
            lava=_shift_from(layout.lava, dxy)[:, None, None, None],
            key1_pick=key_front[None, :, None, None] & hands,
            key2_pick=key_front[None, None, :, None] & hands,
            target_pick=_shift_from(target_cell, dxy)[:, None, None, None] & hands,
            key1_drop=k1c & droppable,
            key2_drop=k2c & ~k1c & droppable,
            toggle=toggle,
            new_cfg=(cfg | bit)[:, None, None].expand(n, K, K, Cd, h, w),
            reveal1=(kloc == IN_BOX)[None, :, None, None] & box_front[:, 0, None, None, None],
            reveal2=(kloc == IN_BOX)[None, None, :, None] & box_front[:, 1, None, None, None],
        ))
    return tuple(out)


def _action_values(
    v: torch.Tensor, t: _Dir, d: int, box_idx: torch.Tensor, gamma: float
) -> Iterator[torch.Tensor]:
    """The backups of the agents facing direction d, (N, K1, K2, Cd, H, W)
    each, in action order: left, right, forward, pickup, drop, toggle,
    done."""
    n, K1, K2, Cd, _, h, w = v.shape
    hw = h * w
    CARRIED = hw
    vd = v[:, :, :, :, d]
    dxy = _DIRS[d]
    yield gamma * v[:, :, :, :, (d - 1) % 4]  # left
    yield gamma * v[:, :, :, :, (d + 1) % 4]  # right

    qd = gamma * torch.where(t.walk, _shift_from(vd, dxy), vd)
    qd = torch.where(t.lava, 0.0, qd)
    yield torch.where(t.goal, 1.0, qd)  # forward

    # pickup: a key goes to CARRIED; the target pays 1.
    g_vd = gamma * vd
    qp = torch.where(t.key1_pick, gamma * vd[:, CARRIED:CARRIED + 1], g_vd)
    qp = torch.where(t.key2_pick, gamma * vd[:, :, CARRIED:CARRIED + 1], qp)
    yield torch.where(t.target_pick, 1.0, qp)

    # drop: the carried key lands on the front cell.
    idx = t.fidx.clamp(0, hw - 1)
    qdrop = torch.where(t.key1_drop, gamma * vd.gather(1, idx.expand(n, 1, K2, Cd, h, w)), g_vd)
    yield torch.where(t.key2_drop, gamma * vd.gather(2, idx.expand(n, K1, 1, Cd, h, w)), qdrop)

    # toggle: open a door; or open a key's box, leaving the key on its cell.
    qt = gamma * torch.where(t.toggle, vd.gather(3, t.new_cfg), vd)
    at_box = box_idx.clamp(0, hw - 1).long()
    at1 = at_box[:, 0].reshape(n, 1, 1, 1, 1, 1).expand(n, 1, K2, Cd, h, w)
    at2 = at_box[:, 1].reshape(n, 1, 1, 1, 1, 1).expand(n, K1, 1, Cd, h, w)
    qt = torch.where(t.reveal1, gamma * vd.gather(1, at1), qt)
    yield torch.where(t.reveal2, gamma * vd.gather(2, at2), qt)

    yield g_vd  # done, and every action that fails


def _empty_v(layout: TwoKeyLayout) -> torch.Tensor:
    n, h, w = layout.base_walk.shape
    K = h * w + 2
    return torch.zeros(
        (n, K, K, 1 << layout.n_doors, 4, h, w),
        dtype=torch.float32, device=layout.base_walk.device,
    )


def twokey_vi_values(
    layout: TwoKeyLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """V after ``n_sweeps`` Jacobi sweeps from 0: (N, K1, K2, Cd, 4, H, W)."""
    v = _empty_v(layout)
    tables = _tables(layout, v.shape[1])
    for _ in range(n_sweeps):
        nxt = torch.empty_like(v)
        for d, t in enumerate(tables):
            best = None
            for q in _action_values(v, t, d, layout.box_idx, gamma):
                best = q if best is None else torch.maximum(best, q)
            nxt[:, :, :, :, d] = best
        v = nxt
    return v


def twokey_value_iteration(
    layout: TwoKeyLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact VI over the two-key domain: (V (N, K1, K2, Cd, 4, H, W) f32,
    greedy policy of the same shape int8, the first best action)."""
    v = twokey_vi_values(layout, gamma, n_sweeps)
    tables = _tables(layout, v.shape[1])
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


def twokey_state_index(layout: TwoKeyLayout, state: EnvState):
    """(k1, k2, cfg, dir, y, x) of each env under its layout, each (N,).
    Keys are matched by color against ``layout.key_color``: bare on the
    grid, in their box, or carried."""
    obj = state.grid_obj
    n, h, w = obj.shape
    hw = h * w

    def loc(slot):
        color = layout.key_color[:, slot, None, None]
        bare = ((obj == OBJ_KEY) & (state.grid_color.to(torch.int32) == color)).reshape(n, hw)
        kidx, on_grid = _first_index(bare)
        boxed = (
            (obj == OBJ_BOX)
            & (state.contains_obj == OBJ_KEY)
            & (state.contains_color.to(torch.int32) == color)
        ).reshape(n, hw).any(dim=1)
        carried = (state.carrying_obj == OBJ_KEY) & (
            state.carrying_color.to(torch.int32) == layout.key_color[:, slot]
        )
        return torch.where(on_grid, kidx, torch.where(boxed, hw + 1, torch.where(carried, hw, -1)))

    sigma = _at(state.grid_state, layout.door_pos).to(torch.int32)
    opened = (sigma == STATE_OPEN) & (layout.door_init != STATE_OPEN) & (
        layout.door_pos[..., 0] >= 0
    )
    shifts = torch.arange(layout.n_doors, dtype=torch.int32, device=obj.device)
    cfg = (opened.to(torch.int32) << shifts).sum(dim=1)
    return loc(0), loc(1), cfg, state.agent_dir, state.agent_pos[:, 1], state.agent_pos[:, 0]


def _pick(table, layout, state):
    idx = (i.to(torch.int64) for i in twokey_state_index(layout, state))
    rows = torch.arange(table.shape[0], device=table.device)
    return table[(rows, *idx)]


def twokey_greedy_action(
    policy: torch.Tensor, layout: TwoKeyLayout, state: EnvState
) -> torch.Tensor:
    return _pick(policy, layout, state).to(torch.int32)


def twokey_state_value(v: torch.Tensor, layout: TwoKeyLayout, state: EnvState):
    return _pick(v, layout, state)


def twokey_steps_to_go(v: torch.Tensor, gamma: float) -> torch.Tensor:
    d = 1.0 + torch.log(torch.clamp(v, min=1e-30)) / math.log(gamma)
    return torch.where(v > 0, torch.round(d), math.inf)
