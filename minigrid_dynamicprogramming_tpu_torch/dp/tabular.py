"""Batched exact value iteration over Minigrid layouts.

Counterpart of ``minigrid_dynamicprogramming_tpu/dp/tabular.py``.  The
state space of one layout is

    (door-config, carrying, dir, y, x)

with the config axis enumerating ``carry in {0, 1}`` (fast bit) times the
door states ``sigma_k in {open, closed, locked}`` (mixed radix 3^k).  The
value tensor keeps its factored shape and every action's backup is a
structured operation (dir roll, spatial shift + walkability select, carry
flip, config gather), written out over a leading layout batch ``B`` in
place of JAX's ``vmap``.

Model: left/right/forward/pickup/toggle, drop and done as no-ops; every
action costs one step (discount gamma); the goal pays 1 and terminates;
lava terminates with 0.  So V*[s] = gamma^(d(s) - 1) for the optimal step
count d.  Scope: doors up to ``max_doors`` plus at most one key.

``value_iteration`` here is the plain version of the CUDA kernel in
``dp/cuda_vi.py``; ``solve`` runs the kernel on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
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
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState, resolve_device

__all__ = [
    "TabularLayout",
    "extract_layout",
    "assert_dp_scope",
    "value_iteration",
    "greedy_action",
    "state_value",
    "steps_to_go",
    "env_return",
    "solve",
]

_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))  # DIR_TO_VEC as (dx, dy)


def assert_dp_scope(state: EnvState, max_doors: int) -> None:
    """Host-side scope check over a batch of layouts.

    Raises if a layout has a door past the slot budget that is not open
    (``extract_layout`` freezes those as walls, which is sound for open
    doors only), or more than one key."""
    obj = state.grid_obj.cpu().numpy()
    st = state.grid_state.cpu().numpy()
    b = obj.shape[0]
    is_door = (obj == OBJ_DOOR).reshape(b, -1)
    # Slots go to doors in raster order; rank each door among its layout's.
    rank = np.cumsum(is_door, axis=1)
    overflow = is_door & (rank > max_doors) & (st.reshape(b, -1) != STATE_OPEN)
    if overflow.any():
        bad = np.flatnonzero(overflow.any(axis=1))
        raise ValueError(
            f"layouts {bad.tolist()} have more doors than max_doors="
            f"{max_doors}, and overflow doors that are not open; they would "
            "be frozen as walls and values would be wrong"
        )
    n_keys = (obj == OBJ_KEY).reshape(b, -1).sum(axis=1) + (
        state.carrying_obj.cpu().numpy() == OBJ_KEY
    )
    if (n_keys > 1).any():
        bad = np.flatnonzero(n_keys > 1)
        raise ValueError(
            f"layouts {bad.tolist()} have more than one key; the tabular "
            "domain models one"
        )


@dataclass
class TabularLayout:
    """Static per-layout DP data, with a leading layout batch B."""

    base_walk: torch.Tensor  # (B, H, W) bool — walkable ignoring doors/key
    goal: torch.Tensor  # (B, H, W) bool
    lava: torch.Tensor  # (B, H, W) bool
    door_pos: torch.Tensor  # (B, D, 2) i32 (x, y); (-1, -1) = unused slot
    door_id: torch.Tensor  # (B, H, W) i32 — door slot at cell, -1 if none
    door_unlockable: torch.Tensor  # (B, D) bool — key color matches door's
    key_pos: torch.Tensor  # (B, 2) i32 (x, y); (-1, -1) = no key on grid
    init_cfg: torch.Tensor  # (B,) i32 — config of the t=0 doors/carry

    @property
    def n_doors(self) -> int:
        return self.door_pos.shape[-2]


def _num_cfg(n_doors: int) -> int:
    return 2 * (3**n_doors)


def _first_index(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raster index of each row's first True cell (0 if none) and whether
    there is one; ``mask`` is (B, HW)."""
    hw = mask.shape[1]
    flat = torch.arange(hw, dtype=torch.int32, device=mask.device)
    idx = torch.where(mask, flat, hw).argmin(dim=1)
    return idx, mask.gather(1, idx[:, None])[:, 0]


def _door_slots(is_door: torch.Tensor, max_doors: int):
    """Door slots in raster order: (slots (B, D) int64, valid (B, D))."""
    hw = is_door.shape[1]
    flat = torch.arange(hw, dtype=torch.int32, device=is_door.device)
    rank = torch.where(is_door, flat, hw)
    slots = torch.sort(rank, dim=1, stable=True).indices[:, :max_doors]
    return slots, is_door.gather(1, slots)


def _slot_door_id(slots, slot_valid, hw: int) -> torch.Tensor:
    """(B, HW) door slot at each cell, -1 where none."""
    flat = torch.arange(hw, device=slots.device)
    door_id = torch.full(
        (slots.shape[0], hw), -1, dtype=torch.int32, device=slots.device
    )
    for i in range(slots.shape[1]):
        hit = (flat[None, :] == slots[:, i:i + 1]) & slot_valid[:, i:i + 1]
        door_id = torch.where(hit, i, door_id).to(torch.int32)
    return door_id


def _at(plane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``plane[b, y, x]`` at (x, y) = ``pos[b, k]`` clipped to the grid;
    plane (B, H, W), pos (B, K, 2) -> (B, K)."""
    b, h, w = plane.shape
    x = pos[..., 0].clamp(0, w - 1)
    y = pos[..., 1].clamp(0, h - 1)
    return plane.reshape(b, h * w).gather(1, (y * w + x).to(torch.int64))


def extract_layout(state: EnvState, max_doors: int = 2) -> TabularLayout:
    """Derive the DP layouts from a batch-first state on its device.

    Doors get slots in raster order; doors past ``max_doors`` are frozen:
    walkable only if open at t=0 (see :func:`assert_dp_scope`)."""
    obj = state.grid_obj
    b, h, w = obj.shape
    hw = h * w
    is_door = obj == OBJ_DOOR
    # The key cell is walkable once the key is picked up; the carry == 0
    # block is applied per config in _cfg_tables.
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | (obj == OBJ_KEY)
        | is_door
    )

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

    # The single key: first key cell in raster order (or carried).
    kidx, has_key_cell = _first_index((obj == OBJ_KEY).reshape(b, hw))
    key_pos = torch.where(
        has_key_cell[:, None], torch.stack([kidx % w, kidx // w], dim=-1), -1
    ).to(torch.int32)
    key_color = torch.where(
        has_key_cell,
        state.grid_color.reshape(b, hw).gather(1, kidx[:, None])[:, 0],
        state.carrying_color,
    ).to(torch.int32)
    door_color = _at(state.grid_color, door_pos).to(torch.int32)
    door_unlockable = slot_valid & (door_color == key_color[:, None])

    # t=0 config: door states from the grid + the current carry bit.
    sigma = torch.where(slot_valid, _at(state.grid_state, door_pos).to(torch.int32), 0)
    pow3 = 3 ** torch.arange(max_doors, dtype=torch.int32, device=obj.device)
    carry0 = (state.carrying_obj == OBJ_KEY).to(torch.int32)
    init_cfg = carry0 + 2 * (sigma * pow3).sum(dim=1, dtype=torch.int32)

    return TabularLayout(
        base_walk=base_walk,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        door_pos=door_pos,
        door_id=door_id,
        door_unlockable=door_unlockable,
        key_pos=key_pos,
        init_cfg=init_cfg.to(torch.int32),
    )


def _cfg_tables(layout: TabularLayout):
    """Per-config decodes and the toggle-transition table.

    Returns (walk: (B, C, H, W) bool, toggle_cfg: (B, C, D) int32,
    carry: (C,) int32)."""
    D = layout.n_doors
    C = _num_cfg(D)
    dev = layout.door_id.device
    cfg = torch.arange(C, dtype=torch.int32, device=dev)
    carry = cfg % 2
    code = cfg // 2
    pow3 = 3 ** torch.arange(D, dtype=torch.int32, device=dev)
    sigma = (code[:, None] // pow3[None, :]) % 3  # (C, D)

    # Walkability per config: base minus closed/locked doors minus the key
    # cell while the key is still on the grid (carry == 0).
    did = layout.door_id  # (B, H, W)
    b, h, w = did.shape
    cell_sigma = sigma[:, did.clamp(0, D - 1).long()].transpose(0, 1)  # (B, C, H, W)
    door_block = (did >= 0)[:, None] & (cell_sigma != STATE_OPEN)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    key_cell = (xs == layout.key_pos[:, 0, None, None]) & (
        ys == layout.key_pos[:, 1, None, None]
    )
    key_block = key_cell[:, None] & (carry[None, :, None, None] == 0)
    walk = layout.base_walk[:, None] & ~door_block & ~key_block

    # Toggle table: open -> closed, closed -> open, locked -> open iff
    # carrying a matching key.
    unlockable = layout.door_unlockable[:, None, :] & (carry[None, :, None] == 1)
    sig = sigma[None]
    new_sigma = torch.where(
        sig == STATE_OPEN,
        1,
        torch.where(
            sig == STATE_LOCKED,
            torch.where(unlockable, STATE_OPEN, STATE_LOCKED),
            STATE_OPEN,
        ),
    )
    delta = (new_sigma - sig) * pow3
    toggle_cfg = (cfg[None, :, None] + 2 * delta).to(torch.int32)  # (B, C, D)
    return walk, toggle_cfg, carry


def _shift_from(v: torch.Tensor, dxy) -> torch.Tensor:
    """out(.., y, x) = v(.., y + dy, x + dx), zero beyond the border."""
    dx, dy = dxy
    h, w = v.shape[-2:]
    out = torch.zeros_like(v)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = v[
        ..., max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)
    ]
    return out


def _front_tables(layout: TabularLayout):
    """The layout decoded per facing direction.

    Returns (toggle_cfg, carry, per_dir), where ``per_dir[d]`` holds, for an
    agent facing direction d from each cell: the front cell walkable per
    config (B, C, H, W) bool; goal, lava and the key in front (B, H, W)
    bool; and the slot of the door in front (B, H, W) int32, -1 if none."""
    walk, toggle_cfg, carry = _cfg_tables(layout)
    h, w = walk.shape[-2:]
    ys = torch.arange(h, device=walk.device)[:, None]
    xs = torch.arange(w, device=walk.device)[None, :]
    per_dir = []
    for dx, dy in _DIRS:
        key_front = (xs + dx == layout.key_pos[:, 0, None, None]) & (
            ys + dy == layout.key_pos[:, 1, None, None]
        )
        per_dir.append((
            _shift_from(walk, (dx, dy)),
            _shift_from(layout.goal, (dx, dy)),
            _shift_from(layout.lava, (dx, dy)),
            key_front,
            _shift_from(layout.door_id + 1, (dx, dy)) - 1,
        ))
    return toggle_cfg, carry, per_dir


def _backup_tables(layout: TabularLayout):
    """What one backup needs from the layout, per direction: front
    walkability per config, goal/lava in front, facing the key (carry 0
    only), and the config after toggling the faced door."""
    toggle_cfg, carry, fronts = _front_tables(layout)
    b, C, h, w = fronts[0][0].shape
    D = layout.n_doors
    cfg = torch.arange(C, dtype=torch.int32, device=toggle_cfg.device)[None, :, None, None]
    per_dir = []
    for walk_n, goal_n, lava_n, key_front, front_did in fronts:
        can_pick = key_front[:, None] & (carry[None, :, None, None] == 0)
        safe = front_did.clamp(0, D - 1).reshape(b, 1, h * w).expand(b, C, h * w)
        new_cfg = toggle_cfg.gather(2, safe.to(torch.int64)).reshape(b, C, h, w)
        new_cfg = torch.where((front_did >= 0)[:, None], new_cfg, cfg)
        per_dir.append(
            (walk_n, goal_n[:, None], lava_n[:, None], can_pick, new_cfg.to(torch.int64))
        )
    return per_dir


def _apply_backup(v: torch.Tensor, tables, gamma: float) -> torch.Tensor:
    """One Bellman backup.  v: (B, C, 4, H, W) -> q: (B, A, C, 4, H, W)."""
    b, C, _, h, w = v.shape
    q_left = gamma * torch.roll(v, 1, dims=2)  # dir' = dir - 1
    q_right = gamma * torch.roll(v, -1, dims=2)
    v_flip = v.reshape(b, C // 2, 2, 4, h, w).flip(2).reshape(b, C, 4, h, w)
    q_fwd, q_pick, q_tog = [], [], []
    for d, (dxy, (walk_n, goal_n, lava_n, can_pick, new_cfg)) in enumerate(
        zip(_DIRS, tables)
    ):
        vd = v[:, :, d]
        qd = gamma * torch.where(walk_n, _shift_from(vd, dxy), vd)
        qd = torch.where(lava_n, 0.0, qd)  # lava: terminal, no reward
        qd = torch.where(goal_n, 1.0, qd)  # goal: terminal, reward 1
        q_fwd.append(qd)
        q_pick.append(gamma * torch.where(can_pick, v_flip[:, :, d], vd))
        q_tog.append(gamma * vd.gather(1, new_cfg))
    q_fwd = torch.stack(q_fwd, dim=2)
    q_pick = torch.stack(q_pick, dim=2)
    q_tog = torch.stack(q_tog, dim=2)
    q_stay = gamma * v  # drop (a no-op here) / done
    # Action order: left, right, forward, pickup, drop, toggle, done.
    return torch.stack([q_left, q_right, q_fwd, q_pick, q_stay, q_tog, q_stay], dim=1)


def _backup(v: torch.Tensor, layout: TabularLayout, gamma: float) -> torch.Tensor:
    """One Bellman backup.  v: (B, C, 4, H, W) -> q: (B, A, C, 4, H, W)."""
    return _apply_backup(v, _backup_tables(layout), gamma)


def vi_values(
    layout: TabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> torch.Tensor:
    """V after ``n_sweeps`` Jacobi sweeps from 0: (B, C, 4, H, W) f32."""
    b, h, w = layout.base_walk.shape
    C = _num_cfg(layout.n_doors)
    tables = _backup_tables(layout)
    v = torch.zeros((b, C, 4, h, w), dtype=torch.float32, device=layout.base_walk.device)
    for _ in range(n_sweeps):
        v = _apply_backup(v, tables, gamma).amax(dim=1)
    return v


def greedy_policy(
    v: torch.Tensor, layout: TabularLayout, gamma: float = 0.995
) -> torch.Tensor:
    """The greedy policy of one backup over V: (B, C, 4, H, W) int8."""
    return _backup(v, layout, gamma).argmax(dim=1).to(torch.int8)


def value_iteration(
    layout: TabularLayout, gamma: float = 0.995, n_sweeps: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact VI: (V: (B, C, 4, H, W) f32, policy: (B, C, 4, H, W) int8).

    ``n_sweeps`` bounds the solvable distance: states further than
    n_sweeps steps from the goal keep V = 0."""
    v = vi_values(layout, gamma, n_sweeps)
    return v, greedy_policy(v, layout, gamma)


def steps_to_go(v: torch.Tensor, gamma: float) -> torch.Tensor:
    """d(s) = 1 + log_gamma V(s); inf where unreachable (V = 0)."""
    d = 1.0 + torch.log(torch.clamp(v, min=1e-30)) / math.log(gamma)
    return torch.where(v > 0, torch.round(d), math.inf)


def env_return(v: torch.Tensor, gamma: float, step_count, max_steps: int):
    """The success reward 1 - 0.9 * t_goal / max_steps reached by following
    the optimal policy from a state with ``step_count`` steps taken; 0 if
    out of budget."""
    t_goal = step_count + steps_to_go(v, gamma)
    if not isinstance(max_steps, torch.Tensor):
        # A tensor on t_goal's device, as in ops/step.py:success_reward.
        max_steps = torch.full_like(t_goal, max_steps)
    r = 1.0 - 0.9 * (t_goal / max_steps)
    return torch.where(t_goal <= max_steps, r, 0.0)


def _state_index(layout: TabularLayout, state: EnvState):
    """Current (cfg, dir, y, x) of each env under its layout, each (B,)."""
    D = layout.n_doors
    sigma = _at(state.grid_state, layout.door_pos).to(torch.int32)
    sigma = torch.where(layout.door_pos[..., 0] >= 0, sigma, 0)
    pow3 = 3 ** torch.arange(D, dtype=torch.int32, device=sigma.device)
    carry = (state.carrying_obj == OBJ_KEY).to(torch.int32)
    cfg = carry + 2 * (sigma * pow3).sum(dim=1)
    return cfg, state.agent_dir, state.agent_pos[:, 1], state.agent_pos[:, 0]


def _pick(table: torch.Tensor, layout: TabularLayout, state: EnvState):
    c, d, y, x = (i.to(torch.int64) for i in _state_index(layout, state))
    b = torch.arange(table.shape[0], device=table.device)
    return table[b, c, d, y, x]


def greedy_action(
    policy: torch.Tensor, layout: TabularLayout, state: EnvState
) -> torch.Tensor:
    """Optimal action for each env's current state, (B,) int32."""
    return _pick(policy, layout, state).to(torch.int32)


def state_value(v: torch.Tensor, layout: TabularLayout, state: EnvState):
    return _pick(v, layout, state)


def solve(
    env,
    generator: torch.Generator,
    batch_size: int,
    gamma: float = 0.995,
    n_sweeps: int = 256,
    max_doors: int = 2,
    device="cuda",
):
    """Generate ``batch_size`` layouts from ``generator`` and solve them
    exactly: V from the CUDA kernel on the card (its plain version on the
    CPU), then the policy from one plain backup over V.

    Returns (states, layouts, V, policy), each with a leading batch axis."""
    from minigrid_dynamicprogramming_tpu_torch.dp.cuda_vi import (
        cuda_value_iteration,
    )

    dev = resolve_device(device)
    states = env.generate(generator, env.params, batch_size, dev)
    layouts = extract_layout(states, max_doors=max_doors)
    v = cuda_value_iteration(layouts, gamma=gamma, n_sweeps=n_sweeps)
    return states, layouts, v, greedy_policy(v, layouts, gamma)
