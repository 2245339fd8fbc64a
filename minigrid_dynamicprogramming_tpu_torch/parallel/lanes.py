"""Batch-last (lane-major) step, observation and pool-autoreset rollout.

Counterpart of ``minigrid_dynamicprogramming_tpu/parallel/lanes.py``.  The
batch stays the LAST axis: grid planes are ``(H*W, B)``, view planes
``(view*view, B)``, per-env scalars ``(B,)``.  On a GPU, one thread per env
then touches neighbouring addresses for neighbouring envs, so every
elementwise op below reads and writes coalesced memory.

Per-env cell access is a ``gather``/``scatter`` along the cell axis (the
JAX version uses one-hot compare-and-reduce, which the TPU prefers; the
values are identical).  The egocentric view is a direct per-env gather of
the view cells, with out-of-bounds cells reading as a grey wall, in place
of the JAX version's 7-bit packed funnel shifts (a TPU lane-width device);
the output is bit-identical to ``obs_image_lanes`` in JAX.

Unsigned JAX dtypes are widened (see ``core/state.py``): marks are int32,
and the observation checksum is an int64 sum reduced mod 2**32, which
equals JAX's wrapping uint32 sum.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    ACT_DROP,
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    ACT_RIGHT,
    ACT_TOGGLE,
    COLOR_GREY,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

_U8 = torch.uint8


@dataclass
class LaneState:
    """Batch-last mirror of a batch-first :class:`EnvState`.

    Planes are ``(H*W, B)`` (row-major cells first, envs last); per-env
    scalars are ``(B,)``; vectors put their own axis first.  A pool adds a
    leading rounds axis to every field."""

    grid_obj: torch.Tensor  # (HW, B) u8
    grid_color: torch.Tensor  # (HW, B) u8
    grid_state: torch.Tensor  # (HW, B) u8
    contains_obj: torch.Tensor  # (HW, B) u8
    contains_color: torch.Tensor  # (HW, B) u8
    marks: torch.Tensor  # (HW, B) i32 (u16 in JAX)
    vmarks: torch.Tensor  # (HW, B) i32 (u16 in JAX)

    agent_x: torch.Tensor  # (B,) i32
    agent_y: torch.Tensor  # (B,) i32
    agent_dir: torch.Tensor  # (B,) i32
    carrying_obj: torch.Tensor  # (B,) u8
    carrying_color: torch.Tensor  # (B,) u8
    carrying_contains_obj: torch.Tensor  # (B,) u8
    carrying_contains_color: torch.Tensor  # (B,) u8
    carrying_marks: torch.Tensor  # (B,) i32 (u16 in JAX)

    step_count: torch.Tensor  # (B,) i32
    terminated: torch.Tensor  # (B,) bool
    truncated: torch.Tensor  # (B,) bool

    aux: torch.Tensor  # (AUX, B) i32
    mission: torch.Tensor  # (MS, B) i32

    def replace(self, **changes) -> "LaneState":
        return dataclasses.replace(self, **changes)


_FIELDS = tuple(f.name for f in dataclasses.fields(LaneState))
_PLANES = (
    "grid_obj", "grid_color", "grid_state", "contains_obj", "contains_color",
    "marks", "vmarks",
)
_SCALARS = (
    "agent_dir", "carrying_obj", "carrying_color", "carrying_contains_obj",
    "carrying_contains_color", "carrying_marks", "step_count", "terminated",
    "truncated",
)


def to_lanes(state: EnvState) -> LaneState:
    """Batch-first state -> lane-major state."""
    b, h, w = state.grid_obj.shape
    out = {
        name: getattr(state, name).reshape(b, h * w).T.contiguous()
        for name in _PLANES
    }
    out.update({name: getattr(state, name) for name in _SCALARS})
    out["agent_x"] = state.agent_pos[:, 0].contiguous()
    out["agent_y"] = state.agent_pos[:, 1].contiguous()
    out["aux"] = state.aux.T.contiguous()
    out["mission"] = state.mission.T.contiguous()
    return LaneState(**out)


def from_lanes(params: EnvParams, ls: LaneState) -> EnvState:
    """Lane-major state -> batch-first state."""
    h, w = params.height, params.width
    out = {
        name: getattr(ls, name).T.reshape(-1, h, w).contiguous()
        for name in _PLANES
    }
    out.update({name: getattr(ls, name) for name in _SCALARS})
    out["agent_pos"] = torch.stack([ls.agent_x, ls.agent_y], dim=-1)
    out["aux"] = ls.aux.T.contiguous()
    out["mission"] = ls.mission.T.contiguous()
    return EnvState(**out)


def _dir_vec(agent_dir: torch.Tensor):
    """DIR_TO_VEC as selects: (dx, dy) int32 per env."""
    dx = torch.where(agent_dir == 0, 1, torch.where(agent_dir == 2, -1, 0))
    dy = torch.where(agent_dir == 1, 1, torch.where(agent_dir == 3, -1, 0))
    return dx.to(torch.int32), dy.to(torch.int32)


def _read(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane read ``plane[idx[b], b]``; ``idx`` is (B,) int64."""
    return plane.gather(0, idx[None, :])[0]


def _write(plane: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """Per-lane write ``plane[idx[b], b] = val[b]`` (out of place)."""
    return plane.scatter(0, idx[None, :], val.to(plane.dtype)[None, :])


def step_lanes(
    params: EnvParams, ls: LaneState, action: torch.Tensor
) -> Tuple[LaneState, torch.Tensor, torch.Tensor]:
    """One transition of the core MDP plus truncation, batch-last.

    Returns ``(new_state, reward, terminated)``; ``truncated`` lives on the
    state.  ``no_boxes``/``no_marks`` (registry flags) skip the planes that
    the family can never change."""
    w, h = params.width, params.height
    action = action.to(torch.int32)
    step_count = ls.step_count + 1
    no_boxes = bool(params.opt("no_boxes", False))
    no_marks = bool(params.opt("no_marks", False))

    dx, dy = _dir_vec(ls.agent_dir)
    fx = ls.agent_x + dx
    fy = ls.agent_y + dy
    in_bounds = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    idx = (fy.clamp(0, h - 1) * w + fx.clamp(0, w - 1)).to(torch.int64)

    raw_obj = _read(ls.grid_obj, idx)
    raw_color = _read(ls.grid_color, idx)
    raw_state = _read(ls.grid_state, idx)
    fwd_obj = torch.where(in_bounds, raw_obj, OBJ_WALL).to(_U8)
    fwd_color = torch.where(in_bounds, raw_color, 0).to(_U8)
    fwd_state = torch.where(in_bounds, raw_state, 0).to(_U8)
    if no_boxes:
        fwd_contains = torch.full_like(fwd_obj, OBJ_EMPTY)
        fwd_contains_color = torch.zeros_like(fwd_obj)
    else:
        raw_contains = _read(ls.contains_obj, idx)
        raw_contains_color = _read(ls.contains_color, idx)
        fwd_contains = torch.where(in_bounds, raw_contains, OBJ_EMPTY).to(_U8)
        fwd_contains_color = torch.where(in_bounds, raw_contains_color, 0).to(_U8)
    if no_marks:
        fwd_marks = torch.zeros_like(ls.carrying_marks)
    else:
        raw_marks = _read(ls.marks, idx)
        fwd_marks = torch.where(in_bounds, raw_marks, 0).to(ls.marks.dtype)

    is_left = action == ACT_LEFT
    is_right = action == ACT_RIGHT
    is_forward = action == ACT_FORWARD
    is_pickup = action == ACT_PICKUP
    is_drop = action == ACT_DROP
    is_toggle = action == ACT_TOGGLE

    new_dir = torch.where(
        is_left,
        (ls.agent_dir + 3) % 4,
        torch.where(is_right, (ls.agent_dir + 1) % 4, ls.agent_dir),
    )

    fwd_is_empty = fwd_obj == OBJ_EMPTY
    fwd_open_door = (fwd_obj == OBJ_DOOR) & (fwd_state == STATE_OPEN)
    can_overlap = (
        fwd_is_empty
        | (fwd_obj == OBJ_FLOOR)
        | (fwd_obj == OBJ_GOAL)
        | (fwd_obj == OBJ_LAVA)
    )
    can_enter = can_overlap | fwd_open_door
    moved = is_forward & can_enter & in_bounds
    new_x = torch.where(moved, fx, ls.agent_x)
    new_y = torch.where(moved, fy, ls.agent_y)
    hit_goal = is_forward & (fwd_obj == OBJ_GOAL)
    hit_lava = is_forward & (fwd_obj == OBJ_LAVA)
    terminated = hit_goal | hit_lava
    reward = torch.where(
        hit_goal, success_reward(step_count, params.max_steps), 0.0
    )

    not_carrying = ls.carrying_obj == OBJ_EMPTY
    can_pickup = (fwd_obj == OBJ_KEY) | (fwd_obj == OBJ_BALL) | (fwd_obj == OBJ_BOX)
    do_pickup = is_pickup & can_pickup & not_carrying & in_bounds
    do_drop = is_drop & fwd_is_empty & ~not_carrying & in_bounds

    fwd_is_door = fwd_obj == OBJ_DOOR
    key_matches = (ls.carrying_obj == OBJ_KEY) & (ls.carrying_color == fwd_color)
    do_unlock = is_toggle & fwd_is_door & (fwd_state == STATE_LOCKED) & key_matches
    do_flip = is_toggle & fwd_is_door & (fwd_state != STATE_LOCKED)
    new_door_state = torch.where(
        do_unlock,
        STATE_OPEN,
        torch.where(
            do_flip,
            torch.where(fwd_state == STATE_OPEN, STATE_CLOSED, STATE_OPEN),
            fwd_state,
        ),
    )
    do_open_box = is_toggle & (fwd_obj == OBJ_BOX) & in_bounds

    def cell(pickup_val, drop_val, box_val, else_val):
        """The front cell's new value: pickup, drop, open box, or else."""
        return torch.where(
            do_pickup,
            pickup_val,
            torch.where(do_drop, drop_val, torch.where(do_open_box, box_val, else_val)),
        )

    cell_obj = cell(OBJ_EMPTY, ls.carrying_obj, fwd_contains, fwd_obj)
    cell_color = cell(0, ls.carrying_color, fwd_contains_color, fwd_color)
    cell_state = torch.where(do_pickup | do_drop | do_open_box, 0, new_door_state)

    # A write where the front is out of bounds puts back what is there.
    def write(plane, raw, val):
        return _write(plane, idx, torch.where(in_bounds, val.to(plane.dtype), raw))

    grid_obj = write(ls.grid_obj, raw_obj, cell_obj)
    grid_color = write(ls.grid_color, raw_color, cell_color)
    grid_state = write(ls.grid_state, raw_state, cell_state)
    if no_boxes:
        contains_obj, contains_color = ls.contains_obj, ls.contains_color
    else:
        emptied = do_pickup | do_open_box
        cell_contains = torch.where(
            emptied,
            OBJ_EMPTY,
            torch.where(do_drop, ls.carrying_contains_obj, fwd_contains),
        )
        cell_contains_color = torch.where(
            emptied,
            0,
            torch.where(do_drop, ls.carrying_contains_color, fwd_contains_color),
        )
        contains_obj = write(ls.contains_obj, raw_contains, cell_contains)
        contains_color = write(
            ls.contains_color, raw_contains_color, cell_contains_color
        )
    if no_marks:
        marks = ls.marks
    else:
        cell_marks = torch.where(
            do_pickup | do_open_box,
            0,
            torch.where(do_drop, ls.carrying_marks, fwd_marks),
        )
        marks = write(ls.marks, raw_marks, cell_marks)

    def carried(pickup_val, drop_val, cur):
        """The carried object's new value: pickup, drop, or unchanged."""
        return torch.where(
            do_pickup, pickup_val, torch.where(do_drop, drop_val, cur)
        ).to(cur.dtype)

    # Truncation; a dynamic per-episode limit may come from an aux slot.
    slot = params.opt("dynamic_max_steps_slot")
    limit = params.max_steps if slot is None else ls.aux[slot]
    truncated = step_count >= limit

    new_ls = ls.replace(
        grid_obj=grid_obj,
        grid_color=grid_color,
        grid_state=grid_state,
        contains_obj=contains_obj,
        contains_color=contains_color,
        marks=marks,
        agent_x=new_x,
        agent_y=new_y,
        agent_dir=new_dir,
        carrying_obj=carried(fwd_obj, OBJ_EMPTY, ls.carrying_obj),
        carrying_color=carried(fwd_color, 0, ls.carrying_color),
        carrying_contains_obj=carried(
            fwd_contains, OBJ_EMPTY, ls.carrying_contains_obj
        ),
        carrying_contains_color=carried(
            fwd_contains_color, 0, ls.carrying_contains_color
        ),
        carrying_marks=carried(fwd_marks, 0, ls.carrying_marks),
        step_count=step_count,
        terminated=terminated,
        truncated=truncated,
    )
    return new_ls, reward, terminated


def obs_lanes(params: EnvParams, ls: LaneState):
    """Egocentric view planes ``(obj, color, state, vis)``, each
    ``(view*view, B)`` indexed ``vy * view + vx`` (agent at
    ``vy = view-1, vx = view//2`` facing up).

    With ``u`` the egocentric axis that indexes world rows and ``t`` the one
    that indexes world columns::

        wy(u) = ay + py*u + qy      wx(t) = ax + px*t + qx
        (u, t) = (vx, vy) facing +-x (dir 0/2), (vy, vx) facing +-y (dir 1/3)

    Each view cell is one gather from the grid planes; cells outside the
    grid read as a grey wall."""
    w, h = params.width, params.height
    v = params.agent_view_size
    hs = v // 2
    dev = ls.agent_dir.device

    d = ls.agent_dir
    horiz = d % 2 == 0
    sgn = torch.where((d == 0) | (d == 1), 1, -1).to(torch.int32)
    py = torch.where(horiz, sgn, -sgn)
    qy = ls.agent_y + torch.where(horiz, -sgn * hs, sgn * (v - 1))
    px = -sgn
    qx = ls.agent_x + sgn * torch.where(horiz, v - 1, hs)

    cells = torch.arange(v * v, dtype=torch.int32, device=dev)[:, None]
    vy, vx = cells // v, cells % v
    u = torch.where(horiz, vx, vy)  # (VV, B)
    t = torch.where(horiz, vy, vx)
    wy = py * u + qy
    wx = px * t + qx
    inb = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    idx = (wy.clamp(0, h - 1) * w + wx.clamp(0, w - 1)).to(torch.int64)

    obj = torch.where(inb, ls.grid_obj.gather(0, idx), OBJ_WALL).to(_U8)
    color = torch.where(inb, ls.grid_color.gather(0, idx), COLOR_GREY).to(_U8)
    is_door = obj == OBJ_DOOR
    # Only doors carry a state in the wire format.
    obj_state = torch.where(is_door, ls.grid_state.gather(0, idx), 0).to(_U8)

    if params.see_through_walls:
        vis = torch.ones_like(obj, dtype=torch.bool)
    else:
        blocked = (obj == OBJ_WALL) | (is_door & (obj_state >= STATE_CLOSED))
        vis = _process_vis_lanes(~blocked, v)

    # Carried-object overlay at the agent cell.
    agent_cell = (v - 1) * v + hs
    obj[agent_cell] = ls.carrying_obj
    color[agent_cell] = torch.where(
        ls.carrying_obj == OBJ_EMPTY, 0, ls.carrying_color
    ).to(_U8)
    obj_state[agent_cell] = 0
    return obj, color, obj_state, vis


def _process_vis_lanes(see: torch.Tensor, v: int) -> torch.Tensor:
    """The reference's sequential visibility sweep over ``see`` ((v*v, B)
    bool), one view row per int32 bitboard (bit i = column i); the result
    has the same shape."""
    row_mask = (1 << v) - 1
    bit = torch.arange(v, dtype=torch.int32, device=see.device)[None, :, None]
    sees = (see.reshape(v, v, -1).to(torch.int32) << bit).sum(1, dtype=torch.int32)

    rows = [torch.zeros_like(sees[0]) for _ in range(v)]
    rows[v - 1] = torch.full_like(sees[0], 1 << (v // 2))
    not_last = row_mask ^ (1 << (v - 1))
    not_first = row_mask ^ 1
    for j in reversed(range(v)):
        row, see_row = rows[j], sees[j]
        for _ in range(v - 1):
            row = row | (((row & see_row) << 1) & row_mask)
        cond1 = row & see_row & not_last
        for _ in range(v - 1):
            row = row | ((row & see_row) >> 1)
        cond2 = row & see_row & not_first
        rows[j] = row
        if j > 0:
            rows[j - 1] = (
                rows[j - 1]
                | cond1
                | ((cond1 << 1) & row_mask)
                | cond2
                | (cond2 >> 1)
            )
    bits = (torch.stack(rows)[:, None, :] >> bit) & 1  # (v, v, B)
    return bits.reshape(v * v, -1).to(torch.bool)


def obs_image_lanes(params: EnvParams, ls: LaneState) -> torch.Tensor:
    """(B, view, view, 3) uint8 batch in the reference's ``[x, y]`` layout."""
    v = params.agent_view_size
    obj, color, obj_state, vis = obs_lanes(params, ls)
    img = torch.stack([obj, color, obj_state], dim=1)  # (VV, 3, B)
    img = torch.where(vis[:, None, :], img, 0).to(_U8)
    img = img.reshape(v, v, 3, -1)  # [vy, vx, 3, B]
    return img.permute(3, 1, 0, 2).contiguous()  # [B, vx, vy, 3]


def step_lanes_env(
    env: Environment, ls: LaneState, action: torch.Tensor
) -> Tuple[LaneState, torch.Tensor, torch.Tensor]:
    """:func:`step_lanes` under the env's params.  Hooked families are not
    ported yet (their ``Environment`` refuses to build), so there are no
    per-family hooks to run here."""
    return step_lanes(env.params, ls, action)


class LaneRolloutResult(NamedTuple):
    final_state: LaneState
    total_reward: torch.Tensor  # () f32
    episodes: torch.Tensor  # () i64
    steps: int
    obs_checksum: torch.Tensor  # () i64 in [0, 2**32): JAX's wrapping u32 sum
    resets_per_env: torch.Tensor  # (B,) i32


def _select_lanes(
    done: torch.Tensor, fresh: LaneState, cur: LaneState, skip: tuple = ()
) -> LaneState:
    """Per-lane ``where(done, fresh, cur)``; fields in ``skip`` keep the
    current value (planes that are constant for the env family)."""
    out = {}
    for name in _FIELDS:
        a, b = getattr(fresh, name), getattr(cur, name)
        out[name] = b if name in skip else torch.where(done, a, b)
    return LaneState(**out)


def _select_pool(pool: LaneState, r_idx: torch.Tensor, rounds: int, skip: tuple = ()):
    """Pick each lane's pool round: pool fields are (R, ...field-shape...).
    Fields in ``skip`` are left as round 0 (the caller ignores them)."""
    out = {}
    for name in _FIELDS:
        leaf = getattr(pool, name)
        picked = leaf[0]
        if name not in skip:
            for r in range(1, rounds):
                picked = torch.where(r_idx == r, leaf[r], picked)
        out[name] = picked
    return LaneState(**out)


def _skip_fields(params: EnvParams) -> tuple:
    skip = ()
    if params.opt("no_boxes", False):
        skip += ("contains_obj", "contains_color")
    if params.opt("no_marks", False):
        skip += ("marks", "vmarks")
    if params.opt("fixed_mission", False):
        skip += ("mission",)
    if params.opt("fixed_aux", False):
        skip += ("aux",)
    return skip


def lane_rollout(
    env: Environment,
    generator: Optional[torch.Generator],
    batch_size: int,
    horizon: int = 256,
    autoreset: str = "pool",
    pool_rounds: int = 4,
    actions: Optional[torch.Tensor] = None,
    device="cuda",
) -> LaneRolloutResult:
    """Rollout on the lane-major path, uniform random actions unless given.

    Auto-reset modes:

    * ``"pool"`` — pregenerate ``pool_rounds`` layout batches; the k-th
      reset of a slot draws round ``k % pool_rounds``;
    * ``"cached"`` — each slot replays its initial layout.

    The layouts and the actions come from ``generator`` (a
    ``torch.Generator`` on ``device``); ``actions``, if given, is a
    ``(horizon, batch_size)`` integer tensor used instead of the draws.
    The observation encoder runs every step and is folded into
    ``obs_checksum``, so the steps/s include observations."""
    dev = resolve_device(device)
    pool = _lane_pool(env, generator, batch_size, autoreset, pool_rounds, dev)
    return _lane_scan(
        env, generator, pool, batch_size, horizon, autoreset, pool_rounds, actions
    )


def _rounds(autoreset: str, pool_rounds: int) -> int:
    if autoreset not in ("pool", "cached"):
        raise ValueError(f"unknown autoreset mode {autoreset!r}")
    return pool_rounds if autoreset == "pool" else 1


def _lane_pool(
    env: Environment,
    generator: torch.Generator,
    batch_size: int,
    autoreset: str,
    pool_rounds: int,
    device,
) -> LaneState:
    """``rounds`` generated layout batches, lane-major, stacked on a leading
    rounds axis."""
    rounds = _rounds(autoreset, pool_rounds)
    flat = env.generate(generator, env.params, rounds * batch_size, device)
    per_round = [
        to_lanes(
            EnvState(
                **{
                    f.name: getattr(flat, f.name)[r * batch_size:(r + 1) * batch_size]
                    for f in dataclasses.fields(EnvState)
                }
            )
        )
        for r in range(rounds)
    ]
    return LaneState(
        **{
            name: torch.stack([getattr(ls, name) for ls in per_round])
            for name in _FIELDS
        }
    )


def _lane_scan(
    env: Environment,
    generator: Optional[torch.Generator],
    pool: LaneState,
    batch_size: int,
    horizon: int,
    autoreset: str,
    pool_rounds: int,
    actions: Optional[torch.Tensor] = None,
) -> LaneRolloutResult:
    """Step ``horizon`` times from round 0 of ``pool`` with autoreset."""
    rounds = _rounds(autoreset, pool_rounds)
    dev = pool.grid_obj.device
    if actions is None:
        if generator is None:
            raise ValueError("pass a generator or an actions tensor")
    elif tuple(actions.shape) != (horizon, batch_size):
        raise ValueError(
            f"actions must be ({horizon}, {batch_size}), got {tuple(actions.shape)}"
        )
    params = env.params
    skip = _skip_fields(params)
    init_ls = LaneState(**{name: getattr(pool, name)[0] for name in _FIELDS})

    ls = init_ls
    reset_count = torch.zeros(batch_size, dtype=torch.int32, device=dev)
    rewards = torch.empty(horizon, dtype=torch.float32, device=dev)
    dones = torch.empty(horizon, dtype=torch.int64, device=dev)
    checksums = torch.empty(horizon, dtype=torch.int64, device=dev)
    for t in range(horizon):
        if actions is None:
            act = torch.randint(
                0, env.action_dim, (batch_size,), generator=generator,
                device=dev, dtype=torch.int32,
            )
        else:
            act = actions[t].to(dev)
        ls, reward, term = step_lanes_env(env, ls, act)
        done = term | ls.truncated
        reset_count = reset_count + done.to(torch.int32)
        if autoreset == "pool":
            fresh = _select_pool(pool, reset_count % rounds, rounds, skip)
        else:
            fresh = init_ls
        ls = _select_lanes(done, fresh, ls, skip)
        obj, color, obj_state, vis = obs_lanes(params, ls)
        seen = (obj.to(torch.int64) + color + obj_state) * vis
        checksums[t] = seen.sum()
        rewards[t] = reward.sum()
        dones[t] = done.sum()
    return LaneRolloutResult(
        final_state=ls,
        total_reward=rewards.sum(),
        episodes=dones.sum(),
        steps=batch_size * horizon,
        obs_checksum=checksums.sum() % (1 << 32),
        resets_per_env=reset_count,
    )
