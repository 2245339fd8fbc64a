"""Batch-last (lane-major) step, observation and autoreset rollout.

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

JAX runs a rollout's horizon as one compiled ``lax.scan``.  Here one step
of it (``_Scan.step``) reads and writes only tensors of fixed address,
with its step index on the device, so that on a CUDA device
``_lane_scan`` captures it once as a CUDA graph and replays it; on the
CPU the same step runs in a Python loop (``_lane_scan_eager``).  On a
CUDA device the step's observation and its checksum are one hand-written
kernel (``csrc/obs.cu``, :func:`obs_checksum_lanes`); everywhere else,
and in ``obs_lanes`` and ``obs_image_lanes`` on any device, they are
plain code.  On a CUDA device, for a family with no hook, the step's
transition, autoreset and write-back are one more (``csrc/step.cu``,
:func:`step_lanes_kernel`, in place; :func:`step_path` decides); hooked
families, BabyAI and the CPU take the plain step with autoreset,
:class:`AutoresetStep`, which PPO's collector also takes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch import _kernels
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
from minigrid_dynamicprogramming_tpu_torch.parallel.sharding import EnvGroup, all_reduce, shard_batch
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

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

    def map(self, fn) -> "LaneState":
        """``fn`` applied to every field."""
        return LaneState(**{name: fn(getattr(self, name)) for name in _FIELDS})

    def clone(self) -> "LaneState":
        return self.map(torch.clone)

    def round(self, r: int) -> "LaneState":
        """Round ``r`` of a pool: each field's views at leading index ``r``."""
        return self.map(lambda x: x[r])

    def copy_(self, src: "LaneState") -> None:
        """Every field of ``src`` copied into this state's tensors, in
        place.  A field that is this state's own tensor is left alone: its
        copy onto itself does nothing."""
        for name in _FIELDS:
            getattr(self, name).copy_(getattr(src, name))


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
    obj_state[agent_cell].zero_()
    return obj, color, obj_state, vis


# The widest view whose rows fit an int64 bitboard with the sign bit clear.
MAX_VIEW = 63


def _spread(row: torch.Tensor, see_row: torch.Tensor, v: int, up: bool) -> torch.Tensor:
    """``row`` grown along ``see_row`` (v-bit int64 bitboards): a set bit
    moves to the next column (the next higher bit if ``up``, else the next
    lower) while the column it leaves is see-through, as far as that goes.
    The reference moves one column a pass, v - 1 passes; this doubles the
    reach each round (a Kogge-Stone fill), ``run`` holding the columns that
    start k see-through columns in a row.  Bits moved past column v - 1
    are left for the caller to mask; they never come back."""
    run, k = see_row, 1
    while True:
        row = row | (((row & run) << k) if up else ((row & run) >> k))
        if 2 * k >= v:
            return row
        run = run & ((run >> k) if up else (run << k))
        k *= 2


def _process_vis_lanes(see: torch.Tensor, v: int) -> torch.Tensor:
    """The reference's sequential visibility sweep over ``see`` ((v*v, B)
    bool), one view row per int64 bitboard (bit i = column i); the result
    has the same shape.  Views wider than 63 columns do not fit a
    bitboard and raise."""
    if v > MAX_VIEW:
        raise ValueError(f"agent_view_size {v} exceeds the visibility sweep's {MAX_VIEW}")
    row_mask = (1 << v) - 1
    bit = torch.arange(v, dtype=torch.int64, device=see.device)[None, :, None]
    sees = (see.reshape(v, v, -1).to(torch.int64) << bit).sum(1, dtype=torch.int64)

    rows = [torch.zeros_like(sees[0]) for _ in range(v)]
    rows[v - 1] = torch.full_like(sees[0], 1 << (v // 2))
    not_last = row_mask ^ (1 << (v - 1))
    not_first = row_mask ^ 1
    for j in reversed(range(v)):
        row, see_row = rows[j], sees[j]
        row = _spread(row, see_row, v, up=True) & row_mask
        cond1 = row & see_row & not_last
        row = _spread(row, see_row, v, up=False)
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


def obs_checksum_lanes(params: EnvParams, ls: LaneState, out: torch.Tensor, t: torch.Tensor) -> None:
    """Adds the observation checksum of ``ls``, the sum over its lanes and
    view cells of ``(obj + color + state) * vis`` from :func:`obs_lanes`,
    into ``out[t]`` (``out`` int64, ``t`` a one-element int64 index on its
    device).

    On a CUDA device it is one launch of ``csrc/obs.cu`` on the current
    stream (:func:`obs_instance` picks the kernel's instance; counters
    ``obs.launches`` and ``obs.launches.<instance>``): it checks the
    tensors it reads and raises on any other input, and on views wider
    than ``MAX_VIEW``; there is no fallback.  Elsewhere it runs the plain
    :func:`obs_lanes` and sums."""
    if ls.grid_obj.device.type != "cuda":
        obj, color, obj_state, vis = obs_lanes(params, ls)
        seen = (obj.to(torch.int64) + color + obj_state) * vis
        out.index_add_(0, t, seen.sum().view(1))
        return
    v, h, w = params.agent_view_size, params.height, params.width
    if v > MAX_VIEW:
        raise ValueError(f"agent_view_size {v} exceeds the visibility sweep's {MAX_VIEW}")
    b = ls.agent_x.shape[0]
    dev = ls.grid_obj.device
    args = _lane_spec(ls, ("grid_obj", "grid_color", "grid_state", "agent_x", "agent_y",
                           "agent_dir", "carrying_obj", "carrying_color"), h * w)
    args.update(out=(out, torch.int64, (out.numel(),)), t=(t, torch.int64, (1,)))
    _kernels.check("obs_checksum_lanes", dev, args)
    _kernels.launch(dev, _obs_launch(), *(x.data_ptr() for x, _, _ in args.values()), b, h, w, v,
                    int(params.see_through_walls))
    profiling.count("obs.launches")
    profiling.count(f"obs.launches.{obs_instance(v)}")


def obs_instance(v: int) -> str:
    """The instance of ``csrc/obs.cu`` that a view of ``v`` columns takes:
    ``v7``, the view's width a template parameter, else ``vrt``, given at
    run time."""
    return "v7" if v == 7 else "vrt"


@functools.cache
def _obs_launch():
    """``csrc/obs.cu``'s entry point, built and loaded at its first call:
    the capture's warm-up step, before any graph or span of the step."""
    return _kernels.entry("obs", "obs_checksum_launch",
                          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


_I32_FIELDS = frozenset({
    "marks", "vmarks", "agent_x", "agent_y", "agent_dir", "carrying_marks", "step_count", "aux",
    "mission",
})
# csrc/step.cu's StepArgs.flags.
_STEP_FLAGS = {"no_boxes": 1, "no_marks": 2, "fixed_mission": 4, "fixed_aux": 8}
_BATCH_FIRST = 16


class _Fields(ctypes.Structure):
    """``csrc/step.cu``'s ``LaneFields``: a pointer a field, in ``_FIELDS``'
    order."""

    _fields_ = [(name, ctypes.c_void_p) for name in _FIELDS]


class _StepArgs(ctypes.Structure):
    """``csrc/step.cu``'s ``StepArgs``, field for field."""

    _fields_ = [
        ("cur", _Fields), ("fresh", _Fields),
        *((name, ctypes.c_void_p) for name in (
            "actions", "t", "reset_count", "reward", "dones", "wins", "ends")),
        ("action_row", ctypes.c_int64),
        *((name, ctypes.c_int32) for name in (
            "action_bytes", "B", "H", "W", "max_steps", "rounds", "n_aux", "n_mission", "flags")),
    ]


def _field_dtype(name: str) -> torch.dtype:
    if name in _I32_FIELDS:
        return torch.int32
    return torch.bool if name in ("terminated", "truncated") else _U8


def _lane_spec(ls: LaneState, names, hw: int) -> dict:
    """``_kernels.check``'s entries for the fields ``names`` of ``ls``: each
    field's dtype and lane-major shape, (HW, B) for a plane, (AUX, B) and
    (MS, B) for aux and mission, (B,) for the rest."""
    b = ls.agent_x.shape[0]
    rows = {"aux": ls.aux.shape[0], "mission": ls.mission.shape[0], **dict.fromkeys(_PLANES, hw)}
    return {name: (getattr(ls, name), _field_dtype(name),
                   (rows[name], b) if name in rows else (b,)) for name in names}


def step_path(env: Environment, device: torch.device) -> str:
    """The step that ``_Scan`` takes, from the env record and the device
    alone: ``"kernel"`` (``csrc/step.cu``, :func:`step_lanes_kernel`) on a
    CUDA device for a family with no hook and a fixed step limit, else
    ``"plain"`` (:class:`AutoresetStep`)."""
    hooks = (env.action_map, env.pre_step_lanes, env.post_step_lanes)
    fixed_limit = env.params.opt("dynamic_max_steps_slot") is None
    if device.type == "cuda" and all(h is None for h in hooks) and fixed_limit:
        return "kernel"
    return "plain"


def step_lanes_kernel(
    params: EnvParams,
    ls: LaneState,
    reset_count: torch.Tensor,
    fresh,
    rounds: int,
    actions: torch.Tensor,
    t: torch.Tensor,
    reward: torch.Tensor,
    dones: torch.Tensor,
    wins: torch.Tensor,
    ends: torch.Tensor,
    autoreset: str,
) -> None:
    """One step of the lanes ``ls``, in place, as one launch of
    ``csrc/step.cu`` on the current stream: :func:`step_lanes`' transition
    and truncation, then, in each lane that is done, ``reset_count``
    incremented and the lane's fresh layout over every field but the
    family's fixed ones (``_skip_fields``), as :class:`AutoresetStep`
    gives it.

    ``fresh`` is a lane-major pool of ``rounds`` rounds, (R, ..., B) ("pool"
    and "cached": round ``reset_count % rounds``), or a batch-first
    :class:`EnvState` of B layouts ("regen").  ``actions`` is (T, B), read at
    row ``t``, or one step's (B,), int32 or int64; ``t`` a one-element int64
    index on the device.  The per-lane reward is written to ``reward`` (B,)
    float32; the lanes done, terminated, and terminated with a positive
    reward are added into ``dones[t]``, ``ends[t]`` and ``wins[t]`` (int64).

    It checks every tensor it passes (device, dtype, shape, contiguity) and
    raises on any other input, and on a step limit set per episode; there is
    no fallback.  Counters ``lanes.step_kernel.launches`` and
    ``lanes.step_kernel.launches.<autoreset>``."""
    if params.opt("dynamic_max_steps_slot") is not None:
        raise ValueError("step_lanes_kernel: a step limit set per episode is not in the kernel")
    batch_first = isinstance(fresh, EnvState)
    if batch_first != (autoreset == "regen"):
        raise ValueError("step_lanes_kernel: 'regen' takes a batch-first EnvState, the other "
                         f"modes a lane-major pool; got {type(fresh).__name__} in {autoreset!r}")
    h, w, b = params.height, params.width, ls.agent_x.shape[0]
    n_aux, n_mission = ls.aux.shape[0], ls.mission.shape[0]
    dev = ls.grid_obj.device
    if dev.type != "cuda":
        raise ValueError(f"step_lanes_kernel: the lanes are on {dev}, not a CUDA device")
    lanes = _lane_spec(ls, _FIELDS, h * w)
    args = {f"ls.{n}": spec for n, spec in lanes.items()}
    if batch_first:
        for f in dataclasses.fields(EnvState):
            shape = {"agent_pos": (b, 2), "aux": (b, n_aux), "mission": (b, n_mission)}.get(
                f.name, (b, h, w) if f.name in _PLANES else (b,))
            dtype = torch.int32 if f.name == "agent_pos" else _field_dtype(f.name)
            args[f"fresh.{f.name}"] = (getattr(fresh, f.name), dtype, shape)
    else:
        args.update({f"fresh.{n}": (getattr(fresh, n), dtype, (rounds, *shape))
                     for n, (_, dtype, shape) in lanes.items()})
    if actions.dtype not in (torch.int32, torch.int64) or rounds < 1:
        raise ValueError(f"step_lanes_kernel: {actions.dtype} actions, {rounds} rounds")
    horizon = dones.numel()
    args.update(
        actions=(actions, actions.dtype, (b,) if actions.dim() < 2 else (actions.shape[0], b)),
        t=(t, torch.int64, (1,)), reset_count=(reset_count, torch.int32, (b,)),
        reward=(reward, torch.float32, (b,)), dones=(dones, torch.int64, (horizon,)),
        wins=(wins, torch.int64, (horizon,)), ends=(ends, torch.int64, (horizon,)),
    )
    _kernels.check("step_lanes_kernel", dev, args)

    st = _StepArgs()
    for name in _FIELDS:
        setattr(st.cur, name, getattr(ls, name).data_ptr())
        pos = batch_first and name in ("agent_x", "agent_y")  # agent_pos (B, 2): x, then y
        src = fresh.agent_pos if pos else getattr(fresh, name)
        setattr(st.fresh, name, src.data_ptr() + 4 * (pos and name == "agent_y"))
    for name, x in (("actions", actions), ("t", t), ("reset_count", reset_count),
                    ("reward", reward), ("dones", dones), ("wins", wins), ("ends", ends)):
        setattr(st, name, x.data_ptr())
    st.action_row = b if actions.dim() == 2 else 0
    st.action_bytes = actions.element_size()
    st.B, st.H, st.W, st.max_steps, st.rounds = b, h, w, params.max_steps, rounds
    st.n_aux, st.n_mission = n_aux, n_mission
    st.flags = sum(bit for k, bit in _STEP_FLAGS.items() if params.opt(k, False)) + (
        _BATCH_FIRST if batch_first else 0)
    _kernels.launch(dev, _step_launch(), ctypes.byref(st))
    profiling.count("lanes.step_kernel.launches")
    profiling.count(f"lanes.step_kernel.launches.{autoreset}")


@functools.cache
def _step_launch():
    """``csrc/step.cu``'s entry point, built and loaded at its first call;
    raises if its ``StepArgs`` is not the size of :class:`_StepArgs`."""
    lib = _kernels.library("step")
    if lib.step_args_bytes() != ctypes.sizeof(_StepArgs):
        raise RuntimeError(
            f"csrc/step.cu's StepArgs is {lib.step_args_bytes()} bytes, its mirror "
            f"{ctypes.sizeof(_StepArgs)}"
        )
    return _kernels.entry("step", "step_lanes_launch", [ctypes.c_void_p, ctypes.c_void_p])


def obs_image_lanes(params: EnvParams, ls: LaneState) -> torch.Tensor:
    """(B, view, view, 3) uint8 batch in the reference's ``[x, y]`` layout."""
    v = params.agent_view_size
    obj, color, obj_state, vis = obs_lanes(params, ls)
    img = torch.stack([obj, color, obj_state], dim=1)  # (VV, 3, B)
    img = torch.where(vis[:, None, :], img, 0).to(_U8)
    img = img.reshape(v, v, 3, -1)  # [vy, vx, 3, B]
    return img.permute(3, 1, 0, 2).contiguous()  # [B, vx, vy, 3]


def supports_lanes(env: Environment) -> bool:
    """True when the lane engine covers the env's semantics: the core MDP
    plus hooks in the lane-major slots.  The port's record has no other
    slots, so this holds for every record whose hooks are callables."""
    hooks = (env.action_map, env.pre_step_lanes, env.post_step_lanes)
    return all(h is None or callable(h) for h in hooks)


def step_lanes_env(
    env: Environment,
    ls: LaneState,
    action: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tuple[LaneState, torch.Tensor, torch.Tensor]:
    """:func:`step_lanes` with the env's per-family hooks, in the JAX
    order: ``action_map``; ``prev`` taken after the map and before
    ``pre_step_lanes``; the core step; ``post_step_lanes``, whose
    termination goes onto the state.  The hooks get ``generator`` where
    they draw (``env.hooks_draw``), and None elsewhere; a family whose
    hooks draw raises without one.  Returns ``(new_state, reward,
    terminated)``; ``truncated`` lives on the state."""
    params = env.params
    if env.hooks_draw and generator is None:
        raise ValueError(f"{env.env_id}: its hooks draw; pass a generator")
    generator = generator if env.hooks_draw else None
    if env.action_map is not None:
        action = env.action_map(params, action)
    prev = ls
    if env.pre_step_lanes is not None:
        ls = env.pre_step_lanes(params, generator, ls, action)
    ls, reward, term = step_lanes(params, ls, action)
    if env.post_step_lanes is not None:
        ls, reward, term = env.post_step_lanes(
            params, generator, prev, ls, action, reward, term
        )
        ls = ls.replace(terminated=term)
    return ls, reward, term


class LaneRolloutResult(NamedTuple):
    final_state: LaneState
    total_reward: torch.Tensor  # () f32
    episodes: torch.Tensor  # () i64
    steps: int
    obs_checksum: torch.Tensor  # () i64 in [0, 2**32): JAX's wrapping u32 sum
    resets_per_env: torch.Tensor  # (B,) i32
    successes: torch.Tensor  # () i64: terminations that paid a positive reward
    failures: torch.Tensor  # () i64: the other terminations


def select_lanes(
    done: torch.Tensor, fresh: LaneState, cur: LaneState, skip: tuple = ()
) -> LaneState:
    """Per-lane ``where(done, fresh, cur)``; fields in ``skip`` keep the
    current value (planes that are constant for the env family), as do
    fields that are one tensor in both."""
    out = {}
    for name in _FIELDS:
        a, b = getattr(fresh, name), getattr(cur, name)
        out[name] = b if name in skip or a is b else torch.where(done, a, b)
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
    """The fields a family keeps fixed (registry flags), which a reset
    leaves alone."""
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


AUTORESETS = ("pool", "cached", "regen")


def autoreset_rounds(autoreset: str, pool_rounds: int) -> int:
    """The layout batches :func:`lane_pool` generates in the mode
    ``autoreset`` (one of ``AUTORESETS``): ``pool_rounds`` for "pool", else
    the initial batch only.  Raises on another mode."""
    if autoreset not in AUTORESETS:
        raise ValueError(f"unknown autoreset mode {autoreset!r}")
    return pool_rounds if autoreset == "pool" else 1


class AutoresetStep:
    """The plain step with JAX's autoreset, which ``lane_rollout``'s plain
    step and PPO's collector both take, in three calls in this order, so
    that each caller puts its own spans around them (none is opened here):

    1. :meth:`transition`: ``step_lanes_env``, looked up when it is called,
       its hooks drawing from ``generator`` where they draw; ``done =
       terminated | truncated``; the reset counts plus ``done``;
    2. :meth:`generate`: in "regen", a fresh batch of layouts
       (``env.generate``), drawn after the hooks; None in the other modes;
    3. :meth:`reset`: each done lane's next layout over every field but
       the family's fixed ones (:meth:`select`), written with the reset
       counts into the carried tensors in place.

    ``pool`` is :func:`lane_pool`'s (R, ..., B) for "pool" and "cached";
    "regen" reads none.  On a card, ``csrc/step.cu`` steps a family with
    no hook the same way (:func:`step_lanes_kernel`), but it writes no
    per-lane reward or done, which PPO records, so PPO stays on this
    step."""

    def __init__(self, env: Environment, autoreset: str, pool_rounds: int,
                 pool: Optional[LaneState], generator: Optional[torch.Generator],
                 batch_size: int, device):
        self.rounds = autoreset_rounds(autoreset, pool_rounds)
        self.env, self.autoreset, self.pool, self.generator = env, autoreset, pool, generator
        self.batch_size, self.device = batch_size, device
        self.skip = _skip_fields(env.params)

    def transition(self, ls: LaneState, reset_count: torch.Tensor, action: torch.Tensor):
        """Returns ``(ls, reward, terminated, done, reset_count)``, all new."""
        ls, reward, term = step_lanes_env(self.env, ls, action, self.generator)
        done = term | ls.truncated
        return ls, reward, term, done, reset_count + done.to(torch.int32)

    def generate(self) -> Optional[EnvState]:
        if self.autoreset != "regen":
            return None
        return self.env.generate(self.generator, self.env.params, self.batch_size, self.device)

    def select(self, ls: LaneState, done: torch.Tensor, reset_count: torch.Tensor,
               flat: Optional[EnvState]) -> LaneState:
        """``ls`` with each done lane's next layout: pool round
        ``reset_count % rounds`` ("pool"), round 0 ("cached"), or its own
        of :meth:`generate`'s ``flat`` ("regen")."""
        if self.autoreset == "pool":
            fresh = _select_pool(self.pool, reset_count % self.rounds, self.rounds, self.skip)
        elif self.autoreset == "regen":
            fresh = to_lanes(flat)
        else:
            fresh = self.pool.round(0)
        return select_lanes(done, fresh, ls, self.skip)

    def reset(self, carry: LaneState, carry_resets: torch.Tensor, ls: LaneState,
              done: torch.Tensor, reset_count: torch.Tensor, flat: Optional[EnvState]) -> None:
        """:meth:`select`, then it and ``reset_count`` copied into ``carry``
        and ``carry_resets``."""
        carry.copy_(self.select(ls, done, reset_count, flat))
        carry_resets.copy_(reset_count)


def lane_rollout(
    env: Environment,
    generator: Optional[torch.Generator],
    batch_size: int,
    horizon: int = 256,
    autoreset: str = "pool",
    pool_rounds: int = 4,
    actions: Optional[torch.Tensor] = None,
    device="cuda",
    group: Optional[EnvGroup] = None,
) -> LaneRolloutResult:
    """Rollout on the lane-major path, uniform random actions unless given.

    Auto-reset modes:

    * ``"pool"`` — pregenerate ``pool_rounds`` layout batches; the k-th
      reset of a slot draws round ``k % pool_rounds``;
    * ``"cached"`` — each slot replays its initial layout;
    * ``"regen"`` — every step generates a fresh batch of layouts
      (``env.generate``, after the actions' and the hooks' draws) and each
      finished slot takes its own: JAX's default ``rollout`` mode, which
      computes both branches of the select every step.

    The layouts and the actions come from ``generator`` (a
    ``torch.Generator`` on ``device``); ``actions``, if given, is a
    ``(horizon, batch_size)`` integer tensor used instead of the draws.
    The observation encoder runs every step and is folded into
    ``obs_checksum``, so the steps/s include observations.  On a CUDA
    device the step runs as one captured CUDA graph (``_lane_scan``); a
    family with no hook steps there through ``csrc/step.cu``
    (:func:`step_path`), a rank of a group on its own lanes.

    With a ``group`` (``parallel/sharding.py``) each rank runs its
    ``batch_size / N`` lanes on ``group.device`` (``device`` is not read),
    its layouts and actions drawn from its own ``generator`` (or its slice
    of ``actions``); the step needs no communication, and the result's
    scalars are summed over the ranks (``_lane_scan``).

    Spans (``utils/profiling.py``): the call is ``lanes.rollout``, holding
    ``lanes.pool`` (its ``generator.generate``) and ``_lane_scan``'s."""
    if group is not None:
        mine = group.slice(batch_size)  # raises unless the batch divides
        dev, lanes = group.device, mine.stop - mine.start
        if actions is not None:
            actions = shard_batch(actions, group, axis=1)
    else:
        dev, lanes = resolve_device(device), batch_size
    if dev.type == "cuda" and profiling.is_tracing():
        profiling.load_stamps(dev)
    with profiling.span("lanes.rollout"):
        with profiling.span("lanes.pool"):
            pool = lane_pool(env, generator, lanes, autoreset, pool_rounds, dev)
        return _lane_scan(
            env, generator, pool, lanes, horizon, autoreset, pool_rounds, actions, group
        )


def shard_lanes(ls: LaneState, group: EnvGroup) -> LaneState:
    """This rank's slice of a lane-major state or pool: every field's envs
    are its last axis (JAX's ``lane_sharding``/``shard_lanes``)."""
    return shard_batch(ls, group, axis=-1)


def lane_pool(
    env: Environment,
    generator: torch.Generator,
    batch_size: int,
    autoreset: str,
    pool_rounds: int,
    device,
) -> LaneState:
    """:func:`autoreset_rounds` generated layout batches, lane-major,
    stacked on a leading rounds axis: the pool of ``lane_rollout`` and of
    PPO's collector."""
    if not supports_lanes(env):
        raise ValueError(f"{env.env_id}: the lane engine does not cover its hooks")
    rounds = autoreset_rounds(autoreset, pool_rounds)
    with profiling.span("generator.generate"):
        flat = env.generate(generator, env.params, rounds * batch_size, device)
    return stack_rounds(flat, batch_size, rounds)


def stack_rounds(flat: EnvState, batch_size: int, rounds: int) -> LaneState:
    """``rounds * batch_size`` batch-first layouts as a lane-major pool
    (rounds, ..., batch_size), round r the layouts r*B to (r+1)*B - 1."""
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


class _Carry(NamedTuple):
    """The tensors that one step of the scan reads and writes, each at a
    fixed address: the state and reset counts it carries, the step index
    ``t`` on the device, and the per-step outputs that it writes at ``t``."""

    ls: LaneState
    reset_count: torch.Tensor  # (B,) i32
    t: torch.Tensor  # () i64
    rewards: torch.Tensor  # (T,) f32
    dones: torch.Tensor  # (T,) i64, zeroed: the kernel step adds into slot t
    wins: torch.Tensor  # (T,) i64, zeroed
    ends: torch.Tensor  # (T,) i64, zeroed
    checksums: torch.Tensor  # (T,) i64, zeroed: the step adds into slot t

    def clone(self) -> "_Carry":
        return _Carry(self.ls.clone(), *(x.clone() for x in self[1:]))


def capture_step(step, warmup, device, generator: Optional[torch.Generator] = None,
                 stamps: Optional[profiling.GraphStamps] = None):
    """``step()`` captured as a CUDA graph in a memory pool of its own;
    each replay of the graph runs it once.  ``warmup()`` runs first, on a
    side stream, so that what a first call sets up lazily is not set up
    inside the capture; it must leave every tensor that ``step`` reads as
    it found it.  ``generator``, where ``step`` draws from it, is put back
    after the warm-up and registered with the graph, so the replays draw
    what as many eager calls would.  With ``stamps``, the ``graph_span``s
    of ``step`` stamp into it while tracing is on, and ``stamps.graph_nodes``
    is set to the graph's nodes less the stamps.  A failed capture raises.
    Returns ``(graph, capture_ms, pool_bytes)``: the capture's host time
    and the bytes its memory pool holds."""
    saved = None if generator is None else generator.get_state()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warmup()
    torch.cuda.current_stream(device).wait_stream(side)
    if generator is not None:
        generator.set_state(saved)

    graph = torch.cuda.CUDAGraph(keep_graph=stamps is not None)
    if generator is not None:
        graph.register_generator_state(generator)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    capturing = contextlib.nullcontext() if stamps is None else stamps.capturing()
    with torch.cuda.graph(graph), capturing:
        step()
    if stamps is not None:
        graph.instantiate()
    capture_ms = 1e3 * (time.perf_counter() - t0)
    if stamps is not None:
        stamps.graph_nodes = profiling.graph_nodes(graph) - stamps.kernels
    return graph, capture_ms, torch.cuda.memory_reserved(device) - reserved


def capture_in_span(name: str, device, capture):
    """``capture(stamps)``, which returns ``(graph, pool_bytes)``, inside the
    span ``name``.  While tracing is on, ``stamps`` is a new
    ``GraphStamps`` that the graph's ``graph_span``s stamp into, and the
    span carries the pool's bytes, the graph's nodes less the stamps
    (``graph_nodes``) and the stamps (``stamp_nodes``); while it is off,
    ``stamps`` is None.  Returns ``(graph, stamps)``: the caller replays the
    graph, then calls ``stamps.emit()`` where it is not None."""
    with profiling.span(name) as rec:
        stamps = None if rec is None else profiling.GraphStamps(device)
        graph, pool_bytes = capture(stamps)
        if rec is not None:
            rec.attrs.update(pool_bytes=pool_bytes, graph_nodes=stamps.graph_nodes,
                             stamp_nodes=stamps.kernels)
    return graph, stamps


class _Scan:
    """One rollout's scan: ``_lane_scan``'s set-up, and its step, which
    reads the pool, the given actions and the generator, and writes
    nothing but a carry's tensors (and, on the kernel path, its reward
    buffer).  Its one host-side choice is the step's own shape (the path,
    the mode, the skipped fields, the hooks), so the step can be captured
    once and replayed.  ``path`` is :func:`step_path`'s: ``step`` runs
    ``step_kernel`` or ``step_plain``, two steps that share no logic and
    give the same carry bit for bit."""

    def __init__(
        self,
        env: Environment,
        generator: Optional[torch.Generator],
        pool: LaneState,
        batch_size: int,
        horizon: int,
        autoreset: str,
        pool_rounds: int,
        actions: Optional[torch.Tensor],
    ):
        self.device = dev = pool.grid_obj.device
        if autoreset == "regen" and generator is None:
            raise ValueError('"regen" generates from the generator; pass one')
        if actions is None:
            if generator is None:
                raise ValueError("pass a generator or an actions tensor")
        elif tuple(actions.shape) != (horizon, batch_size):
            raise ValueError(
                f"actions must be ({horizon}, {batch_size}), got {tuple(actions.shape)}"
            )
        self.path = step_path(env, dev)
        if self.path == "kernel":
            # The kernel reads the pool and the actions where they lie, and a
            # rank's slice of a group's lanes (``shard_lanes``) is strided.
            pool = pool.map(torch.Tensor.contiguous)
            actions = None if actions is None else actions.contiguous()
        self.env, self.generator, self.pool = env, generator, pool
        self.batch_size, self.horizon, self.autoreset = batch_size, horizon, autoreset
        self.plain = AutoresetStep(env, autoreset, pool_rounds, pool, generator, batch_size, dev)
        self.rounds = self.plain.rounds
        self.actions = None if actions is None else actions.to(dev)
        # The kernel step's per-lane reward, summed into the carry's slot.
        self.reward = (torch.empty(batch_size, dtype=torch.float32, device=dev)
                       if self.path == "kernel" else None)

        def empty(dtype):
            return torch.empty(horizon, dtype=dtype, device=dev)

        def zeros():
            return torch.zeros(horizon, dtype=torch.int64, device=dev)

        # The carried state is a copy: the step writes into it, and in
        # "cached" mode it reads the pool's round 0 as its fresh layouts
        # ("regen" generates them every step).  The step adds its
        # observation checksum (and, on the kernel path, its counts) into
        # its slot, so those slots start at 0.
        self.carry = _Carry(
            ls=pool.round(0).clone(),
            reset_count=torch.zeros(batch_size, dtype=torch.int32, device=dev),
            t=torch.zeros((), dtype=torch.int64, device=dev),
            rewards=empty(torch.float32),
            dones=zeros(),
            wins=zeros(),
            ends=zeros(),
            checksums=zeros(),
        )

    def step(self, c: _Carry) -> None:
        """One step of JAX's scan body on the carry ``c``, by ``path``."""
        if self.path == "kernel":
            self.step_kernel(c)
        else:
            self.step_plain(c)

    def step_kernel(self, c: _Carry) -> None:
        """The step as ``csrc/step.cu`` takes it (:func:`step_lanes_kernel`),
        on a CUDA device, for a family with no hook: the action draw (unless
        actions are given, which the kernel reads at ``t``); "regen"'s
        ``generate``; the kernel, which steps, resets and counts in place;
        the observation kernel; the reward's sum.  The generator's draws come
        in the plain step's order.  Its parts are ``graph_span``s:
        ``lanes.step`` holds ``generator.generate`` ("regen"),
        ``lanes.transition`` (the kernel) and ``lanes.observation`` (the
        checksum and the reward's sum); the draw is ``lanes.step``'s own
        time."""
        env = self.env
        t = c.t.view(1)
        with profiling.graph_span("lanes.step"):
            act = self.actions
            if act is None:
                act = torch.randint(
                    0, env.action_dim, (self.batch_size,), generator=self.generator,
                    device=self.device, dtype=torch.int32,
                )
            fresh = self.pool
            if self.autoreset == "regen":
                with profiling.graph_span("generator.generate"):
                    fresh = env.generate(self.generator, env.params, self.batch_size, self.device)
            with profiling.graph_span("lanes.transition"):
                step_lanes_kernel(env.params, c.ls, c.reset_count, fresh, self.rounds, act, t,
                                  self.reward, c.dones, c.wins, c.ends, self.autoreset)
            with profiling.graph_span("lanes.observation"):
                obs_checksum_lanes(env.params, c.ls, c.checksums, t)
                c.rewards.index_copy_(0, t, self.reward.sum().view(1))
            c.t.add_(1)

    def step_plain(self, c: _Carry) -> None:
        """The step in plain code (:class:`AutoresetStep`), on any device
        and for every family, in JAX's order.  Its parts are
        ``graph_span``s: ``lanes.step`` holds ``lanes.transition`` (with
        the action draw), ``generator.generate`` ("regen"),
        ``lanes.select`` (with the write-back) and ``lanes.observation``.
        Counts ``lanes.plain_steps``."""
        profiling.count("lanes.plain_steps")
        env, plain = self.env, self.plain
        t = c.t.view(1)
        with profiling.graph_span("lanes.step"):
            with profiling.graph_span("lanes.transition"):
                if self.actions is None:
                    act = torch.randint(
                        0, env.action_dim, (self.batch_size,), generator=self.generator,
                        device=self.device, dtype=torch.int32,
                    )
                else:
                    act = self.actions.index_select(0, t)[0]
                ls, reward, term, done, reset_count = plain.transition(c.ls, c.reset_count, act)
            flat = None
            if self.autoreset == "regen":
                with profiling.graph_span("generator.generate"):
                    flat = plain.generate()
            with profiling.graph_span("lanes.select"):
                plain.reset(c.ls, c.reset_count, ls, done, reset_count, flat)
            with profiling.graph_span("lanes.observation"):
                obs_checksum_lanes(env.params, c.ls, c.checksums, t)
                c.rewards.index_copy_(0, t, reward.sum().view(1))
                c.dones.index_copy_(0, t, done.sum().view(1))
                c.wins.index_copy_(0, t, (term & (reward > 0)).sum().view(1))
                c.ends.index_copy_(0, t, term.sum().view(1))
            c.t.add_(1)

    def run_eager(self) -> None:
        with profiling.span("lanes.replay"):
            for _ in range(self.horizon):
                self.step(self.carry)

    def capture(self, stamps: Optional[profiling.GraphStamps] = None):
        """``step`` on the carry, captured as a CUDA graph (``capture_step``,
        into ``stamps`` where given); each replay is one step.  The warm-up
        steps a copy of the carry.  Counts ``lanes.captures`` and adds to
        ``lanes.capture_ms`` and ``lanes.pool_bytes``.  Returns ``(graph,
        pool_bytes)``."""
        draws = self.actions is None or self.env.hooks_draw or self.autoreset == "regen"
        graph, capture_ms, pool_bytes = capture_step(
            lambda: self.step(self.carry),
            lambda: self.step(self.carry.clone()),
            self.device,
            self.generator if draws else None,
            stamps,
        )
        profiling.count("lanes.captures")
        profiling.count("lanes.capture_ms", capture_ms)
        profiling.count("lanes.pool_bytes", pool_bytes)
        return graph, pool_bytes

    def run_graph(self) -> None:
        """The step captured once (``lanes.capture``) and replayed
        ``horizon`` times (``lanes.replay``); the graph and its pool are
        freed before the call returns.  While tracing is on the capture
        holds the step's stamps, and ``lanes.capture`` carries the
        attributes of ``capture_in_span``.  A horizon of 0 captures nothing
        (its outputs have no slot to write)."""
        if not self.horizon:
            return
        graph, stamps = capture_in_span("lanes.capture", self.device, self.capture)
        try:
            with profiling.span("lanes.replay"):
                for _ in range(self.horizon):
                    graph.replay()
                if stamps is not None:
                    stamps.emit()
        finally:
            graph.reset()

    def result(self, group: Optional[EnvGroup]) -> LaneRolloutResult:
        """The horizon's sums, over the group's ranks where there is one."""
        c = self.carry
        total_reward = all_reduce(c.rewards.sum(), group)
        counts = all_reduce(
            torch.stack([c.dones.sum(), c.wins.sum(), c.ends.sum(), c.checksums.sum()]), group
        )
        episodes, successes, terminations, checksum = counts.unbind()
        return LaneRolloutResult(
            final_state=c.ls,
            total_reward=total_reward,
            episodes=episodes,
            steps=self.batch_size * self.horizon * (group.world_size if group is not None else 1),
            obs_checksum=checksum % (1 << 32),
            resets_per_env=c.reset_count,
            successes=successes,
            failures=terminations - successes,
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
    group: Optional[EnvGroup] = None,
) -> LaneRolloutResult:
    """Step ``horizon`` times from round 0 of ``pool`` with autoreset.
    The hooks draw from ``generator`` after each step's actions, and only
    where ``env.hooks_draw``; "regen" generates from it after the hooks.

    On a CUDA device the step is captured once as a CUDA graph and
    replayed ``horizon`` times, as JAX compiles its scan into one program;
    elsewhere it runs in a Python loop (``_lane_scan_eager``).  Both give
    the same result bit for bit, and leave ``generator`` at the same
    state.  The counters ``lanes.captures``, ``lanes.capture_ms`` and
    ``lanes.pool_bytes`` (``utils/profiling.py``) sum the captures, their
    host time and their memory pools' bytes.  The closing sums are
    ``lanes.result``.  ``lanes.step_kernel.launches`` (and ``.<autoreset>``)
    count the kernel step's host launches, two a graphed call (the
    capture's warm-up and the capture); ``lanes.plain_steps`` the plain
    step's host calls.

    With a ``group``, ``pool`` and ``actions`` are this rank's
    ``batch_size`` lanes; ``total_reward``, ``episodes``, ``successes``,
    ``failures`` and the checksum (its int64 sum, before the modulus) are
    summed over the ranks, and ``steps`` counts every rank's.
    ``final_state`` and ``resets_per_env`` stay the rank's own."""
    scan = _Scan(env, generator, pool, batch_size, horizon, autoreset, pool_rounds, actions)
    if scan.device.type == "cuda":
        scan.run_graph()
    else:
        scan.run_eager()
    with profiling.span("lanes.result"):
        return scan.result(group)


def _lane_scan_eager(
    env: Environment,
    generator: Optional[torch.Generator],
    pool: LaneState,
    batch_size: int,
    horizon: int,
    autoreset: str,
    pool_rounds: int,
    actions: Optional[torch.Tensor] = None,
    group: Optional[EnvGroup] = None,
) -> LaneRolloutResult:
    """:func:`_lane_scan` with its step run in a Python loop on any
    device: the plain version that the graphed scan is held to on the
    card."""
    scan = _Scan(env, generator, pool, batch_size, horizon, autoreset, pool_rounds, actions)
    scan.run_eager()
    return scan.result(group)
