"""RoomGridLevel: the pooled level generator and its validation.

Counterpart of ``minigrid_dynamicprogramming_tpu/envs/babyai/level.py``.
The reference regenerates a whole level until it is valid
(roomgrid_level.py:118-139).  Each level's ``gen_mission`` here is a
batched function that returns an ``ok`` flag per attempt instead of
raising ``RejectSampling``, and ``generate`` is JAX's pooled
``generate_batch``: it draws ``ceil(margin * n)`` attempts at once (margin
``gen_oversample`` or 1.5), keeps the accepted ones in draw order (a
stable sort), takes the first n (``idx % accepted`` in the rare shortfall,
as JAX does) and resolves the instruction into mark planes on those n
only.  The kept layouts are iid draws of the acceptance-conditioned law
the reference's loop gives.  ``generate_stats`` reports, for each layout,
whether it came from an accepted attempt and the attempts spent on it
(``utils/telemetry.py:pooled_stats``).

``gen_mission`` has the signature::

    gen_mission(generator, params, state, ctx) -> (state, codes, ok)

over a batch-first state and ``ops/roomgrid.py``'s room context; ``codes``
is (B, 48) int32 and ``ok`` (B,) bool.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import (
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    new_state,
    resolve_device,
)
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu_torch.ops import roomgrid as rg
from minigrid_dynamicprogramming_tpu_torch.utils import profiling
from minigrid_dynamicprogramming_tpu_torch.utils.telemetry import pooled_stats

GenMissionFn = Callable

def _adjacent(m: torch.Tensor) -> torch.Tensor:
    """(B, H, W): the cells 4-adjacent to a cell of ``m``, edges dropped."""
    out = torch.zeros_like(m)
    out[:, :-1] |= m[:, 1:]
    out[:, 1:] |= m[:, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    out[:, :, 1:] |= m[:, :, :-1]
    return out


def objs_reachable(state: EnvState) -> torch.Tensor:
    """(B,) bool: ``check_objs_reachable`` (roomgrid_level.py:249-301), a
    flood from the agent through empty and door cells that must visit
    every object cell (anything but empty and wall).

    The flood runs JAX's bound of (H*W)//2 + 2 sweeps, with no check for
    its fixed point (a check would read a value back to the host); sweeps
    past the fixed point change nothing."""
    obj = state.grid_obj
    b, h, w = obj.shape
    passable = (obj == OBJ_EMPTY) | (obj == OBJ_DOOR)
    ys = torch.arange(h, device=obj.device)[:, None]
    xs = torch.arange(w, device=obj.device)[None, :]
    reach = (xs == state.agent_pos[:, 0, None, None]) & (ys == state.agent_pos[:, 1, None, None])
    for _ in range((h * w) // 2 + 2):
        reach = reach | _adjacent(reach & passable)
    is_obj = (obj != OBJ_EMPTY) & (obj != OBJ_WALL)
    return (~is_obj | reach).reshape(b, -1).all(dim=1)


def batch_of(state: EnvState):
    """(B, device) of a batch-first state."""
    return state.grid_obj.shape[0], state.grid_obj.device


def accept_all(state: EnvState) -> torch.Tensor:
    """(B,) True: the ``ok`` of a level that rejects no attempt itself."""
    b, dev = batch_of(state)
    return torch.ones(b, dtype=torch.bool, device=dev)


def pick(values: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``values[b, n[b]]`` of a (B, k) tensor."""
    return values.gather(1, n.long()[:, None])[:, 0]


def open_all_doors(state: EnvState) -> EnvState:
    """roomgrid_level.py:237-247."""
    is_door = state.grid_obj == OBJ_DOOR
    return state.replace(grid_state=torch.where(is_door, 0, state.grid_state).to(torch.uint8))


def select_state(cond: torch.Tensor, a, b):
    """Per-env ``where(cond, a, b)`` over two batch-first records of one
    type (states or room contexts)."""
    out = {}
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        out[name] = torch.where(c, x, y)
    return type(a)(**out)


def take(state: EnvState, idx: torch.Tensor) -> EnvState:
    """The envs ``idx`` of a batch-first state."""
    return EnvState(**{n: getattr(state, n).index_select(0, idx) for n in state.__dataclass_fields__})


def validate(p: EnvParams, state: EnvState, codes: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``ok`` and the descriptor checks: every active descriptor matches an
    object (the reference asserts it in ObjDesc.surface, verifier.py:78),
    and no PutNext starts satisfied or with the moved object among the
    fixed ones (roomgrid_level.py:159-176).  Only the profile's slots are
    checked."""
    profile = p.opt("instr_profile") or B.GENERIC_PROFILE
    rows = codes.T
    for c in range(2):
        for l in range(2):
            kinds = profile[1 + c * 2 + l]
            if not kinds:
                continue
            m = {}
            for d in range(2 if "putnext" in kinds else 1):
                m[d] = B.desc_match_mask(p, state, *B.desc_fields(rows, c, l, d))
                ok = ok & (m[d].flatten(1).any(dim=1) | ~B.desc_active(rows, c, l, d))
            if "putnext" not in kinds:
                continue
            is_put = B.leaf_kind(rows, c, l) == B.KIND_PUTNEXT
            move, fixed = m[0], m[1]
            bad = (move & (_adjacent(fixed) | fixed)).flatten(1).any(dim=1)
            ok = ok & (~is_put | ~bad)
    return ok


def make_level(
    env_id: str,
    gen_mission: GenMissionFn,
    room_size: int = 8,
    num_rows: int = 3,
    num_cols: int = 3,
    max_steps: Optional[int] = None,
    agent_view_size: int = 7,
    instr_profile=None,
    after_init: Optional[Callable] = None,
    init_rooms: bool = True,
) -> Environment:
    """The :class:`Environment` of one BabyAI level.

    ``instr_profile`` is the level's static instruction shape
    (``core.GENERIC_PROFILE``); the verifier and the validation branch on
    it.  ``after_init(state)``, if given, edits the n kept layouts after
    their instruction is resolved (PutNext's start_carrying).  With
    ``init_rooms`` False, ``gen_mission`` lays out the rooms itself
    (``rg.init``, its first draw), and is given ``None`` for the room
    context.

    ``generate`` is the span ``babyai.generate`` (attributes ``attempts``
    and ``layouts``) around the attempts and the kept layouts, holding
    ``babyai.generate.accept`` (the validation, the stable sort, ``take``,
    ``init_instr`` and ``after_init``); the counter
    ``babyai.generate.attempts`` adds the attempts of each call."""
    params = EnvParams(
        width=(room_size - 1) * num_cols + 1,
        height=(room_size - 1) * num_rows + 1,
        # Used only when fixed; the live per-episode limit sits in
        # aux[AUX_MAX_STEPS] (roomgrid_level.py:76-83).
        max_steps=max_steps if max_steps is not None else 8 * room_size**2,
        see_through_walls=False,
        agent_view_size=agent_view_size,
    ).with_extra(
        room_size=room_size,
        num_rows=num_rows,
        num_cols=num_cols,
        fixed_max_steps=max_steps is not None,
        dynamic_max_steps_slot=B.AUX_MAX_STEPS,
        # The BABYAI_DONE_ACTIONS flag (verifier.py:25), read when the id
        # is made.
        done_actions=bool(os.environ.get("BABYAI_DONE_ACTIONS", False)),
        instr_profile=instr_profile,
    )

    def attempts_and_layouts(generator: torch.Generator, p: EnvParams, batch_size: int, device):
        """(``batch_size`` layouts, each attempt's acceptance in draw
        order)."""
        dev = resolve_device(device)
        n = batch_size
        m = max(n + 8, int(math.ceil(n * (p.opt("gen_oversample") or 1.5))))
        profiling.count("babyai.generate.attempts", m)
        with profiling.graph_span("babyai.generate", attempts=m, layouts=n):
            state, ctx = new_state(m, p.height, p.width, dev), None
            if init_rooms:
                state, ctx = rg.init(generator, state, room_size, num_rows, num_cols)
            state, codes, ok = gen_mission(generator, p, state, ctx)
            with profiling.graph_span("babyai.generate.accept"):
                ok = validate(p, state, codes, ok)
                order = torch.argsort((~ok).to(torch.int8), stable=True)  # accepted first
                accepted = ok.sum()
                idx = torch.arange(n, device=dev)
                sel = order.index_select(0, torch.where(idx < accepted, idx, idx % accepted.clamp(min=1)))
                state = B.init_instr(p, take(state, sel), codes.index_select(0, sel))
                if after_init is not None:
                    state = after_init(state)
        return state, ok

    def generate(
        generator: torch.Generator,
        p: EnvParams,
        batch_size: int,
        device="cuda",
        return_accepted: bool = False,
    ):
        """``batch_size`` layouts; with ``return_accepted`` also the number
        of accepted attempts (a (), int64 tensor), which must be at least
        ``batch_size`` for the layouts to be distinct draws."""
        state, ok = attempts_and_layouts(generator, p, batch_size, device)
        return (state, ok.sum()) if return_accepted else state

    def generate_stats(generator: torch.Generator, p: EnvParams, batch_size: int, device="cuda"):
        """``generate`` and the acceptance telemetry of its layouts."""
        state, ok = attempts_and_layouts(generator, p, batch_size, device)
        return state, pooled_stats(ok, batch_size)

    return Environment(
        env_id,
        params,
        generate,
        mission_text=B.surface_text,
        post_step_lanes=B.verify_step,
        hook_rng=False,  # the verifier draws nothing
        generate_stats=generate_stats,
    )
