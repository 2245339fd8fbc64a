"""Invariant guards and the NaN/Inf tripwire.

Counterpart of ``minigrid_dynamicprogramming_tpu/utils/guards.py``.  JAX
compiles ``checkify`` assertions into the step; here :func:`check_state`
computes every invariant of a batch on its device and brings them to the
host in one transfer, as an :class:`Error` that raises with the first
violated invariant (JAX's wording) on :meth:`Error.throw`.
:func:`debug_mode` is the counterpart of ``jax_debug_nans`` and
``jax_debug_infs``: inside it, the first operator whose floating output
holds a NaN (or an Inf) raises ``FloatingPointError`` naming the operator.

Usage::

    step = checked_step(env)
    err, (obs, state, r, term, trunc, _) = step(state, action, generator)
    err.throw()                              # raises on a violated invariant

    with debug_mode():                       # NaN/Inf tripwires for a block
        ppo.update(ts)
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from minigrid_dynamicprogramming_tpu_torch.core.constants import NUM_COLORS, NUM_OBJECTS
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams, EnvState

__all__ = ["Error", "check_state", "checked_step", "checked_reset", "debug_mode"]


class Error:
    """The violated invariants of one check, in the order they were
    checked (JAX's ``checkify.Error``)."""

    def __init__(self, messages: Sequence[str] = ()):
        self.messages: List[str] = list(messages)

    def get(self) -> Optional[str]:
        """The first violated invariant's message, or None."""
        return self.messages[0] if self.messages else None

    def throw(self) -> None:
        if self.messages:
            raise RuntimeError(self.messages[0])


def _state_checks(params: EnvParams, state: EnvState) -> List[Tuple[torch.Tensor, str]]:
    """(holds in every env, message) for every state invariant of the
    reference's Python layer (the bounds asserts of ``Grid.set``, the
    direction and position checks of ``MiniGridEnv``)."""
    x, y = state.agent_pos[:, 0], state.agent_pos[:, 1]
    return [
        (((x >= 0) & (x < params.width) & (y >= 0) & (y < params.height)).all(),
         "agent position out of bounds"),
        (((state.agent_dir >= 0) & (state.agent_dir < 4)).all(), "agent direction outside [0, 4)"),
        ((state.grid_obj < NUM_OBJECTS).all(), "grid object code outside the encoding table"),
        ((state.grid_color < NUM_COLORS).all(), "grid color code outside the encoding table"),
        ((state.grid_state < 3).all(), "door state outside {open, closed, locked}"),
        (((state.step_count >= 0) & (state.step_count <= params.max_steps)).all(),
         "step_count outside [0, max_steps]"),
        ((state.carrying_obj < NUM_OBJECTS).all(), "carried object code outside the encoding table"),
    ]


def _error(checks: List[Tuple[torch.Tensor, str]]) -> Error:
    holds = torch.stack([ok for ok, _ in checks]).cpu()  # the one host transfer
    return Error([msg for ok, (_, msg) in zip(holds.tolist(), checks) if not ok])


def check_state(params: EnvParams, state: EnvState) -> Error:
    """Every invariant of the batch ``state``, read in one transfer."""
    return _error(_state_checks(params, state))


def checked_step(env):
    """``env.step`` with its checks: returns ``(err, outputs)``.  Besides
    the state invariants, the reward must be finite and inside
    ``env.reward_range``."""
    lo, hi = env.reward_range

    def step(state: EnvState, action, generator: Optional[torch.Generator] = None):
        out = env.step(state, action, generator)
        _, new_state, reward, _, _, _ = out
        checks = _state_checks(env.params, new_state) + [
            (torch.isfinite(reward).all(), "non-finite reward"),
            (((reward >= lo) & (reward <= hi)).all(), "reward outside the declared reward_range"),
        ]
        return _error(checks), out

    return step


def checked_reset(env):
    """``env.reset`` with the state invariants checked after generation:
    ``(generator, batch_size=1, device="cuda") -> (err, (obs, state))``."""

    def reset(generator: torch.Generator, batch_size: int = 1, device="cuda"):
        obs, state = env.reset(generator, batch_size, device)
        return check_state(env.params, state), (obs, state)

    return reset


class _NonFinite(TorchDispatchMode):
    """Raise at the first operator whose floating output holds a NaN
    (``nans``) or an Inf (``infs``)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if not isinstance(t, torch.Tensor) or not t.is_floating_point():
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """A block in which every operator's floating outputs are checked:
    the first NaN or Inf raises ``FloatingPointError`` naming the operator
    that made it.  Each check reads one flag from the device, so the block
    runs in lockstep with it."""
    with _NonFinite(nans, infs):
        yield
