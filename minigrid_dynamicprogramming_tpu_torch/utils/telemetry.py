"""Acceptance telemetry of the layout generators.

Counterpart of ``minigrid_dynamicprogramming_tpu/utils/telemetry.py``.
The reference surfaces exhausted rejection sampling as exceptions
(``place_obj``'s ``RecursionError``, BabyAI's regenerate-on-
``RejectSampling`` loop); the generators here cannot raise in the middle
of a batch, so exhaustion must be observable as telemetry instead, or a
systematically rejecting configuration would silently ship a truncated
(biased) layout law.

:func:`generation_acceptance` reports, over one batch:

- ``accept_rate``: the share of layouts that came from an accepted
  attempt; below 1.0 some layouts are repeats or fallbacks, and the law is
  suspect at this configuration;
- ``mean_tries`` / ``p99_tries`` / ``max_tries``: attempts spent per
  layout;
- ``first_try_rate``: the share accepted at their first attempt.

The port's rejecting generators are pooled, not a loop per env (MultiRoom's
chains, BabyAI's ``RoomGridLevel``): a batch draws its attempts at once
and keeps the accepted ones in draw order.  Their ``generate_stats`` hook
(``Environment.generate_stats``) reports, for each kept layout, ``ok``
(it came from an accepted attempt) and ``tries``: the attempts drawn since
the previous accepted one, itself included, which is what a loop per env
would have spent on it (:func:`pooled_stats`).  Every other id goes
through a structural check of the generated batch, so the report is never
vacuous.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from minigrid_dynamicprogramming_tpu_torch.core.constants import OBJ_EMPTY, OBJ_FLOOR, OBJ_GOAL
from minigrid_dynamicprogramming_tpu_torch.core.state import resolve_device

__all__ = ["GenStats", "generation_acceptance", "pooled_stats"]


class GenStats(NamedTuple):
    """Outcome of the generation of each layout of a batch."""

    tries: torch.Tensor  # (B,) int64: attempts spent (1 = first try)
    ok: torch.Tensor  # (B,) bool: an attempt was accepted


def pooled_stats(ok: torch.Tensor, n: int) -> GenStats:
    """The :class:`GenStats` of the ``n`` layouts a pooled generator keeps
    from its attempts ``ok`` ((m,) bool, draw order): the k-th kept layout
    is the k-th accepted attempt and spent the attempts since the one
    before; where fewer than ``n`` were accepted, the rest are repeats
    (``ok`` False) charged the attempts after the last acceptance."""
    m = ok.shape[0]
    pos = torch.nonzero(ok)[:, 0]  # the accepted attempts, in draw order
    accepted = pos.shape[0]
    gaps = torch.diff(pos, prepend=pos.new_full((1,), -1))
    tail = m - (int(pos[-1]) + 1 if accepted else 0)
    k = torch.arange(n, device=ok.device)
    kept = k < accepted
    tries = torch.full((n,), tail, dtype=torch.int64, device=ok.device)
    if accepted:
        tries = torch.where(kept, gaps[k.clamp(max=accepted - 1)], tries)
    return GenStats(tries=tries, ok=kept)


def generation_acceptance(env, n: int = 4096, seed: int = 0, device="cuda") -> dict:
    """Acceptance report of ``env``'s generator over a batch of ``n``
    layouts drawn on ``device`` (see the module's docstring)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    if env.generate_stats is not None:
        _, stats = env.generate_stats(g, env.params, n, dev)
        tries = stats.tries.cpu().numpy()
        ok = stats.ok.cpu().numpy()
        return {
            "env_id": env.env_id,
            "n": n,
            "mode": "loop",
            "accept_rate": float(ok.mean()),
            "first_try_rate": float((tries <= 1).mean()),
            "mean_tries": float(tries.mean()),
            "p99_tries": int(np.percentile(tries, 99)),
            "max_tries": int(tries.max()),
        }

    # Structural validity (the agent in bounds on a walkable cell): catches a
    # generator whose masked placers all failed and fell back to junk cells.
    state = env.generate(g, env.params, n, dev)
    pos = state.agent_pos.long()
    x, y = pos[:, 0], pos[:, 1]
    in_bounds = (x >= 0) & (x < env.params.width) & (y >= 0) & (y < env.params.height)
    cell = state.grid_obj[torch.arange(n, device=dev), y.clamp(0, env.params.height - 1),
                          x.clamp(0, env.params.width - 1)]
    walkable = (cell == OBJ_EMPTY) | (cell == OBJ_GOAL) | (cell == OBJ_FLOOR)
    share = float((in_bounds & walkable).float().mean())
    return {
        "env_id": env.env_id,
        "n": n,
        "mode": "structural",
        "accept_rate": share,
        "first_try_rate": share,
        "mean_tries": 1.0,
        "p99_tries": 1,
        "max_tries": 1,
    }
