"""Step helpers shared by the transition code.

Only ``success_reward`` is needed by the lane-major engine; the JAX
package's batch-first ``base_step`` has no counterpart here (the port keeps
one batch-last engine, ``parallel/lanes.py``)."""

from __future__ import annotations

import torch


def success_reward(step_count: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Reward on reaching the goal: ``1 - 0.9 * step_count / max_steps``,
    computed in float32 like the JAX version."""
    return 1.0 - 0.9 * (step_count.to(torch.float32) / max_steps)
