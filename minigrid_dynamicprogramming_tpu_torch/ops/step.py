"""Step helpers shared by the transition code.

Only ``success_reward`` is needed by the lane-major engine; the JAX
package's batch-first ``base_step`` has no counterpart here (the port keeps
one batch-last engine, ``parallel/lanes.py``)."""

from __future__ import annotations

import torch


def success_reward(step_count: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Reward on reaching the goal: ``1 - 0.9 * step_count / max_steps``,
    computed in float32 like the JAX version.

    The step limit is a float32 tensor on the step's device, filled there:
    CUDA divides by a Python number (a CPU scalar) as a multiply by its
    reciprocal, which is not the exactly rounded quotient JAX computes."""
    return 1.0 - 0.9 * (step_count / torch.full_like(step_count, max_steps, dtype=torch.float32))
