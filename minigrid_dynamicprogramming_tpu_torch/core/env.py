"""The environment record.

Counterpart of ``minigrid_dynamicprogramming_tpu/core/env.py``: one
registered id with its static params, its layout generator and the
per-family hooks (the reference's per-subclass ``step`` overrides).
``generate`` has the signature::

    generate(generator, params, batch_size, device="cuda") -> EnvState

and returns a batch-first :class:`EnvState` drawn from ``generator`` (a
``torch.Generator`` on ``device``).

The port keeps one batch-last engine (``parallel/lanes.py``), so each hook
is registered once, lane-major, with these signatures::

    action_map(params, action) -> action
    pre_step_lanes(params, generator, ls, action) -> ls
    post_step_lanes(params, generator, prev, ls, action, reward, terminated)
        -> (ls, reward, terminated)

``generator`` is the rollout's ``torch.Generator`` when ``hook_rng`` is
True and None otherwise (the hooks of such families draw nothing).  The
JAX record's batch-first ``pre_step``/``post_step`` slots have no
counterpart, and neither has its ``generate_batch``: the port's
``generate`` is already batched, so a family with a pooled generator
(MultiRoom) registers it as its ``generate``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams


class Environment:
    """One registered environment id: static params + behavior hooks."""

    def __init__(
        self,
        env_id: str,
        params: EnvParams,
        generate: Callable,
        mission_text: Optional[Callable] = None,
        action_map: Optional[Callable] = None,
        action_dim: int = 7,
        reward_range: Tuple[float, float] = (0.0, 1.0),
        pre_step_lanes: Optional[Callable] = None,
        post_step_lanes: Optional[Callable] = None,
        hook_rng: bool = True,
    ):
        self.env_id = env_id
        self.params = params
        self.generate = generate
        self._mission_text = mission_text
        self.action_map = action_map
        self.action_dim = action_dim
        self.reward_range = reward_range
        self.pre_step_lanes = pre_step_lanes
        self.post_step_lanes = post_step_lanes
        # False when the hooks never draw: step paths then pass them no
        # generator.
        self.hook_rng = hook_rng

    def mission_text(self, mission_codes) -> str:
        """Decode one env's mission code vector to the reference's mission
        string ("" for families without one)."""
        if self._mission_text is None:
            return ""
        return self._mission_text([int(c) for c in mission_codes])

    @property
    def mission_space(self):
        """The string-facing mission space of this id (``core/mission.py``)."""
        from minigrid_dynamicprogramming_tpu_torch.core.mission import mission_space_for

        return mission_space_for(self.env_id)
