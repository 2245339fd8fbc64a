"""The environment record and its batch-first API.

Counterpart of ``minigrid_dynamicprogramming_tpu/core/env.py``: one
registered id with its static params, its layout generator and the
per-family hooks (the reference's per-subclass ``step`` overrides).
``generate`` has the signature::

    generate(generator, params, batch_size, device="cuda") -> EnvState

and returns a batch-first :class:`EnvState` drawn from ``generator`` (a
``torch.Generator`` on ``device``).

The methods a user calls are batch-first, where JAX's are one env's
functions that ``vmap`` batches; a single env is a call at B=1::

    reset(generator, batch_size=1, device="cuda") -> (obs, state)
    step(state, action, generator=None)
        -> (obs, state, reward, terminated, truncated, info)
    observation(state) -> {"image", "direction", "mission"}
    in_view(state, x, y), agent_sees(state, x, y) -> (B,) bool

``step`` runs the one lane engine (``parallel/lanes.py``): the state goes
lane-major, through ``step_lanes_env``, and back; the observation is
encoded from the lanes.

The port keeps one batch-last engine (``parallel/lanes.py``), so each hook
is registered once, lane-major, with these signatures::

    action_map(params, action) -> action
    pre_step_lanes(params, generator, ls, action) -> ls
    post_step_lanes(params, generator, prev, ls, action, reward, terminated)
        -> (ls, reward, terminated)

``generator`` is the rollout's ``torch.Generator`` where the hooks draw
(:attr:`Environment.hooks_draw`: the family has a hook and ``hook_rng``)
and None otherwise.  The JAX record's batch-first ``pre_step``/
``post_step`` slots have no counterpart, and neither has its
``generate_batch``: the port's ``generate`` is already batched, so a
family with a pooled generator (MultiRoom) registers it as its
``generate``.  ``generate_stats``, where a
family has one, takes ``generate``'s arguments and returns ``(state,
GenStats)``, the acceptance telemetry of ``utils/telemetry.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams, EnvState


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
        generate_stats: Optional[Callable] = None,
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
        self.generate_stats = generate_stats

    def reset(
        self, generator: torch.Generator, batch_size: int = 1, device="cuda"
    ) -> Tuple[Dict[str, torch.Tensor], EnvState]:
        """``batch_size`` fresh layouts drawn from ``generator`` (on
        ``device``) and their observation."""
        state = self.generate(generator, self.params, batch_size, device)
        return self.observation(state), state

    def step(
        self,
        state: EnvState,
        action,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], EnvState, torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
        """One transition of every env in the batch; ``action`` is ``(B,)``
        or one action for all.  ``generator`` feeds the hooks of families
        that draw (:attr:`hooks_draw`), and must then be given.  No
        auto-reset."""
        from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

        b = state.agent_dir.shape[0]
        action = torch.as_tensor(action, device=state.agent_dir.device).expand(b)
        ls, reward, terminated = L.step_lanes_env(self, L.to_lanes(state), action, generator)
        obs = self.observation_lanes(ls)
        return obs, L.from_lanes(self.params, ls), reward, terminated, ls.truncated, {}

    def observation(self, state: EnvState) -> Dict[str, torch.Tensor]:
        """``{"image": (B, view, view, 3) uint8 in the [x, y] layout,
        "direction": (B,), "mission": (B, MISSION_SLOTS)}``."""
        from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

        return self.observation_lanes(L.to_lanes(state))

    def observation_lanes(self, ls) -> Dict[str, torch.Tensor]:
        """:meth:`observation` of a lane-major state (``parallel/lanes.py``),
        in the same batch-first layout."""
        from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as L

        return {
            "image": L.obs_image_lanes(self.params, ls),
            "direction": ls.agent_dir,
            "mission": ls.mission.T,
        }

    def in_view(self, state: EnvState, x, y) -> torch.Tensor:
        """Whether world cell ``(x, y)`` is inside each agent's view
        rectangle (``MiniGridEnv.in_view``)."""
        from minigrid_dynamicprogramming_tpu_torch.ops.obs import in_view

        return in_view(self.params, state, x, y)

    def agent_sees(self, state: EnvState, x, y) -> torch.Tensor:
        """Whether the non-empty world cell ``(x, y)`` is visible through
        each encoded observation (``MiniGridEnv.agent_sees``)."""
        from minigrid_dynamicprogramming_tpu_torch.ops.obs import agent_sees

        return agent_sees(self.params, state, x, y)

    @property
    def hooks_draw(self) -> bool:
        """Whether a step draws from the generator: the family has a pre- or
        post-step hook, and ``hook_rng``."""
        hooked = self.pre_step_lanes is not None or self.post_step_lanes is not None
        return hooked and self.hook_rng

    @property
    def default_params(self) -> EnvParams:
        return self.params

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
