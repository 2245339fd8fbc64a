"""The environment record.

Counterpart of ``minigrid_dynamicprogramming_tpu/core/env.py``: one
registered id with its static params, its layout generator and the slots
for the per-family hooks.  ``generate`` has the signature::

    generate(generator, params, batch_size, device="cuda") -> EnvState

and returns a batch-first :class:`EnvState` drawn from ``generator`` (a
``torch.Generator`` on ``device``).

The hook slots keep the record's shape, but no hooked family is ported
yet: setting any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

from minigrid_dynamicprogramming_tpu_torch.core.state import EnvParams

_HOOKS = (
    "pre_step",
    "post_step",
    "action_map",
    "pre_step_lanes",
    "post_step_lanes",
    "generate_batch",
)


class Environment:
    """One registered environment id: static params + behavior hooks."""

    def __init__(
        self,
        env_id: str,
        params: EnvParams,
        generate: Callable,
        pre_step: Optional[Callable] = None,
        post_step: Optional[Callable] = None,
        action_map: Optional[Callable] = None,
        action_dim: int = 7,
        pre_step_lanes: Optional[Callable] = None,
        post_step_lanes: Optional[Callable] = None,
        hook_rng: bool = True,
        generate_batch: Optional[Callable] = None,
    ):
        hooks = dict(
            pre_step=pre_step,
            post_step=post_step,
            action_map=action_map,
            pre_step_lanes=pre_step_lanes,
            post_step_lanes=post_step_lanes,
            generate_batch=generate_batch,
        )
        set_hooks = [name for name in _HOOKS if hooks[name] is not None]
        if set_hooks:
            raise NotImplementedError(
                f"{env_id}: hooks {set_hooks} are not ported yet"
            )
        self.env_id = env_id
        self.params = params
        self.generate = generate
        self.action_dim = action_dim
        self.hook_rng = hook_rng
        for name, fn in hooks.items():
            setattr(self, name, fn)
