"""The success reward divides by the step limit exactly, as JAX does.

``1 - 0.9 * step_count / max_steps`` is computed in float32 by
``ops/step.py:success_reward`` (every goal and pickup reward of the
rollout) and ``dp/tabular.py:env_return`` (the closed-form return of the
greedy policy).  On CUDA, PyTorch divides by a CPU scalar (a Python
number or a 0-dim CPU tensor) as a multiply by its reciprocal, which is
not the exactly rounded quotient: so both divide by a tensor on the
dividend's device.  Here, on the CPU, every division they make is held to
that, and the reward to the exactly rounded float32 result of each
operation and to JAX's, at every step count of every registered id's step
limit; ``tests/test_torch_on_card.py`` holds the card's to the CPU's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from minigrid_dynamicprogramming_tpu.dp import tabular as jtab
from minigrid_dynamicprogramming_tpu.ops import step as jstep

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.dp import tabular as ttab
from minigrid_dynamicprogramming_tpu_torch.ops.step import success_reward

torch.set_num_threads(1)

GAMMA = 0.995
STEP_LIMITS = sorted({port.make(i).params.max_steps for i in port.registered_ids()})
# Step counts 0..m at which a multiply by float32(1 / m) changes the reward.
RECIPROCAL_WRONG = {640: 80, 245: 81}


class Divisions(TorchDispatchMode):
    """Records (dividend, divisor) of every ``aten.div`` dispatched inside."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.div:
            self.calls.append(args[:2])
        return func(*args, **(kwargs or {}))


def _assert_tensor_divisors(calls, n: int) -> None:
    assert len(calls) == n, calls
    for dividend, divisor in calls:
        assert isinstance(divisor, torch.Tensor), f"divides by the number {divisor!r}"
        assert divisor.device == dividend.device
        assert not (divisor.dim() == 0 and divisor.device.type == "cpu"), "a 0-dim CPU tensor"


def _exact(t: np.ndarray, m: int) -> np.ndarray:
    """1 - 0.9 * (t / m), each float32 operation exactly rounded."""
    return np.float32(1) - np.float32(0.9) * (t.astype(np.float32) / np.float32(m))


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("m", [640, 245])
def test_success_reward_divides_by_a_tensor(m):
    steps = torch.arange(m + 1, dtype=torch.int32)
    with Divisions() as d:
        success_reward(steps, m)
    _assert_tensor_divisors(d.calls, 1)


def test_env_return_divides_by_a_tensor(monkeypatch):
    t_goal = torch.arange(1, 700, dtype=torch.float32)
    # steps_to_go's own division (by log gamma, then rounded) is not the reward's.
    monkeypatch.setattr(ttab, "steps_to_go", lambda v, gamma: t_goal)
    with Divisions() as d:
        got = ttab.env_return(torch.ones(699), GAMMA, 0, 640)
    _assert_tensor_divisors(d.calls, 1)
    want = np.where(t_goal.numpy() <= 640, _exact(t_goal.numpy(), 640), 0)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_step_limits_cover_the_known_cases():
    assert len(STEP_LIMITS) == 44 and {245, 640} <= set(STEP_LIMITS)


@pytest.mark.parametrize("m", STEP_LIMITS)
def test_success_reward_exact_at_every_step_count(m):
    steps = np.arange(m + 1, dtype=np.int32)
    got = success_reward(torch.from_numpy(steps), m)
    assert got.dtype == torch.float32
    want = _exact(steps, m)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jstep.success_reward(jnp.asarray(steps), m)))
    if m in RECIPROCAL_WRONG:  # the fault this guards against shows at these limits
        recip = np.float32(1) - np.float32(0.9) * (
            steps.astype(np.float32) * (np.float32(1) / np.float32(m))
        )
        assert int((recip != want).sum()) == RECIPROCAL_WRONG[m]


@pytest.mark.parametrize("m", [30, 245, 640, 3600])
def test_env_return_exact_and_equal_to_jax(m):
    """The greedy return from V = gamma^(d - 1), d = 1..m + 5: the exactly
    rounded reward at d <= m, 0 past it, as JAX's ``env_return``."""
    d = np.arange(1, m + 6, dtype=np.float32)
    v = (np.float64(GAMMA) ** (d - 1)).astype(np.float32)
    got = ttab.env_return(torch.from_numpy(v), GAMMA, 0, m)
    want = np.where(d <= m, _exact(d, m), np.float32(0))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jtab.env_return(jnp.asarray(v), GAMMA, 0, m)))
