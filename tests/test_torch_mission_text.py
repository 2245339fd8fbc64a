"""The port's mission strings against the JAX package's: for every ported
id, the mission codes of a few layouts from the port's generator decode
to the same string under both records' ``mission_text``; for every BabyAI
id, so do the codes of the JAX package's numpy twin of the reference's
generation; and every id's ``mission_space`` is JAX's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port

torch.set_num_threads(1)

# The reference's Playground has no mission: its string is empty in both.
EMPTY_MISSION = {"MiniGrid-Playground-v0"}


@pytest.mark.parametrize("env_id", port.registered_ids())
def test_mission_text_equals_jax(env_id):
    tenv, jenv = port.make(env_id), mgtpu.make(env_id)
    states = tenv.generate(torch.Generator().manual_seed(2), tenv.params, 8, device="cpu")
    texts = set()
    for codes in states.mission:
        got = tenv.mission_text(codes)
        assert got == jenv.mission_text(np.asarray(codes)), env_id
        texts.add(got)
    assert all(texts) != (env_id in EMPTY_MISSION), env_id


@pytest.mark.parametrize("env_id", [i for i in port.registered_ids() if i.startswith("BabyAI-")])
def test_babyai_mission_text_of_twin_codes_equals_jax(env_id):
    """The codes of the JAX package's numpy twin of the reference's
    generation (four seeds) decode to JAX's ``surface_text`` strings."""
    from minigrid_dynamicprogramming_tpu.envs.babyai.core import surface_text

    from ._torch_babyai import twin_batch

    tenv = port.make(env_id)
    for codes in twin_batch(env_id, range(4))["mission"]:
        assert tenv.mission_text(torch.from_numpy(codes)) == surface_text(codes), env_id


@pytest.mark.parametrize("env_id", port.registered_ids())
def test_mission_space_equals_jax(env_id):
    """``Environment.mission_space`` (the port's copy of ``core/mission.py``)
    is JAX's space, and holds the strings the port's generator gives."""
    tenv, jenv = port.make(env_id), mgtpu.make(env_id)
    space, want = tenv.mission_space, jenv.mission_space
    assert type(space).__name__ == type(want).__name__, env_id
    assert space.ordered_placeholders == want.ordered_placeholders, env_id
    space.seed(7)
    want.seed(7)
    assert [space.sample() for _ in range(6)] == [want.sample() for _ in range(6)], env_id
    states = tenv.generate(torch.Generator().manual_seed(5), tenv.params, 4, device="cpu")
    for codes in states.mission:
        text = tenv.mission_text(codes)
        assert space.contains(text) and want.contains(text), (env_id, text)
