"""The port's mission strings against the JAX package's: for every ported
id, the mission codes of a few layouts from the port's generator decode
to the same string under both records' ``mission_text``."""

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
