"""The port's BabyAI step, verifier hook included, and observation against
the JAX package's on twin layouts of the generic sampler's ids
(``LevelGen``), as ``test_torch_babyai_step.py`` holds the fixed-shape
levels: sequences (GoToSeq), one action of any kind (Synth), descriptors
with locations (PickupLoc), and every shape of the grammar, And,
Before and After included (MiniBossLevel, BossLevel).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minigrid_dynamicprogramming_tpu.envs.babyai import core as JB

from ._torch_babyai import face_target, twin_batch, verifier_parity

torch.set_num_threads(1)

CASES = [
    ("BabyAI-GoToSeqS5R2-v0", ("success", "partial")),
    ("BabyAI-SynthS5R2-v0", ("success",)),
    ("BabyAI-PickupLoc-v0", ("success",)),
    ("BabyAI-MiniBossLevel-v0", ("success", "partial")),
    ("BabyAI-BossLevel-v0", ("success", "partial")),
]


@pytest.mark.parametrize("env_id, events", CASES, ids=[c[0] for c in CASES])
def test_verifier_step_bit_identical(env_id, events):
    verifier_parity(env_id, events, face_target)


def test_cases_hold_every_combinator():
    """The Boss layouts these tests step hold single, And, Before and After
    instructions, and every leaf kind."""
    codes = np.concatenate([
        twin_batch(i, range(48))["mission"] for i in ("BabyAI-MiniBossLevel-v0", "BabyAI-BossLevel-v0")
    ])
    assert set(codes[:, 0]) == {JB.COMB_SINGLE, JB.COMB_BEFORE, JB.COMB_AFTER}
    assert (codes[:, JB.CLAUSE_OFF[0]] == 1).any() and (codes[:, JB.CLAUSE_OFF[1]] == 1).any()
    kinds = {int(codes[b, JB._leaf_base(c, l)]) for b in range(len(codes)) for c in (0, 1) for l in (0, 1)}
    assert kinds == {JB.KIND_NONE, JB.KIND_GOTO, JB.KIND_OPEN, JB.KIND_PICKUP, JB.KIND_PUTNEXT}
