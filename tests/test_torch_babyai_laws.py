"""The laws of the port's BabyAI generators against the JAX package's: one id
of each level module, by two-sample chi-square on marginals of N layouts.

Each package draws its layouts with its own pooled generator (the port's
``generate``, JAX's ``generate_batch``) from its own stream, so the two
agree in distribution only.  The ids are ones whose attempts are accepted
often enough that neither pool reuses a layout at N.  Marginals: the
agent's cell and direction; per object type, the cells it stands on and
its colors; door states; the instruction's combinator, which clauses are and-pairs, and its first leaf
(kind, and its first descriptor's type, color, location and plural flag);
the per-episode step limit; what the agent carries.  The exact invariants
of every id are in ``test_torch_babyai_generators.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import to_numpy
from minigrid_dynamicprogramming_tpu_torch.core.constants import NUM_OBJECTS, OBJ_DOOR, OBJ_WALL
from minigrid_dynamicprogramming_tpu_torch.envs.babyai import core as B

from .test_torch_roomgrid_generators import chi2_same

torch.set_num_threads(1)

N = 2048

# One id per level module: goto, open, pickup (PutNext), unlock, other and
# the generic sampler.
IDS = [
    "BabyAI-GoToLocal-v0",
    "BabyAI-OpenDoorLoc-v0",
    "BabyAI-PutNextLocal-v0",
    "BabyAI-UnlockToUnlock-v0",
    "BabyAI-ActionObjDoor-v0",
    "BabyAI-MiniBossLevel-v0",
]


def port_layouts(env_id: str, seed: int) -> dict:
    env = port.make(env_id)
    states, accepted = env.generate(
        torch.Generator().manual_seed(seed), env.params, N, device="cpu", return_accepted=True
    )
    assert int(accepted) >= N, (env_id, int(accepted))
    return to_numpy(states)


def jax_layouts(env_id: str, seed: int) -> dict:
    env = mgtpu.make(env_id)
    gen = jax.jit(env.generate_batch, static_argnums=(1, 2))
    states = gen(jax.random.PRNGKey(seed), env.params, N)
    return {k: np.asarray(getattr(states, k)) for k in states.__dataclass_fields__ if k != "rng"}


def marginals(s: dict) -> dict:
    obj = s["grid_obj"]
    n, h, w = obj.shape
    out = {
        "agent cell": np.bincount(s["agent_pos"][:, 1] * w + s["agent_pos"][:, 0], minlength=h * w),
        "agent dir": np.bincount(s["agent_dir"], minlength=4),
        "door states": np.bincount(s["grid_state"][obj == OBJ_DOOR], minlength=3),
        "carrying": np.bincount(s["carrying_obj"], minlength=NUM_OBJECTS),
        "step limit": np.bincount(s["aux"][:, B.AUX_MAX_STEPS], minlength=4096),
        "combinator": np.bincount(s["mission"][:, 0], minlength=3),
        "and-pairs": np.bincount(s["mission"][:, B.CLAUSE_OFF[0]] + 2 * s["mission"][:, B.CLAUSE_OFF[1]], minlength=4),
    }
    for o in range(NUM_OBJECTS):
        if o != OBJ_WALL and (obj == o).any():
            out[f"cells of {o}"] = (obj == o).sum(axis=0).ravel()
            out[f"colors of {o}"] = np.bincount(s["grid_color"][obj == o], minlength=6)
    base = B._leaf_base(0, 0)
    for j, name in enumerate(("kind", "strict", "type", "color", "loc", "plural")):
        out[f"leaf {name}"] = np.bincount(s["mission"][:, base + j], minlength=8)
    return out


@pytest.mark.parametrize("env_id", IDS)
def test_laws_equal_jax(env_id):
    got, want = port_layouts(env_id, seed=1), jax_layouts(env_id, seed=2)
    a, b = marginals(got), marginals(want)
    assert set(a) == set(b), (env_id, sorted(a), sorted(b))
    for name in a:
        assert len(a[name]) == len(b[name]), (env_id, name)
        chi2_same(a[name], b[name], f"{env_id}: {name}")
