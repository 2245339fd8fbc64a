"""The PyTorch port as a package: it imports no JAX, its copied codes and
registry flags equal the JAX package's, its entry points refuse to fall
back to the CPU, and ``bridge`` carries every record across unchanged."""

from __future__ import annotations

import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core import constants as jconst
from minigrid_dynamicprogramming_tpu.dp.tabular import extract_layout
from minigrid_dynamicprogramming_tpu.dp.tabular_key import extract_key_layout
from minigrid_dynamicprogramming_tpu.parallel import lanes as jlanes

import minigrid_dynamicprogramming_tpu_torch as port
from minigrid_dynamicprogramming_tpu_torch.bridge import from_numpy, to_numpy
from minigrid_dynamicprogramming_tpu_torch.core import constants as tconst
from minigrid_dynamicprogramming_tpu_torch.core.env import Environment
from minigrid_dynamicprogramming_tpu_torch.core.state import EnvState
from minigrid_dynamicprogramming_tpu_torch.dp import tabular, tabular_key
from minigrid_dynamicprogramming_tpu_torch.parallel import lanes as tlanes

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ENV_ID = "MiniGrid-DoorKey-8x8-v0"

_IMPORT_ALL = """
import pkgutil, sys
import minigrid_dynamicprogramming_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(m.name)
import bench_torch  # the repository root's bench, beside the package
jax_pkg = "minigrid_dynamicprogramming_tpu"
bad = sorted(
    n for n in sys.modules
    if n.startswith(("jax", "flax", "optax", "orbax", "PIL", "pygame"))
    or n == jax_pkg or n.startswith(jax_pkg + ".")
)
print(" ".join(["imported"] + bad))
print(" ".join(["modules"] + sorted(
    n for n in sys.modules if n.startswith(pkg.__name__) or n == "bench_torch"
)))
"""

# Modules the fresh-process import must reach, with everything else.
MUST_IMPORT = [
    "minigrid_dynamicprogramming_tpu_torch.dp.tabular_twokey",
    "minigrid_dynamicprogramming_tpu_torch.core.mission",
    "minigrid_dynamicprogramming_tpu_torch.ops.obs",
    "minigrid_dynamicprogramming_tpu_torch.models",
    "minigrid_dynamicprogramming_tpu_torch.models.nets",
    "minigrid_dynamicprogramming_tpu_torch.models.ppo",
    "minigrid_dynamicprogramming_tpu_torch.render",
    "minigrid_dynamicprogramming_tpu_torch.render.tiles",
    "minigrid_dynamicprogramming_tpu_torch.wrappers",
    "minigrid_dynamicprogramming_tpu_torch.utils",
    "minigrid_dynamicprogramming_tpu_torch.utils.babyai_bot",
    "minigrid_dynamicprogramming_tpu_torch.benchmark",
    "minigrid_dynamicprogramming_tpu_torch.parallel.sharding",
    "minigrid_dynamicprogramming_tpu_torch.parallel.distributed",
    "minigrid_dynamicprogramming_tpu_torch.parallel.scaling",
    "minigrid_dynamicprogramming_tpu_torch.utils.debug",
    "minigrid_dynamicprogramming_tpu_torch.utils.checkpoint",
    "minigrid_dynamicprogramming_tpu_torch.utils.guards",
    "minigrid_dynamicprogramming_tpu_torch.utils.telemetry",
    "minigrid_dynamicprogramming_tpu_torch.utils.profiling",
    "minigrid_dynamicprogramming_tpu_torch.manual_control",
    "minigrid_dynamicprogramming_tpu_torch.docs_gen",
    "bench_torch",
] + [
    f"minigrid_dynamicprogramming_tpu_torch.envs.babyai.{m}"
    for m in ("core", "level", "goto", "open", "pickup", "unlock", "other", "levelgen")
]


def _np(tree) -> dict:
    names = tree._fields if hasattr(tree, "_fields") else tree.__dataclass_fields__
    return {n: np.asarray(getattr(tree, n)) for n in names}


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO,
        capture_output=True,
        text=True,
        check=True,
    ).stdout.splitlines()
    imported, modules = out[-2].split(), out[-1].split()
    assert modules[0] == "modules" and len(modules) > 50, out
    assert set(MUST_IMPORT) <= set(modules[1:]), sorted(set(MUST_IMPORT) - set(modules))
    assert imported == ["imported"], f"the port pulled in {imported[1:]}"


def test_constants_equal_jax():
    names = [n for n in dir(tconst) if n.isupper()]
    assert len(names) > 30
    for name in names:
        want, got = getattr(jconst, name), getattr(tconst, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


def test_registry_ids_and_flags_equal_jax():
    """All 171 ids, MiniGrid and BabyAI, with JAX's params, static flags
    (the instruction profile and ``done_actions`` among them) and hooks."""
    ids = port.registered_ids()
    assert len(ids) == 171 and ids == sorted(mgtpu.registered_ids())
    assert sum(i.startswith("BabyAI-") for i in ids) == 96
    for env_id in ids:
        jenv, tenv = mgtpu.make(env_id), port.make(env_id)
        fields = ("width", "height", "max_steps", "see_through_walls",
                  "agent_view_size", "extra")
        for f in fields:
            assert getattr(tenv.params, f) == getattr(jenv.params, f), (env_id, f)
        assert tenv.action_dim == jenv.action_dim
        assert tenv.hook_rng == jenv.hook_rng, env_id
        assert tenv.reward_range == tuple(jenv.reward_range), env_id
        for hook in ("action_map", "post_step_lanes", "mission_text"):
            assert (getattr(tenv, hook) is None) == (getattr(jenv, hook) is None), (env_id, hook)
        if env_id.startswith("BabyAI-"):
            # The verifier is the post-step hook; no MiniGrid plane-gate flag.
            assert tenv.post_step_lanes.__name__ == jenv.post_step_lanes.__name__ == "verify_step"
            assert not {"no_marks", "no_boxes"} & {k for k, _ in tenv.params.extra}, env_id
        # JAX's DynamicObstacles draws in its batch-first pre_step; the
        # port registers that hook lane-major only.
        assert (tenv.pre_step_lanes is None) == (
            jenv.pre_step_lanes is None and jenv.pre_step is None
        ), env_id
    with pytest.raises(KeyError, match="unknown environment id"):
        port.make("BabyAI-NoSuchLevel-v0")


@pytest.mark.parametrize("env_id", ["MiniGrid-MultiRoom-N2-S4-v0", "MiniGrid-MultiRoom-N6-v0"])
def test_multiroom_generate_is_the_pooled_generator(env_id):
    """JAX registers MultiRoom's pooled generator as ``generate_batch``; the
    port's record has no such slot, and its batched ``generate`` is that
    generator: it reports how many chain attempts succeeded, which the
    margin keeps above the batch (here at n = 512)."""
    assert mgtpu.make(env_id).generate_batch is not None
    env = port.make(env_id)
    with pytest.raises(TypeError, match="generate_batch"):
        Environment(env_id, env.params, env.generate, generate_batch=env.generate)
    states, accepted = env.generate(
        torch.Generator().manual_seed(0), env.params, 512, device="cpu", return_accepted=True
    )
    assert states.grid_obj.shape == (512, 25, 25) and int(accepted) >= 512


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = port.make(ENV_ID)
    g = torch.Generator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlanes.lane_rollout(env, g, 4, horizon=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.generate(g, env.params, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tabular.solve(env, g, 4, n_sweeps=2)
    # Asked for the CPU, each runs there.
    assert env.generate(g, env.params, 4, device="cpu").grid_obj.device.type == "cpu"


def _assert_round_trip(cls, arrays: dict):
    back = to_numpy(from_numpy(cls, arrays, "cpu"))
    assert set(back) == set(arrays) - {"rng"}
    for name, want in arrays.items():
        if name == "rng":
            continue
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)


@pytest.mark.parametrize("record", ["env_state", "lane_state", "pool", "layout", "key_layout"])
def test_bridge_round_trip(record):
    jenv = mgtpu.make(ENV_ID)
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    states = jax.vmap(jenv.generate, in_axes=(0, None))(keys, jenv.params)
    if record == "env_state":
        arrays = _np(states)
        # Exercise the widened dtypes with values past int16.
        arrays["marks"] = np.full_like(arrays["marks"], 0xFFFE)
        _assert_round_trip(EnvState, arrays)
    elif record == "lane_state":
        _assert_round_trip(tlanes.LaneState, _np(jlanes.to_lanes(states)))
    elif record == "pool":
        pool = jlanes._lane_pool(jenv, jax.random.PRNGKey(4), 4, "pool", 3)
        arrays = _np(pool)
        assert arrays["grid_obj"].shape == (3, 64, 4)
        _assert_round_trip(tlanes.LaneState, arrays)
    elif record == "layout":
        layouts = jax.vmap(partial(extract_layout, max_doors=2))(states)
        _assert_round_trip(tabular.TabularLayout, _np(layouts))
    else:
        layouts = jax.vmap(partial(extract_key_layout, max_doors=1))(states)
        _assert_round_trip(tabular_key.KeyTabularLayout, _np(layouts))


def test_bridge_refuses_unknown_fields():
    env = port.make(ENV_ID)
    arrays = to_numpy(env.generate(torch.Generator(), env.params, 2, device="cpu"))
    arrays["bogus"] = np.zeros(2)
    with pytest.raises(ValueError, match="bogus"):
        from_numpy(EnvState, arrays, "cpu")


def test_count_ops_counts_a_step_and_a_sweep():
    """``count_ops.py`` (operator counts of a rollout step and a two-key
    sweep) runs, and shows what the verifier's profile prunes: a
    single-goto id's verifier launches a fraction of the generic one's."""
    sys.path.insert(0, str(REPO))
    try:
        import count_ops
    finally:
        sys.path.remove(str(REPO))
    local, boss = (count_ops.step_counts(i) for i in ("BabyAI-GoToLocal-v0", "BabyAI-BossLevel-v0"))
    assert local["observation"] == boss["observation"] > 0
    assert 3 * local["post-step hook"] < boss["post-step hook"]
    assert local["rollout step"] > local["core transition"] + local["post-step hook"] + local["observation"]
    sweep = count_ops.twokey_sweep_counts()
    assert 0 < sweep["full-block outputs"] < sweep["operators"] < sweep["with views"]
