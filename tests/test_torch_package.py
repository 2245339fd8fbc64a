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
jax_pkg = "minigrid_dynamicprogramming_tpu"
bad = sorted(
    n for n in sys.modules
    if n.startswith(("jax", "flax")) or n == jax_pkg or n.startswith(jax_pkg + ".")
)
print(" ".join(["imported"] + bad))
print("modules", sum(n.startswith(pkg.__name__) for n in sys.modules))
"""


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
    assert modules[0] == "modules" and int(modules[1]) >= 15, out
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
    ids = port.registered_ids()
    assert ids == sorted(f"MiniGrid-DoorKey-{s}x{s}-v0" for s in (5, 6, 8, 16))
    for env_id in ids:
        jenv, tenv = mgtpu.make(env_id), port.make(env_id)
        fields = ("width", "height", "max_steps", "see_through_walls",
                  "agent_view_size", "extra")
        for f in fields:
            assert getattr(tenv.params, f) == getattr(jenv.params, f), (env_id, f)
        assert tenv.action_dim == jenv.action_dim
    with pytest.raises(KeyError, match="not ported"):
        port.make("MiniGrid-Empty-8x8-v0")


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
