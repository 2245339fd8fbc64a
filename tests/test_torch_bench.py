"""``bench_torch.py``, the port's headline bench, at a tiny size on the CPU.

It prints one JSON line in ``bench.py``'s shape whose ``extra`` keys are
bench.py's, read from its source with ``ast`` (importing it would import
JAX), with ``pallas`` read as ``cuda`` and ``xla`` as ``plain``: the
retired padded VI metric left out, and on the CPU the two kernel rows and
``launches`` too.  ``--learn`` writes bench.py's artifact keys.  Without a
card both entry points refuse to run."""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
from pathlib import Path

import pytest
import torch

import bench_torch

torch.set_num_threads(1)

BENCH_PY = Path(__file__).resolve().parents[1] / "bench.py"
LEGACY = "vi_sweeps_per_s_legacy_padded"  # on ROADMAP's "do not port" list
KERNEL_ROWS = {"vi_d1_cuda_sweeps_per_s", "vi_key_cuda_sweeps_per_s"}
TIMES = {"ppo_rollout_s", "ppo_learner_s"}
TINY = {
    **bench_torch.FULL,
    "batch": 8, "horizon": 8, "pool_rounds": 2, "warmup": 1, "iters": 2,
    "family_batch": 4, "family_horizon": 4, "family_rounds": 2, "family_warmup": 1, "family_iters": 2,
    "vi_batch": 2, "vi_sweeps": 4, "key_batch": 2, "key_sweeps": 4,
    "obstructed_batch": 1, "obstructed_sweeps": 2, "twokey_batch": 1, "twokey_sweeps": 2,
    "dp_runs": 2,
    "ppo_envs": 16, "ppo_len": 4, "ppo_minibatches": 2, "ppo_warmup": 1, "ppo_timed": 2,
    "learn_envs": 16, "learn_len": 8, "learn_max_updates": 2,
}


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys}


def _extra_stores(node: ast.AST):
    """The subscripts under ``node`` that store into ``extra``."""
    return [
        n.slice for n in ast.walk(node)
        if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
        and isinstance(n.value, ast.Name) and n.value.id == "extra"
    ]


def _bench_py_extra_keys() -> set:
    """Every key bench.py's ``main`` stores into ``extra``: constants, and
    keys made from a loop variable that runs over literals, either
    ``for name, f in (("a", ...), ...)`` or ``for name, v in d.items()``
    with ``d`` a dict literal assigned in ``main``."""
    main = _function(ast.parse(BENCH_PY.read_text()), "main")
    dicts = {
        n.targets[0].id: _dict_keys(n.value) for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
        and isinstance(n.value, ast.Dict)
    }
    keys = {k.value for k in _extra_stores(main) if isinstance(k, ast.Constant)}
    for loop in ast.walk(main):
        if not (isinstance(loop, ast.For) and isinstance(loop.target, ast.Tuple)):
            continue
        var = loop.target.elts[0].id
        if isinstance(loop.iter, ast.Tuple):
            values = {e.elts[0].value for e in loop.iter.elts}
        else:
            values = dicts[loop.iter.func.value.id]  # d.items()
        for key in _extra_stores(loop):
            if isinstance(key, ast.Name) and key.id == var:
                keys |= values
            elif isinstance(key, ast.JoinedStr) and key.values[0].value.id == var:
                keys |= {f"{v}{key.values[1].value}" for v in values}  # f"{name}_steps_per_s"
    return keys


def _bench_py_learn_keys():
    """(artifact keys, run keys, curve-entry keys) of bench.py's ``--learn``."""
    tree = ast.parse(BENCH_PY.read_text())
    learn = _function(tree, "learn_main")
    artifact = next(
        n.value for n in ast.walk(learn)
        if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "artifact"
    )
    curve_fn = _function(tree, "_ppo_learning_curve")
    run = next(n.value for n in ast.walk(curve_fn) if isinstance(n, ast.Return))
    entry = next(
        n.args[0] for n in ast.walk(curve_fn)
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "append"
    )
    return _dict_keys(artifact), _dict_keys(run), _dict_keys(entry)


@pytest.fixture(scope="module")
def bench_run():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench_torch.main(TINY, device="cpu")
    return line, out.getvalue()


def test_prints_one_json_line(bench_run):
    line, printed = bench_run
    lines = printed.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == line
    assert (line["metric"], line["unit"]) == ("env_steps_per_s", "steps/s")
    assert line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench_torch.REFERENCE_STEPS_PER_S, 2)


def test_extra_keys_are_bench_py_keys(bench_run):
    mapped = {k.replace("pallas", "cuda").replace("xla", "plain") for k in _bench_py_extra_keys()}
    assert LEGACY in _bench_py_extra_keys() and KERNEL_ROWS <= mapped
    assert len(mapped) == 20  # 8 families, 7 VI rows, 3 PPO numbers, git_rev, timestamp_utc
    extra = bench_run[0]["extra"]
    assert set(extra) == (mapped - {LEGACY} - KERNEL_ROWS) | {"device", "spread"}
    assert not KERNEL_ROWS & set(extra) and "launches" not in extra
    assert extra["device"] == {"name": "cpu"}
    rev = extra["git_rev"]
    assert rev == "unknown" or (len(rev) == 40 and int(rev, 16) >= 0)


def test_rates_finite_and_positive(bench_run):
    line = bench_run[0]
    extra = line["extra"]
    rates = {k: v for k, v in extra.items() if k.endswith("_per_s")}
    assert len(rates) == 8 + 4 + 1  # families, the plain VI rows, PPO
    for key, rate in rates.items():
        assert math.isfinite(rate) and rate > 0, key
    for key in TIMES:
        assert math.isfinite(extra[key]) and extra[key] >= 0, key
    # Every rate was timed twice here, so each has a spread holding its value.
    assert set(extra["spread"]) == set(rates) | {"env_steps_per_s"}
    for key, (lo, hi) in extra["spread"].items():
        value = line["value"] if key == "env_steps_per_s" else extra[key]
        assert 0 < lo <= value <= hi, key


def test_learn_writes_bench_py_artifact(tmp_path, capsys):
    out = tmp_path / "learn.json"
    bench_torch.learn_main(str(out), TINY, device="cpu")
    artifact = json.loads(out.read_text())
    want_artifact, want_run, want_entry = _bench_py_learn_keys()
    assert set(artifact) == want_artifact and artifact["device"] == "cpu"
    assert [r["env_id"] for r in artifact["runs"]] == ["MiniGrid-DoorKey-5x5-v0", "BabyAI-GoToDoor-v0"]
    for run in artifact["runs"]:
        assert set(run) == want_run
        assert run["threshold"] == 0.90 and run["num_envs"] == 16 and run["rollout_len"] == 8
        assert 1 <= len(run["curve"]) <= 2
        for entry in run["curve"]:
            assert set(entry) == want_entry and entry["env_steps"] == entry["update"] * 16 * 8
    assert f"wrote {out}" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--learn", "--out", "learn.json"]])
def test_cli_defaults_to_the_card(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.cli(argv)
    assert not list(tmp_path.iterdir())
