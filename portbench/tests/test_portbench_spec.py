"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name; no module of the harness imports JAX or the JAX
package, and the reference and the counts import nothing of the port."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.CHECKOUT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    # The whole check fits its budget with 24 cells.
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert _one_line(word) and not word.startswith("/") and ".." not in word
    script = bench["command"][1]
    assert any(script.startswith(p + "/") for p in bench["paths"]) and (ROOT / script).is_file()


def test_names_units_and_sources(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _one_line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs(bench):
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells_and_their_files(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = harness.load_json("workloads", w["name"])
        assert (spec["config"], spec["traffic"], spec["why"]) == (w["config"], w["traffic"], w["why"])
        harness.load_json("configs", spec["config"])
        assert hasattr(harness.load_module("drivers", spec["driver"]), "run")
        ends, layers = harness.cell_metrics(bench, w["name"])
        names = {m["name"] for m in ends}
        assert "setup_s" in names and len(names) >= 2 and layers
        for m in layers:
            assert m["moves"] in names and m["moves"] in e2e
            assert hasattr(harness.load_module("metrics", m["name"]), "read")
        assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())


def test_metric_readers_find_nothing_in_an_empty_trace(bench):
    for m in bench["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read({}) is None


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in harness.PORTBENCH.rglob("*.py"):
        found = set(_imports(path)) & harness.FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_and_counts_stand_alone():
    for sub in ("reference", "counts"):
        for path in (harness.PORTBENCH / sub).rglob("*.py"):
            assert "minigrid_dynamicprogramming_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run of each driver, in a fresh process, leaves no
    JAX module and no module of the JAX package in ``sys.modules``."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "b = harness.benchmark()\n"
        "harness.run_cell(b, 'doorkey-8x8.rollout-pool', 7, 0.0, False, 'cpu', time.time(),"
        " overrides=dict(batch=16, horizon=8))\n"
        "harness.run_cell(b, 'doorkey-16x16.vi-key', 7, 0.0, False, 'cpu', time.time(),"
        " overrides=dict(layouts=1, sweeps=4, ring=2, check_calls=1, check_block=1))\n"
        "print(harness.forbidden_loaded())\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "doorkey-16x16.vi-key",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
