"""Every cell of ``BENCHMARK.json`` run by ``portbench/run.py`` on the card
with a short window, in a process of its own: exit 0, ``correct`` true,
the cell's metrics by name.  Needs a CUDA card; skips without one.

    python -m pytest -o addopts="" -m cuda portbench/tests/test_portbench_on_card.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2718281828",
         "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=harness.CHECKOUT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    e2e, per_layer = harness.cell_metrics(harness.benchmark(), cell)
    want = {m["name"] for m in (per_layer if trace else e2e)}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
