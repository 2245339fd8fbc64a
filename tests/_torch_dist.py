"""Helpers of the port's multi-process tests: run one program in N fresh
worker processes that form a gloo group on the CPU.

Each worker runs ``prog`` with ``sys.argv[1:] == [address, rank, out]``;
it imports only the port (``tests/conftest.py`` imports JAX, and a worker
is a plain interpreter, not a pytest process), sets one thread (the suite
runs several pytest workers at once) and writes its results to ``out``.
Every group is bounded by ``GROUP_TIMEOUT_S`` and every process by
``PROCESS_TIMEOUT_S``, so a rendezvous that never forms fails the test in
minutes instead of hanging the suite.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from minigrid_dynamicprogramming_tpu_torch.parallel.scaling import free_port

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 120
PROCESS_TIMEOUT_S = 300

# The first lines of every worker: one thread, the group formed on the CPU.
PRELUDE = """
import sys
import torch
torch.set_num_threads(1)
from minigrid_dynamicprogramming_tpu_torch.parallel import distributed
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
"""


def free_address() -> str:
    """A localhost address whose port was free a moment ago (as JAX's
    ``tests/test_scaling.py`` takes one)."""
    return f"127.0.0.1:{free_port()}"


def join(n: int) -> str:
    """The line that forms an ``n``-rank gloo group (one attempt)."""
    return (
        f"distributed.initialize(addr, {n}, rank, backend='gloo', max_retries=1, "
        f"timeout_s={GROUP_TIMEOUT_S})\n"
    )


def run_workers(prog: str, n: int, outs) -> list:
    """Run ``PRELUDE + prog`` as ranks 0..n-1, the i-th writing ``outs[i]``;
    returns each one's output, after checking that all exited 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    addr = free_address()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", PRELUDE + prog, addr, str(r), str(outs[r])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
        )
        for r in range(n)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} exited {p.returncode}:\n{log}"
    return logs
