#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by its name
(``portbench/harness.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers compared with the plain reference, each with its
limit (also the last lines of standard error).

Exits 2, printing no result, where no card is found or fewer than the
cell asks for; 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_IMPORTED = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = harness.benchmark()
    chips = harness.cell_entry(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    start = harness.process_start_wall() or T_IMPORTED
    line = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", start)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
