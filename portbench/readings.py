#!/usr/bin/env python3
"""The readings that the limits of a cell's check are set from, on one card:
the program's numbers on many seeds (the lower readings) and the
control's (the upper ones), in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 101,102,103] [--out readings.jsonl]

Each seed runs the cell through its driver with a window of one call
(the call checked), as ``run.py`` does; each control seed puts the
cell's control in the program's place: the plain reference one step
below the configuration's precision (bfloat16 for float32).  One JSON
line per run: the seed, whether it was the control, and the numbers
compared.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="", help="comma-separated seeds of the program's runs")
    parser.add_argument("--control-seeds", default="", help="comma-separated seeds of the control's")
    parser.add_argument("--out", default=None, help="also append the lines to this file")
    args = parser.parse_args(argv)
    bench = harness.benchmark()
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control in runs:
            t0 = time.time()
            line = harness.run_cell(bench, args.workload, seed, 0.0, False, "cuda", t0,
                                    control=control)
            rec = {"cell": args.workload, "seed": seed, "control": control,
                   "correct": line["correct"], "s": round(time.time() - t0, 1),
                   "checks": {k: c["value"] for k, c in line["checks"].items()}}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
