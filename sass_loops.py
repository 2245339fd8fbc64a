#!/usr/bin/env python3
"""Count the SASS instructions of each kernel's loops, on a machine with
the CUDA toolkit.

    python3 sass_loops.py FILE.cu [FILE.cu ...] [--out loops.json]
        [--dump NAME]   # also print those loops of each kernel whose
                        # mangled name holds NAME

Each source compiles with the flags of the port's kernels
(``minigrid_dynamicprogramming_tpu_torch/_kernels.py``) into a cubin for
``sm_90a``, and ``cuobjdump -sass`` disassembles it.  A loop is a
backward branch and the instructions from its target up to it.  For each
innermost loop that stores, the line gives its instruction count, its
shared and device loads (LDS, LDG) and its stores, and the
instructions per store (to shared or device memory): every state update
of a VI sweep stores its value once, so that is the loop's instruction
count per update.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from minigrid_dynamicprogramming_tpu_torch import _kernels  # noqa: E402

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA(?:\.[A-Z.]+)?\s+(?:`?\(?)0x([0-9a-f]+)")


def disassemble(src: Path, workdir: Path) -> str:
    nvcc = _kernels._nvcc()
    cubin = workdir / f"{src.stem}.cubin"
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    return subprocess.run(
        [str(cuobjdump), "-sass", str(cubin)], check=True, capture_output=True, text=True
    ).stdout


def functions(sass: str) -> dict:
    """Mangled name -> [(address, instruction text)]."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name:
            m = _INSTR.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def loops(instrs, dump: bool = False) -> list:
    """Innermost loops that store V (to shared or device memory), as dicts;
    with ``dump``, each with its instructions under "body"."""
    spans = []
    for addr, text in instrs:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    found = []
    for lo, hi in spans:
        if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue  # holds another loop
        body = [t for a, t in instrs if lo <= a <= hi]
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body]
        stores = sum(o.split(".")[0] in ("STS", "STG", "ST") for o in ops)
        if stores:
            found.append({
                "start": hex(lo), "end": hex(hi), "instructions": len(body),
                "LDS": sum(o.startswith("LDS") for o in ops),
                "LDG": sum(o.startswith("LDG") for o in ops),
                "stores": stores, "instructions_per_store": len(body) / stores,
                **({"body": body} if dump else {}),
            })
    return found


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+", type=Path)
    parser.add_argument("--out", help="also write the result as JSON to this file")
    parser.add_argument("--dump", help="print the loops of the kernels whose name holds this")
    args = parser.parse_args(argv)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in args.sources:
            result[str(src)] = per_fn = {}
            for name, instrs in functions(disassemble(src, Path(tmp))).items():
                per_fn[name] = found = loops(instrs)
                for lp in found:
                    print(f"[sass] {src} {name}: {json.dumps(lp)}", flush=True)
                if args.dump and args.dump in name:
                    for lp in loops(instrs, dump=True):
                        print(f"[sass] {name} loop {lp['start']}..{lp['end']}:", *lp["body"], sep="\n  ")
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
