"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``_build/`` beside this file, and is
keyed by a hash of the source, the shared headers and the flags, so a
changed source rebuilds.  :func:`build` compiles every stale source at
once, one ``nvcc`` process each, all started together.

Every wrapper of a kernel goes through the same three steps here:
:func:`entry` fetches a C entry point with its argument types,
:func:`check` refuses a tensor of another device, dtype, shape or layout,
and :func:`launch` calls the entry point on the current stream and raises
on the CUDA error it returns.

Nothing here runs at import time: the package imports on machines with no
CUDA toolkit, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built yet,
    in parallel.  Returns each library's path; the compiler's output, with
    the per-kernel register and shared-memory report, is kept beside it as
    ``.log``.  Raises if any compile fails."""
    names = sources() if names is None else list(names)
    paths = {n: _library_path(n) for n in names}
    stale = {n: p for n, p in paths.items() if not p.exists()}
    if not stale:
        return paths
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in stale.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        stale[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, stale[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build([name])[name]))


def entry(name: str, fn: str, argtypes):
    """The C entry point ``fn`` of ``csrc/<name>.cu``, built and loaded if
    need be, taking ``argtypes`` and returning an int (a launch's
    cudaError_t, 0 = ok)."""
    f = getattr(library(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(who: str, device: torch.device, tensors: Dict[str, tuple]) -> None:
    """Raise unless each ``label: (tensor, dtype, shape)`` of ``tensors`` is
    a contiguous tensor of that dtype and shape on ``device``."""
    for label, (x, dtype, shape) in tensors.items():
        shape = tuple(shape)
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{who}: {label}: want contiguous {dtype} {shape} on {device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device} (contiguous: {x.is_contiguous()})"
            )


def launch(device: torch.device, fn, *args) -> None:
    """``fn(*args, stream)`` on the current stream of ``device``; raises on
    the cudaError_t it returns."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
