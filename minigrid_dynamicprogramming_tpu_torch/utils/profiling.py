"""Tracing and profiling.

Counterpart of ``minigrid_dynamicprogramming_tpu/utils/profiling.py``:

- ``trace(logdir)`` captures a ``torch.profiler`` trace of the enclosed
  block (the host's operators and, where a card is present, its kernels)
  and writes it into ``logdir`` as a Chrome trace (``trace.json``, which
  Perfetto and ``chrome://tracing`` open);
- ``annotate(name)`` is a named region: a ``record_function`` range in the
  trace and, on a card, an NVTX range, so the phases of a run (generate,
  step, observation, value iteration) are attributable;
- ``KernelTimer`` keeps wall-clock counters per name, the device that
  holds each call's outputs synchronized before the clock is read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "KernelTimer", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU activity, and CUDA where a card is
    available) and write ``logdir/trace.json``, also when the block
    raises; yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the trace (and an NVTX range on a card)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists,
    dicts and dataclasses)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


class KernelTimer:
    """Wall-clock per name, with device synchronization.

    ``timer.run("step", fn, *args, units=B)`` calls ``fn``, waits for the
    devices that hold its outputs, and charges the time to "step".
    ``report()`` returns ``{name: {"seconds", "calls", "per_s"}}``, where
    ``per_s`` divides the units of work charged by the seconds."""

    def __init__(self):
        self._seconds: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}
        self._units: Dict[str, float] = {}

    def _charge(self, name: str, dt: float, units: float) -> None:
        self._seconds[name] = self._seconds.get(name, 0.0) + dt
        self._calls[name] = self._calls.get(name, 0) + 1
        self._units[name] = self._units.get(name, 0.0) + units

    def run(self, name: str, fn: Callable, *args, units: float = 0.0, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        self._charge(name, time.perf_counter() - t0, units)
        return out

    @contextlib.contextmanager
    def section(self, name: str, units: float = 0.0):
        """Time a block (the caller synchronizes any device inside it)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._charge(name, time.perf_counter() - t0, units)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, sec in self._seconds.items():
            units = self._units.get(name, 0.0)
            out[name] = {
                "seconds": sec,
                "calls": self._calls[name],
                "per_s": units / sec if sec > 0 and units else 0.0,
            }
        return out
