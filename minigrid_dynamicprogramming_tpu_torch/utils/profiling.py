"""Tracing and profiling: the port's one tracing layer.

Counterpart of ``minigrid_dynamicprogramming_tpu/utils/profiling.py``:

- ``span(name, **attrs)`` is a named region: a ``RecordFunction`` range
  of the operator kind (``cpu_op``) in a ``torch.profiler`` trace and,
  on a card, an NVTX range.  (``record_function``'s ranges are
  ``user_annotation``s, which the profiler copies onto the device's
  timeline as if they were device work.)  While tracing is on a span
  also keeps a :class:`Record`: its name, its parent
  span, the outermost span it belongs to (its request), its host start
  and end from ``time.time_ns()`` (the clock of the profiler's events),
  its device time (a pair of CUDA events on the current stream on a
  card, read only when the record is read; the host clock on the CPU)
  and its attributes.  The ``with`` statement gives the record (None
  while tracing is off), so a span can add attributes as it learns them.
- ``graph_span(name)`` is a span inside a step that is captured as a CUDA
  graph (``parallel/lanes.py``).  Captured while tracing is on, it puts a
  stamp kernel (``csrc/trace.cu``) at its entry and exit, which read the
  device's clock and add the span's time and one to a slot of a small
  device buffer (:class:`GraphStamps`); after the replays one record a
  slot holds the sum and the count.  Run eagerly it is a plain ``span``.
- ``count(name, n)`` adds to a counter; ``counter(name)`` and
  ``counters()`` read them.  Counters always count.
- ``adopt(context())`` hands a thread's tracing context (whether it
  traces, its open spans, the stamps of the graph it captures) to work
  that another thread runs for it while it waits: autograd runs a CUDA
  backward in its own thread for the device while ``backward()`` blocks
  its caller, so a span in a custom backward nests where the backward
  was asked for, and stamps into the graph being captured.
- Tracing is on while a ``torch.profiler`` session records, or inside a
  ``tracing()`` block.  Off, a span costs a flag test and its ranges: no
  CUDA event, no allocation, no kernel, and a graph captured then holds
  no stamp.
- The records live in memory, at most ``CAPACITY``, the oldest dropped
  first and counted (``dropped()``); ``records()`` reads them.
- ``trace(logdir)`` captures a ``torch.profiler`` trace of the enclosed
  block and writes it into ``logdir`` as a Chrome trace (``trace.json``),
  with the block's records and the counters beside it (``spans.json``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import functools
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

from minigrid_dynamicprogramming_tpu_torch import _kernels

__all__ = [
    "trace", "span", "graph_span", "tracing", "is_tracing", "context", "adopt", "count",
    "counter", "counters", "records", "dropped", "clear", "GraphStamps", "load_stamps",
    "graph_nodes", "TRACE_FILE", "SPANS_FILE",
]

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
CAPACITY = 1 << 16


@dataclass(eq=False)
class Record:
    """One span, as kept while tracing is on.  ``device`` holds its device
    time until it is read: ms on the CPU, a pair of CUDA events on a card,
    or a slot of a :class:`GraphStamps` (whose sum and count are the
    span's over a graph's replays)."""

    id: int
    name: str
    parent: Optional[int]
    request: int
    start_ns: int
    attrs: Dict[str, Any] = field(default_factory=dict)
    end_ns: int = 0
    count: int = 1
    device: Any = None

    def read(self) -> dict:
        ms, n = self.device, self.count
        if isinstance(ms, tuple) and isinstance(ms[0], GraphStamps):
            total_ns, n = ms[0].totals(ms[1])
            ms = total_ns / 1e6
        elif isinstance(ms, tuple):
            ms[1].synchronize()
            ms = ms[0].elapsed_time(ms[1])
        return {
            "id": self.id, "name": self.name, "parent": self.parent, "request": self.request,
            "start_ns": self.start_ns, "end_ns": self.end_ns, "device_ms": ms, "count": n,
            "attrs": dict(self.attrs),
        }


class Recorder:
    """The records, the counters, and each thread's open spans."""

    def __init__(self, capacity: int = CAPACITY):
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.counters: Dict[str, float] = {}
        self.forced = 0  # depth of open ``tracing()`` blocks
        self.ids = itertools.count(1)
        self.local = threading.local()

    def add(self, rec: Record) -> None:
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def innermost(self) -> Optional[Record]:
        """The innermost open span that keeps a record."""
        for s in reversed(self.stack()):
            if s.rec is not None:
                return s.rec
        return None


RECORDER = Recorder()


def is_tracing() -> bool:
    return (RECORDER.forced > 0 or getattr(RECORDER.local, "adopted", False)
            or torch._C._autograd._profiler_enabled())


def context() -> tuple:
    """The calling thread's tracing context, for :func:`adopt`."""
    return is_tracing(), RECORDER.stack(), getattr(RECORDER.local, "stamps", None)


@contextlib.contextmanager
def adopt(ctx: tuple):
    """Inside the block, this thread traces as the thread whose
    :func:`context` ``ctx`` is did: with its tracing switch, onto its open
    spans (while that thread waits on this one) and into its graph's
    stamps."""
    local = RECORDER.local
    saved = (getattr(local, "adopted", False), getattr(local, "stack", None),
             getattr(local, "stamps", None))
    local.adopted, local.stack, local.stamps = ctx
    try:
        yield
    finally:
        local.adopted, local.stack, local.stamps = saved


@contextlib.contextmanager
def tracing():
    """Spans keep records inside the block, with or without a profiler."""
    RECORDER.forced += 1
    try:
        yield
    finally:
        RECORDER.forced -= 1


@functools.cache
def _on_card() -> bool:
    return torch.cuda.is_available()


class _Span:
    __slots__ = ("name", "attrs", "stamped", "rf", "rec", "slot", "stamps")

    def __init__(self, name: str, attrs: dict, stamped: bool):
        self.name, self.attrs, self.stamped = name, attrs, stamped
        self.rec = self.slot = self.stamps = None

    def __enter__(self) -> Optional[Record]:
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        card = _on_card()
        if card:
            torch.cuda.nvtx.range_push(self.name)
        if not is_tracing():
            return None
        stack = RECORDER.stack()
        if card and torch.cuda.is_current_stream_capturing():
            # Inside a capture only stamps can time a span.
            stamps = getattr(RECORDER.local, "stamps", None)
            if self.stamped and stamps is not None:
                up = stack[-1].slot if stack and stack[-1].stamps is stamps else None
                self.stamps, self.slot = stamps, stamps.open(self.name, up, self.attrs)
                stack.append(self)
            return None
        parent = RECORDER.innermost()
        rid = next(RECORDER.ids)
        self.rec = Record(
            rid, self.name, parent.id if parent else None, parent.request if parent else rid,
            time.time_ns(), dict(self.attrs),
        )
        if card:
            self.rec.device = torch.cuda.Event(enable_timing=True)
            self.rec.device.record()
        stack.append(self)
        return self.rec

    def __exit__(self, *exc) -> None:
        card = _on_card()
        if self.slot is not None:
            self.stamps.close(self.slot)
            RECORDER.stack().pop()
        elif self.rec is not None:
            rec = self.rec
            if card:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec.device = (rec.device, end)
            rec.end_ns = time.time_ns()
            if not card:
                rec.device = (rec.end_ns - rec.start_ns) / 1e6
            RECORDER.stack().pop()
            RECORDER.add(rec)
        if card:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(*exc)


def span(name: str, **attrs) -> _Span:
    """A named region; ``with span(...) as rec`` gives its record, or None
    while tracing is off.  Inside a CUDA graph's capture it keeps no
    record (use ``graph_span``)."""
    return _Span(name, attrs, False)


def graph_span(name: str, **attrs) -> _Span:
    """A span inside a step that may be captured as a CUDA graph: stamped
    into the graph while the capture runs in ``GraphStamps.capturing()``
    with tracing on, else a plain ``span``.  ``attrs`` go on its record
    either way."""
    return _Span(name, attrs, True)


def count(name: str, n: float = 1) -> None:
    c = RECORDER.counters
    c[name] = c.get(name, 0) + n


def counter(name: str) -> float:
    return RECORDER.counters.get(name, 0)


def counters() -> Dict[str, float]:
    return dict(RECORDER.counters)


def records() -> List[dict]:
    """Every record kept, oldest first, its device time read (which waits
    for the work it timed)."""
    return [r.read() for r in list(RECORDER.records)]


def dropped() -> int:
    return RECORDER.dropped


def clear() -> None:
    """Forget the records and the drops (the counters stay)."""
    RECORDER.records.clear()
    RECORDER.dropped = 0


# --- spans inside a captured CUDA graph ------------------------------------

@functools.cache
def _stamp_fn():
    return _kernels.entry("trace", "trace_stamp", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_void_p])


def load_stamps(device=None) -> None:
    """Build and load ``csrc/trace.cu`` and launch its stamps once, outside
    any capture, so that neither the build nor the module's loading falls
    inside a span or a capture."""
    stamps = GraphStamps(torch.device("cuda") if device is None else device)
    stamps.open("load", None)
    stamps.close(0)
    torch.cuda.synchronize(stamps.device)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a graph captured with ``keep_graph=True``."""
    n = ctypes.c_size_t(0)
    fn = _kernels.entry("trace", "trace_graph_nodes", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)])
    err = fn(ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"trace_graph_nodes failed: CUDA error {err}")
    return n.value


class GraphStamps:
    """The device time of the ``graph_span``s of one captured graph, summed
    over its replays: a slot per span entered during the capture, each
    (start ns, summed ns, count) int64 in ``buf``.  Made before the
    capture, outside the graph's memory pool; ``emit()`` after the replays
    adds one record a slot under the innermost open span, read when the
    records are read.  ``kernels`` counts the stamp kernels captured, and
    ``graph_nodes`` is set by the capture (``lanes.capture_step``): the
    graph's nodes less the stamps."""

    SLOTS = 32

    def __init__(self, device):
        self.device = torch.device(device)
        self.fn = _stamp_fn()
        self.buf = torch.zeros((self.SLOTS, 3), dtype=torch.int64, device=self.device)
        self.slots: List[tuple] = []  # (name, parent slot, attributes)
        self.kernels = 0
        self.graph_nodes: Optional[int] = None
        self._host: Optional[torch.Tensor] = None

    @contextlib.contextmanager
    def capturing(self):
        """``graph_span``s stamp into this buffer inside the block."""
        prev = getattr(RECORDER.local, "stamps", None)
        RECORDER.local.stamps = self
        try:
            yield self
        finally:
            RECORDER.local.stamps = prev

    def _stamp(self, slot: int, close: int) -> None:
        _kernels.launch(self.device, self.fn, self.buf.data_ptr(), slot, close)
        self.kernels += 1

    def open(self, name: str, parent: Optional[int], attrs: Optional[dict] = None) -> int:
        if len(self.slots) == self.SLOTS:
            raise RuntimeError(f"more than {self.SLOTS} graph spans in one capture")
        self.slots.append((name, parent, dict(attrs or {})))
        self._stamp(len(self.slots) - 1, 0)
        return len(self.slots) - 1

    def close(self, slot: int) -> None:
        self._stamp(slot, 1)

    def emit(self) -> None:
        """The records read a copy of the sums taken now, and the buffer is
        zeroed: a graph kept across calls counts each call's replays
        afresh."""
        frozen = copy.copy(self)
        frozen.buf, frozen._host = self.buf.clone(), None
        self.buf.zero_()
        parent = RECORDER.innermost()
        now = time.time_ns()
        ids = [next(RECORDER.ids) for _ in self.slots]
        request = parent.request if parent else ids[0]
        for slot, (name, up, attrs) in enumerate(self.slots):
            RECORDER.add(Record(
                ids[slot], name,
                ids[up] if up is not None else (parent.id if parent else None), request,
                parent.start_ns if parent else now, {"graph": True, **attrs}, now, 0, (frozen, slot),
            ))

    def totals(self, slot: int) -> tuple:
        """(summed ns, count) of a slot, read once the replays are done."""
        if self._host is None:
            self._host = self.buf.cpu()
        return int(self._host[slot, 1]), int(self._host[slot, 2])


# --- the profiler -----------------------------------------------------------

def write_spans(path: str, since_ns: int = 0) -> None:
    """The records that started at ``since_ns`` or later, the drops and
    the counters, as JSON."""
    out = {
        "records": [r for r in records() if r["start_ns"] >= since_ns],
        "dropped": dropped(), "counters": counters(),
    }
    with open(path, "w") as f:
        json.dump(out, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU activity, and CUDA where a card is
    available) and write ``logdir/trace.json`` and ``logdir/spans.json``,
    also when the block raises; yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.time_ns()
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        write_spans(os.path.join(logdir, SPANS_FILE), t0)
