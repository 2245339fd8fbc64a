"""The shared part of the benchmark of the PyTorch port: finding a cell's
files by name, seeds, clocks and spans, the profiler's device and host
events, the guard against JAX, and the result line.

A cell named ``<cell>`` in ``BENCHMARK.json`` has
``portbench/workloads/<cell>.json`` (its configuration, driver, traffic
parameters and the limits of its correctness check), the configuration
``portbench/configs/<config>.json``, the driver
``portbench/drivers/<driver>.py`` and a reader
``portbench/metrics/<metric>.py`` for each per-layer metric.  Adding a
cell, a configuration or a metric adds files; no file here changes.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

PORTBENCH = Path(__file__).resolve().parent
CHECKOUT = PORTBENCH.parent
# Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "minigrid_dynamicprogramming_tpu"})


# --- finding a cell's files -----------------------------------------------

def load_json(kind: str, name: str) -> dict:
    with open(PORTBENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = PORTBENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports: each
    metric without a ``workloads`` key, and each that lists the cell."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


# --- seeds and clocks ---------------------------------------------------------

def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed for stream ``k`` of a run seeded ``seed`` (any whole
    number of any size)."""
    words = np.random.SeedSequence([abs(int(seed)), int(seed < 0), k]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def process_start_wall() -> Optional[float]:
    """When this process started, on the wall clock (Linux), else None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    except (OSError, ValueError, IndexError, StopIteration):
        return None
    return boot + start_ticks / os.sysconf("SC_CLK_TCK")


class Spans:
    """Durations of marked stretches of work on one device, in ms: CUDA
    events on a card (read once the work is done), the host clock after a
    synchronise elsewhere."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.pairs: List[Any] = []

    def start(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, begun) -> None:
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs.append((begun, e))
        else:
            self.pairs.append(1e3 * (time.perf_counter() - begun))

    def ms(self) -> List[float]:
        if self.cuda:
            self.torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.pairs]
        return list(self.pairs)


def report_window(calls: int, window_s: float, call_ms: List[float]) -> None:
    """One line on standard error: the window's calls and their times."""
    q = statistics.quantiles(call_ms, n=20) if len(call_ms) > 1 else call_ms * 19
    print(f"portbench: {calls} calls in {window_s:.3f} s; call ms min {min(call_ms):.4f} "
          f"median {statistics.median(call_ms):.4f} p95 {q[18]:.4f} max {max(call_ms):.4f}",
          file=sys.stderr, flush=True)


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


# --- the profiler ---------------------------------------------------------------

@dataclass
class Profile:
    """What the profiler saw over one traced stretch: device operations
    and host events as (name, start s, duration s) on one clock, and the
    stretch's wall time (host clock, ended by a synchronise)."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    counters: Dict[str, float] = field(default_factory=dict)

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not e[0].startswith(("Memcpy", "Memset"))]

    def device_s(self) -> float:
        return sum(e[2] for e in self.device)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (overlaps merged)."""
        busy, end = 0.0, -float("inf")
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            if s + d > end:
                busy += s + d - max(s, end)
                end = s + d
        return busy


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()


def _duration_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else 1000 * e.duration_us()


def profile(fn: Callable[[], Any]) -> Profile:
    """Run ``fn()`` under ``torch.profiler`` (host and device activity) and
    keep its events in memory; no trace file is written."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), _start_ns(e) / 1e9, _duration_ns(e) / 1e9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(rec)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(rec)
    return Profile(device=device, host=host, wall_s=wall)


def breakdown(p: Profile, top: int = 10, min_gap_s: float = 5e-6) -> dict:
    """The device operations that took most time, and the idle time
    between device operations (gaps of ``min_gap_s`` or more) by the
    innermost host event under way at each gap's middle."""
    by_name: Dict[str, float] = {}
    for name, _, d in p.device:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    spans = sorted((s, s + d) for _, s, d in p.device)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s - end >= min_gap_s:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(p.host, key=lambda e: e[1])
    starts = [h[1] for h in host]
    idle: Dict[str, float] = {}
    active: List[Tuple[str, float, float]] = []
    nxt = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        hi = bisect.bisect_right(starts, mid)
        active.extend(host[nxt:hi])
        nxt = max(nxt, hi)
        while active and active[-1][1] + active[-1][2] < mid:
            active.pop()
        name = active[-1][0][:160] if active else "host: no recorded event (Python)"
        idle[name] = idle.get(name, 0.0) + (b - a)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps_top]}


# --- one run ------------------------------------------------------------------

@dataclass
class Context:
    """What a driver gets: the cell's configuration and traffic, the
    limits of its check, the run's seed, window and trace switch."""

    config: dict
    params: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start_wall: float
    control: bool = False
    setup_s: Optional[float] = None

    def sub_seed(self, k: int) -> int:
        return sub_seed(self.seed, k)

    def rng(self, k: int) -> np.random.Generator:
        return np.random.default_rng(self.sub_seed(k))

    def setup_done(self) -> float:
        """Marks the end of set-up: seconds since the process started.  The
        objects made so far (imports, inputs) are frozen out of the
        collector's way, so that a full collection in the window scans
        only what the window made."""
        self.setup_s = time.time() - self.t_start_wall
        gc.freeze()
        return self.setup_s


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device: str,
             t_start_wall: float, overrides: Optional[dict] = None, control: bool = False) -> dict:
    """Run ``cell`` once through its driver and build the result line (a
    dict, ``checks`` last).  ``overrides`` replaces traffic parameters
    (the CPU tests' small sizes); ``control`` puts the cell's control in
    the program's place (``portbench/readings.py``)."""
    import torch

    wl = load_json("workloads", cell)
    ctx = Context(
        config=load_json("configs", wl["config"]),
        params={**wl["params"], **(overrides or {})}, limits=wl["limits"], seed=seed,
        seconds=seconds, trace=trace, device=device, t_start_wall=t_start_wall, control=control,
    )
    out = load_module("drivers", wl["driver"]).run(ctx)
    e2e, per_layer = cell_metrics(bench, cell)
    metrics = {}
    if trace:
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    if on_card:
        dev["power"] = power_limit()
    line = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace and out["trace"].get("window") is not None:
        window: Profile = out["trace"]["window"]
        dev["busy_s"] = window.busy_s()
        dev["window_s"] = window.wall_s
        line["breakdown"] = breakdown(window)
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    line["correct"] = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    """The result as the last line of standard output; the numbers
    compared, each beside its limit, as the last lines of standard
    error."""
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
