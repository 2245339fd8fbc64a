"""The port's own span records (``utils/profiling.py`` of the port) that lie
inside one traced stretch of a driver.

Tracing is on in the port while a ``torch.profiler`` session records, so
every ``harness.profile`` stretch leaves the records of the spans it ran
in the port's recorder.  A record's host start and end come from
``time.time_ns()``, the clock of the profiler's events, so a record lies
inside a ``harness.Profile`` when its host start falls between the
profile's first and last host event.  A program that keeps no records
gives none, and each reader then reads None.
"""

from __future__ import annotations

from typing import List, Optional


def program_records() -> List[dict]:
    """Every record the port's recorder holds, or none where the port has
    no recorder."""
    try:
        from minigrid_dynamicprogramming_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "records", None)
    return list(read()) if callable(read) else []


def inside(prof) -> List[dict]:
    """The records whose host start lies within ``prof``'s host events."""
    if prof is None or not prof.host:
        return []
    lo = min(s for _, s, _ in prof.host)
    hi = max(s + d for _, s, d in prof.host)
    return [r for r in program_records() if lo <= r["start_ns"] / 1e9 <= hi]


def named(recs: List[dict], name: str) -> List[dict]:
    return [r for r in recs if r["name"] == name]


def under(recs: List[dict], name: str, ancestor: str) -> List[dict]:
    """The records named ``name`` that have a span named ``ancestor``
    among their parents in ``recs``."""
    by_id = {r["id"]: r for r in recs}

    def has(r):
        p = r["parent"]
        while p in by_id:
            if by_id[p]["name"] == ancestor:
                return True
            p = by_id[p]["parent"]
        return False

    return [r for r in named(recs, name) if has(r)]


def per_step_ms(trace: dict, name: str) -> Optional[float]:
    """Mean device ms of the span ``name`` over the steps that the profiled
    rollout call replayed (its records under ``lanes.replay``, each the sum
    over its ``count`` steps)."""
    recs = under(inside(trace.get("rollout_call")), name, "lanes.replay")
    n = sum(r["count"] for r in recs)
    return sum(r["device_ms"] for r in recs) / n if n else None


def per_call_ms(trace: dict, name: str) -> Optional[float]:
    """Mean device ms of the span ``name`` a call, over the profiled solve
    calls."""
    recs = named(inside(trace.get("solve_calls")), name)
    return sum(r["device_ms"] for r in recs) / len(recs) if recs else None


def idle_ms_within(prof, start_s: float, end_s: float) -> float:
    """ms of ``[start_s, end_s]`` in which no device operation of ``prof``
    ran (overlapping operations merged)."""
    busy, reach = 0.0, start_s
    for _, s, d in sorted(prof.device, key=lambda e: e[1]):
        lo, hi = max(s, reach), min(s + d, end_s)
        if hi > lo:
            busy += hi - lo
        reach = max(reach, min(s + d, end_s))
    return 1e3 * (end_s - start_s - busy)
