"""The device's idle ms inside the port's span ``lanes.capture`` (the
step's warm-up, the synchronise, ``empty_cache`` and the capture) in the
profiled rollout call: its host interval less the profiler's device busy
time in it, overlaps merged, on the clock both share
(``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    prof = trace.get("rollout_call")
    recs = spans.named(spans.inside(prof), "lanes.capture")
    if not recs:
        return None
    return sum(spans.idle_ms_within(prof, r["start_ns"] / 1e9, r["end_ns"] / 1e9) for r in recs)
