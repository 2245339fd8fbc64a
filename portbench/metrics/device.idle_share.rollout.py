"""The card's idle share in a rollout call, in %: 1 - the device time of
every operation of one profiled call over the median wall time of the
window's calls (run without the profiler)."""

import statistics


def read(trace: dict):
    prof = trace.get("rollout_call")
    walls = trace.get("rollout_call_wall_s")
    if prof is None or not walls or not prof.device:
        return None
    return 100.0 * (1.0 - prof.device_s() / statistics.median(walls))
