"""The card's idle share in a solve call, in %: 1 - the device time of
every operation of the profiled calls, per call, over the mean time of
the window's calls (run without the profiler)."""

import statistics


def read(trace: dict):
    prof = trace.get("solve_calls")
    call_ms = trace.get("call_ms")
    if prof is None or not call_ms or not prof.device:
        return None
    busy_ms = 1e3 * prof.device_s() / prof.counters["calls"]
    return 100.0 * (1.0 - busy_ms / statistics.mean(call_ms))
