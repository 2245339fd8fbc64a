"""Kernels a rollout step launches: the device kernels the profiler saw
over one whole ``lane_rollout`` call (its pool or first batch, the
capture's warm-up step, the graph's replays, the closing sums) over the
call's steps."""


def read(trace: dict):
    prof = trace.get("rollout_call")
    if prof is None or not prof.kernels():
        return None
    return len(prof.kernels()) / prof.counters["steps"]
