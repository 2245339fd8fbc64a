"""Mean ms of ``key_greedy_policy`` in a solve call: CUDA events around
the call, run alone and synchronised, over the traced calls."""

import statistics


def read(trace: dict):
    ms = trace.get("spans_ms", {}).get("policy")
    return statistics.mean(ms) if ms else None
