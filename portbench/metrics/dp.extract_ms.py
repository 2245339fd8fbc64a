"""Mean ms of ``extract_key_layout`` in a solve call: CUDA events around
the call, run alone and synchronised, over the traced calls."""

import statistics


def read(trace: dict):
    ms = trace.get("spans_ms", {}).get("extract")
    return statistics.mean(ms) if ms else None
