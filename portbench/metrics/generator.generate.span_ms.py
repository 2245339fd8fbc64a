"""Device ms of every ``generator.generate`` span of the port in the
profiled rollout call, summed: the pool's one batch, or in "regen" the
initial batch, the capture's warm-up step and the in-graph stamps of
every replayed step (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    recs = spans.named(spans.inside(trace.get("rollout_call")), "generator.generate")
    return sum(r["device_ms"] for r in recs) if recs else None
