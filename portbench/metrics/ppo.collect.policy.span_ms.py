"""Mean device ms of the port's span ``ppo.collect.policy`` (the network's
forward, the action's draw and its log-probability) a collector step, over
the traced updates' collector replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    recs = spans.under(spans.inside(trace.get("ppo_updates")), "ppo.collect.policy",
                       "ppo.collector.replay")
    n = sum(r["count"] for r in recs)
    return sum(r["device_ms"] for r in recs) / n if n else None
