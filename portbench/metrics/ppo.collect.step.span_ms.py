"""Mean device ms of the port's span ``ppo.collect.step``, the whole
collector step (``PPO._collect_step``), a step over the traced updates'
collector replays: its in-graph stamps summed over the graph's replays
(``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    recs = spans.under(spans.inside(trace.get("ppo_updates")), "ppo.collect.step", "ppo.collector.replay")
    n = sum(r["count"] for r in recs)
    return sum(r["device_ms"] for r in recs) / n if n else None
