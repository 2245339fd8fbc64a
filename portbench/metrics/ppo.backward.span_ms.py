"""Mean device ms of the port's span ``ppo.backward`` (the loss's backward
through the network) a minibatch step, over the traced updates' learner
replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    recs = spans.under(spans.inside(trace.get("ppo_updates")), "ppo.backward", "ppo.learner.replay")
    n = sum(r["count"] for r in recs)
    return sum(r["device_ms"] for r in recs) / n if n else None
