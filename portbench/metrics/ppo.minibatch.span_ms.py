"""Mean device ms of the port's span ``ppo.minibatch``, the learner's whole
minibatch step (``PPO._learn_step``: gather, forward, loss, backward, clip
and Adam), over the traced updates' learner replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    recs = spans.under(spans.inside(trace.get("ppo_updates")), "ppo.minibatch", "ppo.learner.replay")
    n = sum(r["count"] for r in recs)
    return sum(r["device_ms"] for r in recs) / n if n else None
