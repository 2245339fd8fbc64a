"""Mean device ms of the encoder's lookups a minibatch step: the port's
spans ``nets.embed`` (the forward's launch) and ``nets.embed.grad`` (the
backward's two) summed over the traced updates' learner replays, over the
steps that ``nets.embed`` counts (``portbench/spans.py``).  A program
without those spans reads None."""

from portbench import spans


def read(trace: dict):
    recs = spans.inside(trace.get("ppo_updates"))
    fwd = spans.under(recs, "nets.embed", "ppo.learner.replay")
    grad = spans.under(recs, "nets.embed.grad", "ppo.learner.replay")
    n = sum(r["count"] for r in fwd)
    return sum(r["device_ms"] for r in fwd + grad) / n if n else None
