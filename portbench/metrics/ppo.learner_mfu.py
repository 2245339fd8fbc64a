"""The learner's share of the card's dense bf16 peak, in %: the model
FLOPs of the traced updates' minibatch steps (``counts/ppo_flops.py``,
from the configuration's shapes) over the summed device time of the
port's span ``ppo.minibatch`` under the learner's replays times the peak
(``portbench/spans.py``)."""

from portbench import spans
from portbench.counts import ppo_flops


def read(trace: dict):
    recs = spans.under(spans.inside(trace.get("ppo_updates")), "ppo.minibatch", "ppo.learner.replay")
    steps = sum(r["count"] for r in recs)
    seconds = sum(r["device_ms"] for r in recs) / 1e3
    if not steps or seconds <= 0:
        return None
    flops = steps * ppo_flops.minibatch_flops(trace["config"], trace["params"])
    return 100.0 * flops / (seconds * ppo_flops.BF16_DENSE_FLOPS_PER_S)
