"""Mean device ms of the port's span ``lanes.observation``, the step's
``obs_lanes``, its checksum and its per-step writes, over the steps of
the profiled rollout call (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "lanes.observation")
