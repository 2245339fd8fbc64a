"""Mean device ms of the port's span ``lanes.transition``, the step's
actions, ``step_lanes_env`` and its done and reset counts, over the
steps of the profiled rollout call (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "lanes.transition")
