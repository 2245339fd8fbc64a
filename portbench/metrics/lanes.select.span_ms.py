"""Mean device ms of the port's span ``lanes.select``, the step's autoreset
select (``_select_pool`` or ``_select_lanes``), over the steps of the
profiled rollout call (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "lanes.select")
