"""Mean device ms of the port's span ``lanes.step``, the whole rollout step
(``_Scan.step``), over the steps of the profiled call: its in-graph
stamps summed over the graph's replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "lanes.step")
