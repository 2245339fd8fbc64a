"""Mean device ms of the port's span ``babyai.generate.accept``, the kept
layouts (the validation, the stable sort, ``take``, ``init_instr``'s marks
and step limits), over the steps of the profiled regen rollout call: its
in-graph stamps summed over the graph's replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "babyai.generate.accept")
