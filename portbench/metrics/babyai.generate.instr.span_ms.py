"""Mean device ms of the port's span ``babyai.generate.instr``, LevelGen's
instruction (the descriptor match tables, the leaves' draws, the
unblocking check), over the steps of the profiled regen rollout call: its
in-graph stamps summed over the graph's replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "babyai.generate.instr")
