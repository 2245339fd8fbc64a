"""Mean device ms of the port's span ``babyai.generate.rooms``, LevelGen's
rooms (``rg.init``, the locked room and its key, ``connect_all``, the 18
distractors, the agent), over the steps of the profiled regen rollout
call: its in-graph stamps summed over the graph's replays
(``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "babyai.generate.rooms")
