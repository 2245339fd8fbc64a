"""Mean device ms of the port's span ``babyai.verify``, the BabyAI verifier
(``envs/babyai/core.py:verify_step``) inside the step's transition, over
the steps of the profiled rollout call: its in-graph stamps summed over
the graph's replays (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_step_ms(trace, "babyai.verify")
