"""Mean device ms a call of the port's span ``dp.kernel`` (the key-domain
kernel's launch on its route), as the profiled solve calls run it back
to back (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_call_ms(trace, "dp.kernel")
