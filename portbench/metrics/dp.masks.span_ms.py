"""Mean device ms a call of the port's span ``dp.masks``
(``cuda_vi.key_vi_masks``, inside ``cuda_key_value_iteration``), as the
profiled solve calls run it back to back (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    return spans.per_call_ms(trace, "dp.masks")
