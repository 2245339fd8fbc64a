"""The key-domain value-iteration call's share of its roofline, in %: the
least time the chip could take for the call's work
(``counts/key_vi_work.py``, ``peaks.py``) over the device time of every
operation the ``cuda_key_value_iteration`` call launches (masks and
kernel alike), per call, from the profiler."""

from portbench import peaks


def read(trace: dict):
    prof = trace.get("vi_calls")
    if prof is None or not prof.device:
        return None
    c = prof.counters
    device_s = prof.device_s() / c["calls"]
    return 100.0 * peaks.least_seconds(c["bytes"], c["operations"]) / device_s
