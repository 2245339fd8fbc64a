"""Device ms of one layout generation as the cell's rollout runs it
(CUDA events): in "pool" one eager ``generate`` of the pool a call, in
"regen" one batch a step, replayed from a CUDA graph."""


def read(trace: dict):
    return trace.get("generate_ms")
