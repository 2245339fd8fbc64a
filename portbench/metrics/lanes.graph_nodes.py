"""Nodes of the rollout step's CUDA graph, the stamps left out: the
``graph_nodes`` attribute of the port's span ``lanes.capture`` in the
profiled rollout call (``portbench/spans.py``)."""

from portbench import spans


def read(trace: dict):
    nodes = [r["attrs"].get("graph_nodes") for r in
             spans.named(spans.inside(trace.get("rollout_call")), "lanes.capture")]
    return nodes[-1] if nodes and nodes[-1] is not None else None
