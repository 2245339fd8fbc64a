"""The model FLOPs of the PPO learner, counted from the configuration's
shapes alone, whatever computes them: 2 FLOPs per multiply-add of every
convolution tap (each of a "SAME" 3x3 convolution's nine taps at every
output cell, the padding's included) and of every linear layer (the trunk
and the two heads), as the model (``models/nets.py:ActorCritic``) defines
them; the embeddings' gathers, the code bag, the pools, the loss and Adam
are not counted.  A minibatch step's forward is counted once and its
backward twice.

``BF16_DENSE_FLOPS_PER_S`` is the yardstick of the learner's share: one
NVIDIA H100 SXM's dense BF16 tensor-core rate, 989.4 TFLOP/s without
sparsity (NVIDIA's H100 data sheet), at the full 700 W power limit.
"""

from __future__ import annotations

BF16_DENSE_FLOPS_PER_S = 989.4e12


def forward_flops(cfg: dict) -> int:
    """FLOPs of one row's forward."""
    net = cfg["network"]
    side = cfg["agent_view_size"]
    cin = net["embed_dim"] * len(net["plane_vocabs"])
    flops = 0
    convs = net["conv_features"]
    for i, cout in enumerate(convs):
        flops += 2 * 9 * cin * cout * side * side
        cin = cout
        if i < len(convs) - 1:
            side //= 2
    trunk_in = side * side * cin + net["dir_features"] + net["code_features"]
    flops += 2 * trunk_in * net["hidden"]
    flops += 2 * net["hidden"] * (cfg["actions"] + 1)
    return flops


def minibatch_flops(cfg: dict, params: dict) -> int:
    """FLOPs of one minibatch step: ``rollout_len * num_envs /
    num_minibatches`` rows, each a forward and a backward (3 forwards)."""
    rows = params["rollout_len"] * (params["num_envs"] // params["num_minibatches"])
    return 3 * rows * forward_flops(cfg)
