"""Plain reference of the port's actor-critic network
(``models/nets.py:ActorCritic``, the JAX package's flax model parameter
for parameter), written from its description in float32:

* the (B, V, V, 3) image, in the ``[x, y]`` wire layout, embedded per
  plane (object, colour, state ids to 8 features each, vocabularies 16,
  8, 4) as one-hot rows times the table, as the flax model computes it,
  and the three embeddings concatenated;
* NCHW with H = x, as flax's NHWC takes the image: three 3x3 "SAME"
  convolutions (32, 64, 64 features), each followed by a ReLU, a 2x2
  max-pool (floor) between them;
* flattened in flax's (H, W, C) order, then the direction's embedding
  (16 features) and the mission's position-weighted code bag (each of the
  48 codes' 32-feature embedding times its slot's weight, summed);
* a 256-wide trunk with a ReLU, then the policy and value heads.

Parameters are a plain dict keyed by the port's ``state_dict()`` names.
Every product is float32 with TF32 off (``exact``); a convolution is
the sum of its nine taps, each a plain contraction over the channels.

``rnd`` rounds what the program computes in its ``compute_dtype`` (the
embeddings, the convolutions' weights, biases and outputs, the direction
and code features and the trunk), ``rnd_head`` the heads' weights, biases
and outputs, which the program computes in float32: the identity for the
reference; for the control one step below each, ``fp8`` and ``bf16``.

Departures from the published description: none in what is computed;
ids outside a vocabulary raise here, where the port clamps them (no
GoToDoor observation holds one).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

PLANE_VOCABS = (16, 8, 4)

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact():
    """Float32 matrix products and convolutions without TF32 inside the
    block, the flags put back after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through ``float8_e4m3fn`` in the forward pass; the
    gradient passes unrounded (a straight-through rounding)."""
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through ``bfloat16`` in the forward pass; the gradient
    passes unrounded."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A "SAME" 3x3 convolution of (N, C, H, W): the sum over the nine taps
    of the zero-padded input's shifted window contracted with the tap's
    (out, in) weights, plus the bias."""
    n, c, h, w = x.shape
    padded = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = bias[None, :, None, None].expand(n, -1, h, w)
    for a in range(3):
        for b in range(3):
            out = out + torch.einsum("nchw,oc->nohw", padded[:, :, a:a + h, b:b + w], weight[:, :, a, b])
    return out


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` that ``ids`` name, as one-hot rows times the
    table (an id outside the table raises)."""
    return torch.nn.functional.one_hot(ids.long(), table.shape[0]).to(table.dtype) @ table


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x[:, :, :2 * (h // 2), :2 * (w // 2)].reshape(n, c, h // 2, 2, w // 2, 2).amax((3, 5))


def forward(params: Params, obs: Dict[str, torch.Tensor],
            rnd: Callable[[torch.Tensor], torch.Tensor] = identity,
            rnd_head: Callable[[torch.Tensor], torch.Tensor] = identity) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits (B, A), value (B,))`` of ``obs`` (``image`` (B, V, V, 3),
    ``direction`` (B,), ``mission`` (B, 48)), in float32."""
    with exact():
        img = obs["image"]
        x = rnd(torch.cat([embed(params[f"encoder.plane_embed_{c}.weight"], img[..., c])
                           for c in range(len(PLANE_VOCABS))], -1))
        x = x.permute(0, 3, 1, 2)  # NCHW, H = the image's first axis (x)
        n_convs = sum(1 for k in params if k.startswith("encoder.convs.") and k.endswith(".weight"))
        for i in range(n_convs):
            w, b = params[f"encoder.convs.{i}.weight"], params[f"encoder.convs.{i}.bias"]
            x = torch.relu(rnd(conv3x3(x, rnd(w), rnd(b))))
            if i < n_convs - 1:
                x = max_pool2(x)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's (H, W, C) order
        d = rnd(embed(params["encoder.dir_embed.weight"], obs["direction"]))
        tok = rnd(embed(params["encoder.code_embed.weight"], obs["mission"]))
        m = rnd((tok * rnd(params["encoder.code_pos"])).sum(-2))
        h = torch.cat([x, d, m], -1)
        h = torch.relu(rnd(h @ rnd(params["encoder.trunk.weight"]).T + rnd(params["encoder.trunk.bias"])))
        logits = rnd_head(h @ rnd_head(params["policy_head.weight"]).T + rnd_head(params["policy_head.bias"]))
        value = rnd_head(h @ rnd_head(params["value_head.weight"]).T + rnd_head(params["value_head.bias"]))[:, 0]
    return logits, value
