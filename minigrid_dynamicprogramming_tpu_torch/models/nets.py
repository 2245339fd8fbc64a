"""Actor-critic network for Minigrid observations.

Counterpart of ``minigrid_dynamicprogramming_tpu/models/nets.py``, with
the same hyperparameters and parameters:

* the ``(view, view, 3)`` uint8 image is embedded per plane (object,
  color and state ids to 8 learned features each) by ``nn.Embedding``
  over the same ``(vocab, features)`` tables as JAX's one-hot matmuls;
* three 3x3 "SAME" convolutions (32, 64, 64 features) with a 2x2 max-pool
  between them, a 256-wide trunk, f32 policy and value heads;
* the BabyAI mission is consumed as its 48-int instruction code vector
  through a position-weighted embedding bag (``code_pos``).

The image arrives in the ``[x, y]`` wire layout and is fed as JAX feeds
it: the first spatial axis (x) is the convolutions' height.  The conv
output is flattened in flax's ``(H, W, C)`` order, so the trunk's weight
is flax's kernel transposed, whatever the view size.

``compute_dtype`` (bf16 by default, as in JAX) is the dtype of the
embeddings, convolutions and trunk; parameters are float32 and the heads
compute in float32.  Initialization draws flax's laws from a
``torch.Generator``: LeCun-normal (truncated) kernels, zero biases,
``variance_scaling(1, fan_in, normal)`` embeddings, ``normal(0.02)``
position weights.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minigrid_dynamicprogramming_tpu_torch.core.constants import NUM_ACTIONS
from minigrid_dynamicprogramming_tpu_torch.core.state import MISSION_SLOTS

PLANE_VOCABS = (16, 8, 4)  # object / color / state ids
DIR_FEATURES = 16
CODE_FEATURES = 32
# Standard deviation of a standard normal truncated to (-2, 2).
_TRUNC_STD = 0.87962566103423978


class ObsEncoder(nn.Module):
    """Encode ``{image, direction, mission}`` into one feature vector."""

    def __init__(
        self,
        view: int = 7,
        embed_dim: int = 8,
        conv_features: Sequence[int] = (32, 64, 64),
        hidden: int = 256,
        mission_vocab: int = 64,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mission_vocab = mission_vocab
        for c, vocab in enumerate(PLANE_VOCABS):
            setattr(self, f"plane_embed_{c}", nn.Embedding(vocab, embed_dim))
        chans = [embed_dim * len(PLANE_VOCABS), *conv_features]
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1) for cin, cout in zip(chans, chans[1:])
        )
        side = view
        for _ in conv_features[:-1]:
            side //= 2
        self.dir_embed = nn.Embedding(4, DIR_FEATURES)
        self.code_embed = nn.Embedding(mission_vocab, CODE_FEATURES)
        self.code_pos = nn.Parameter(torch.zeros(MISSION_SLOTS, CODE_FEATURES))
        self.trunk = nn.Linear(side * side * chans[-1] + DIR_FEATURES + CODE_FEATURES, hidden)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        dt = self.compute_dtype
        img = obs["image"].long()  # (B, V, V, 3), [x, y]-major
        x = torch.cat(
            [
                getattr(self, f"plane_embed_{c}")(img[..., c].clamp(0, vocab - 1))
                for c, vocab in enumerate(PLANE_VOCABS)
            ],
            dim=-1,
        ).to(dt)
        x = x.permute(0, 3, 1, 2)  # NCHW with H = x, W = y, as flax's NHWC
        for i, conv in enumerate(self.convs):
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1))
            if i < len(self.convs) - 1:
                x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's (H, W, C) order

        d = self.dir_embed(obs["direction"].long()).to(dt)
        codes = obs["mission"].long().clamp(0, self.mission_vocab - 1)
        tok = self.code_embed(codes).to(dt)
        m = (tok * self.code_pos.to(dt)).sum(dim=-2)

        h = torch.cat([x, d, m], dim=-1)
        return F.relu(F.linear(h, self.trunk.weight.to(dt), self.trunk.bias.to(dt)))


class ActorCritic(nn.Module):
    """Policy and value heads over :class:`ObsEncoder` features; returns
    ``(logits (B, num_actions), value (B,))`` in float32."""

    def __init__(
        self,
        num_actions: int = NUM_ACTIONS,
        view: int = 7,
        hidden: int = 256,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.encoder = ObsEncoder(view=view, hidden=hidden, compute_dtype=compute_dtype)
        self.policy_head = nn.Linear(hidden, num_actions)
        self.value_head = nn.Linear(hidden, 1)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(obs).float()
        return self.policy_head(h), self.value_head(h).squeeze(-1)


def _truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax's ``truncated_normal``: a standard normal cut to (-2, 2), by
    its inverse CDF, scaled so that the cut law has standard deviation
    ``std``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    with torch.no_grad():
        t.copy_((z.clamp(-2, 2) * (std / _TRUNC_STD)).to(t.dtype))


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """LeCun normal: fan_in is every axis of the weight but the output one
    (``Linear (out, in)``, ``Conv2d (out, in, kh, kw)``)."""
    _truncated_normal_(weight, 1 / math.sqrt(weight[0].numel()), generator)


@torch.no_grad()
def init_params(model: ActorCritic, generator: torch.Generator) -> ActorCritic:
    """Draw ``model``'s parameters from flax's initializers with
    ``generator`` (a CPU generator gives the same parameters whatever
    device the model later moves to); returns ``model``."""
    enc = model.encoder
    embeds = [getattr(enc, f"plane_embed_{c}") for c in range(len(PLANE_VOCABS))]
    for emb in [*embeds, enc.dir_embed, enc.code_embed]:
        feats = emb.weight.shape[1]
        emb.weight.copy_(torch.randn(emb.weight.shape, generator=generator) / math.sqrt(feats))
    for layer in [*enc.convs, enc.trunk, model.policy_head, model.value_head]:
        _lecun_normal_(layer.weight, generator)
        layer.bias.zero_()
    enc.code_pos.copy_(torch.randn(enc.code_pos.shape, generator=generator) * 0.02)
    return model
