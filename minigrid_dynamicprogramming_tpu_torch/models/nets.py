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

The lookups (the three planes, the direction and the mission's bag) are
:func:`lookups`, ``nn.Embedding``'s composition under autograd (each value
rounded once to the compute dtype, each bag product rounded to it and the
48 summed in float32).  On a CUDA device they are one
``torch.autograd.Function``, :class:`EmbedKernel`, with the same rounding
points: its forward is one launch of ``csrc/embed.cu``, its backward two
(no sort, no float atomics: block partials summed in block order).  Spans
``nets.embed`` and ``nets.embed.grad``, counters ``nets.embed.launches``
and ``nets.embed.grad.launches`` (kernel launches: one a forward, two a
backward).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minigrid_dynamicprogramming_tpu_torch import _kernels
from minigrid_dynamicprogramming_tpu_torch.core.constants import NUM_ACTIONS
from minigrid_dynamicprogramming_tpu_torch.core.state import MISSION_SLOTS
from minigrid_dynamicprogramming_tpu_torch.utils import profiling

PLANE_VOCABS = (16, 8, 4)  # object / color / state ids
NUM_DIRS = 4
DIR_FEATURES = 16
CODE_FEATURES = 32
PLANE_FEATURES = 8  # features of each plane's lookup (csrc/embed.cu: kPlaneFeatures)
# Standard deviation of a standard normal truncated to (-2, 2).
_TRUNC_STD = 0.87962566103423978


class ObsEncoder(nn.Module):
    """Encode ``{image, direction, mission}`` into one feature vector."""

    def __init__(
        self,
        view: int = 7,
        conv_features: Sequence[int] = (32, 64, 64),
        hidden: int = 256,
        mission_vocab: int = 64,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        for c, vocab in enumerate(PLANE_VOCABS):
            setattr(self, f"plane_embed_{c}", nn.Embedding(vocab, PLANE_FEATURES))
        chans = [PLANE_FEATURES * len(PLANE_VOCABS), *conv_features]
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1) for cin, cout in zip(chans, chans[1:])
        )
        side = view
        for _ in conv_features[:-1]:
            side //= 2
        self.dir_embed = nn.Embedding(NUM_DIRS, DIR_FEATURES)
        self.code_embed = nn.Embedding(mission_vocab, CODE_FEATURES)
        self.code_pos = nn.Parameter(torch.zeros(MISSION_SLOTS, CODE_FEATURES))
        self.trunk = nn.Linear(side * side * chans[-1] + DIR_FEATURES + CODE_FEATURES, hidden)

    def tables(self) -> Tuple[torch.Tensor, ...]:
        """The lookups' six tables: the three planes', the direction's, the
        codes' and ``code_pos``."""
        planes = [getattr(self, f"plane_embed_{c}").weight for c in range(len(PLANE_VOCABS))]
        return (*planes, self.dir_embed.weight, self.code_embed.weight, self.code_pos)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        dt = self.compute_dtype
        image = obs["image"]  # (B, V, V, 3), [x, y]-major
        if image.is_cuda:
            x, d, m = EmbedKernel.apply(image, obs["direction"], obs["mission"], dt, *self.tables())
        else:
            x, d, m = lookups(image, obs["direction"], obs["mission"], dt, self.tables())
        x = x.permute(0, 3, 1, 2)  # NCHW with H = x, W = y, as flax's NHWC
        for i, conv in enumerate(self.convs):
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1))
            if i < len(self.convs) - 1:
                x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's (H, W, C) order
        h = torch.cat([x, d, m], dim=-1)
        return F.relu(F.linear(h, self.trunk.weight.to(dt), self.trunk.bias.to(dt)))


def lookups(image, direction, mission, dtype: torch.dtype, tables):
    """The encoder's lookups as ``nn.Embedding``'s composition: the
    ``(B, V, V, 24)`` plane features (ids clamped to each vocabulary), the
    ``(B, 16)`` direction features and the ``(B, 32)`` mission bag (codes
    clamped), in ``dtype``.  Each value is looked up in float32 and rounded
    once to ``dtype``; each bag product ``tok x code_pos`` is rounded to
    ``dtype``, and the 48 summed in float32 and rounded once."""
    *planes, w_dir, w_code, pos = tables
    img = image.long()
    x = torch.cat(
        [
            F.embedding(img[..., c].clamp(0, vocab - 1), w)
            for c, (vocab, w) in enumerate(zip(PLANE_VOCABS, planes))
        ],
        dim=-1,
    ).to(dtype)
    d = F.embedding(direction.long(), w_dir).to(dtype)
    codes = mission.long().clamp(0, w_code.shape[0] - 1)
    tok = F.embedding(codes, w_code).to(dtype)
    m = (tok * pos.to(dtype)).sum(dim=-2)
    return x, d, m


class EmbedKernel(torch.autograd.Function):
    """The lookups on a CUDA device: the forward :func:`embed_kernel`, the
    backward :func:`embed_grad_kernel`, in the autograd engine's thread for
    the device, under the tracing context of the thread that ran the
    forward (so ``nets.embed.grad`` nests where the backward was asked
    for).  ``apply(image, direction, mission, dtype, *tables)`` gives what
    :func:`lookups` gives."""

    @staticmethod
    def forward(ctx, image, direction, mission, dtype, *tables):
        image, direction, mission = _kernel_inputs(image, direction, mission, tables[4].shape[0])
        ctx.save_for_backward(image, direction, mission, *tables)
        ctx.dtype, ctx.trace = dtype, profiling.context()
        return embed_kernel(image, direction, mission, dtype, tables)

    @staticmethod
    def backward(ctx, g_planes, g_dir, g_bag):
        image, direction, mission, *tables = ctx.saved_tensors
        with profiling.adopt(ctx.trace):
            grads = embed_grad_kernel(image, direction, mission, g_planes, g_dir, g_bag,
                                      ctx.dtype, tables)
        return (None,) * 4 + grads


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}  # csrc/embed.cu's instance flag


class _FwdArgs(ctypes.Structure):
    """``csrc/embed.cu``'s ``FwdArgs``, field for field."""

    _fields_ = [
        *((n, ctypes.c_void_p) for n in ("image", "direction", "mission", "plane_w0", "plane_w1",
                                         "plane_w2", "dir_w", "code_w", "pos_w", "planes",
                                         "dir_out", "bag")),
        *((n, ctypes.c_int64) for n in ("dir_stride", "mission_row", "mission_slot")),
        *((n, ctypes.c_int32) for n in ("B", "cells", "vocab")),
    ]


class _GradArgs(ctypes.Structure):
    """``csrc/embed.cu``'s ``GradArgs``, field for field."""

    _fields_ = [
        *((n, ctypes.c_void_p) for n in ("image", "direction", "mission", "g_planes", "g_dir",
                                         "g_bag", "code_w", "pos_w", "partials", "grad_plane0",
                                         "grad_plane1", "grad_plane2", "grad_dir", "grad_code",
                                         "grad_pos")),
        *((n, ctypes.c_int64) for n in ("dir_stride", "mission_row", "mission_slot", "g_dir_row",
                                        "g_bag_row")),
        *((n, ctypes.c_int32) for n in ("B", "cells", "vocab")),
    ]


@functools.cache
def _embed_lib():
    """``csrc/embed.cu``, built and loaded at its first call: (the forward's
    entry, the backward's, the floats of its scratch for B rows); raises
    if its argument structs are not their mirrors' sizes."""
    lib = _kernels.library("embed")
    for fn, mirror in (("embed_args_bytes", _FwdArgs), ("embed_grad_args_bytes", _GradArgs)):
        if getattr(lib, fn)() != ctypes.sizeof(mirror):
            raise RuntimeError(f"csrc/embed.cu's {fn}() is {getattr(lib, fn)()}, its mirror "
                               f"{ctypes.sizeof(mirror)}")
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return (_kernels.entry("embed", "embed_launch", argtypes),
            _kernels.entry("embed", "embed_grad_launch", argtypes),
            _kernels.entry("embed", "embed_grad_scratch", [ctypes.c_int, ctypes.c_int]))


def _kernel_inputs(image, direction, mission, vocab: int):
    """The ids as the kernels read them: the image uint8 and contiguous,
    the direction and the codes int32 in any layout (the port's
    observation already is; other integer types are converted, the codes
    clamped first)."""
    if image.dtype != torch.uint8:
        image = image.clamp(0, 255).to(torch.uint8)
    if direction.dtype != torch.int32:
        direction = direction.to(torch.int32)
    if mission.dtype != torch.int32:
        mission = mission.clamp(0, vocab - 1).to(torch.int32)
    return image.contiguous(), direction, mission


def table_shapes(vocab: int) -> tuple:
    """The six tables' shapes at a mission vocabulary of ``vocab``."""
    return (*((n, PLANE_FEATURES) for n in PLANE_VOCABS), (NUM_DIRS, DIR_FEATURES), (vocab, CODE_FEATURES),
            (MISSION_SLOTS, CODE_FEATURES))


def _check(who: str, image, strided: dict, dtype: torch.dtype, contiguous: dict) -> None:
    """Raise unless ``image`` lies on a CUDA device and is (B, V, V, 3),
    ``dtype`` is bf16 or float32, each ``label: (x, dtype, shape)`` of
    ``strided`` is on that device with that dtype and shape (any strides)
    and each of ``contiguous`` passes ``_kernels.check``."""
    dev = image.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: the image is on {dev}, not a CUDA device")
    if dtype not in _DTYPES:
        raise ValueError(f"{who}: compute dtype {dtype}, want bfloat16 or float32")
    b, v = image.shape[0], image.shape[1]
    _kernels.check(who, dev, {"image": (image, torch.uint8, (b, v, v, 3)), **contiguous})
    for label, (x, want, shape) in strided.items():
        if x.device != dev or x.dtype != want or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{who}: {label}: want {want} {tuple(shape)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def embed_kernel(image, direction, mission, dtype: torch.dtype, tables):
    """:func:`lookups` as one launch of ``csrc/embed.cu`` on the current
    stream (span ``nets.embed``, counter ``nets.embed.launches``): the
    uint8 ``(B, V, V, 3)`` image, int32 ``(B,)`` direction and int32
    ``(B, 48)`` codes (any strides) on a CUDA device, the six float32
    tables, ``dtype`` bf16 or float32.  Raises on any other input; there
    is no fallback."""
    b, vocab = image.shape[0], tables[4].shape[0]
    _check("embed_kernel", image,
           {"direction": (direction, torch.int32, (b,)),
            "mission": (mission, torch.int32, (b, MISSION_SLOTS))}, dtype,
           {f"table {k}": (w, torch.float32, shape)
            for k, (w, shape) in enumerate(zip(tables, table_shapes(vocab)))})
    dev, v = image.device, image.shape[1]
    planes = torch.empty((b, v, v, len(PLANE_VOCABS) * PLANE_FEATURES), dtype=dtype, device=dev)
    d = torch.empty((b, DIR_FEATURES), dtype=dtype, device=dev)
    m = torch.empty((b, CODE_FEATURES), dtype=dtype, device=dev)
    args = _FwdArgs(
        *(x.data_ptr() for x in (image, direction, mission, *tables, planes, d, m)),
        direction.stride(0), mission.stride(0), mission.stride(1), b, v * v, vocab,
    )
    with profiling.graph_span("nets.embed"):
        _kernels.launch(dev, _embed_lib()[0], ctypes.byref(args), _DTYPES[dtype])
    profiling.count("nets.embed.launches")
    return planes, d, m


def _rows(g: torch.Tensor) -> torch.Tensor:
    """``g`` (B, F) with unit column stride and 16-byte aligned rows, as the
    backward reads a quad of features (a slice of ``cat``'s gradient is)."""
    if g.stride(1) != 1 or (g.stride(0) * g.element_size()) % 16 or g.data_ptr() % 16:
        return g.contiguous()
    return g


def embed_grad_kernel(image, direction, mission, g_planes, g_dir, g_bag, dtype: torch.dtype,
                      tables):
    """The six tables' float32 gradients of :func:`lookups` as
    ``csrc/embed.cu``'s two launches on the current stream (span
    ``nets.embed.grad``, counter ``nets.embed.grad.launches``): the
    blocks' partials into scratch, then their sums in block order.  Takes
    the ids and tables as :func:`embed_kernel` does (it reads the codes'
    and ``code_pos``) and the outputs' gradients in ``dtype``."""
    w_code, pos = tables[4], tables[5]
    b, v, vocab = image.shape[0], image.shape[1], w_code.shape[0]
    g_planes, g_dir, g_bag = g_planes.contiguous(), _rows(g_dir), _rows(g_bag)
    shapes = table_shapes(vocab)
    _check("embed_grad_kernel", image,
           {"direction": (direction, torch.int32, (b,)),
            "mission": (mission, torch.int32, (b, MISSION_SLOTS)),
            "g_dir": (g_dir, dtype, (b, DIR_FEATURES)),
            "g_bag": (g_bag, dtype, (b, CODE_FEATURES))},
           dtype,
           {"g_planes": (g_planes, dtype, (b, v, v, len(PLANE_VOCABS) * PLANE_FEATURES)),
            "code_w": (w_code, torch.float32, shapes[4]), "pos_w": (pos, torch.float32, shapes[5])})
    dev = image.device
    _, grad_launch, scratch = _embed_lib()
    partials = torch.empty(scratch(b, vocab), device=dev)
    grads = tuple(torch.empty(shape, device=dev) for shape in shapes)
    args = _GradArgs(
        *(x.data_ptr() for x in (image, direction, mission, g_planes, g_dir, g_bag, w_code, pos,
                                 partials, *grads)),
        direction.stride(0), mission.stride(0), mission.stride(1), g_dir.stride(0), g_bag.stride(0),
        b, v * v, vocab,
    )
    with profiling.graph_span("nets.embed.grad"):
        _kernels.launch(dev, grad_launch, ctypes.byref(args), _DTYPES[dtype])
    profiling.count("nets.embed.grad.launches", 2)
    return grads


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
