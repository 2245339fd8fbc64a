"""Inputs and tolerances for the encoder's lookups (``models/nets.py``),
shared by the CPU tests of ``nets.lookups`` and the card tests of
``csrc/embed.cu``.

The gradients of a table are float32 sums, and two ways of taking them
(autograd's ``nn.Embedding`` backward, the kernels' blocks) add the same
terms in another order.  Each order is within ``(n - 1) * 2**-24 * S`` of
the exact sum, where ``n`` is the number of terms an entry can have and
``S`` the sum of their magnitudes, so two orders are within twice that
(:func:`reorder_bound`).  Where a float32 sum is then rounded to bf16
(``code_pos``'s gradient, the mission bag), each rounding moves it by at
most half a unit in the last place of the larger result, so the two
rounded sums are within the float32 bound plus one such unit.  On dyadic
inputs (``inputs(..., dyadic=True)``: tables in 64ths, gradients in 16ths)
every term and every partial sum is exact in float32, so any order gives
the same sums, bit for bit.
"""

from __future__ import annotations

import torch

from minigrid_dynamicprogramming_tpu_torch.core.state import MISSION_SLOTS
from minigrid_dynamicprogramming_tpu_torch.models import nets

VOCAB = 64  # the encoder's mission vocabulary
U32 = 2.0 ** -24  # float32's unit roundoff


def inputs(b: int, view: int, dtype: torch.dtype, seed: int, dyadic: bool = False, device="cpu"):
    """``(ids, tables, grads)``: the image (ids up to 19, beyond every
    plane's vocabulary), direction and codes (from -3 to 69, outside the
    vocabulary on both sides) of ``b`` rows; the six float32 tables; a
    gradient in ``dtype`` for each of the three outputs."""
    g = torch.Generator().manual_seed(seed)
    ids = (
        torch.randint(0, 20, (b, view, view, 3), generator=g, dtype=torch.uint8),
        torch.randint(0, 4, (b,), generator=g, dtype=torch.int32),
        torch.randint(-3, VOCAB + 6, (b, MISSION_SLOTS), generator=g, dtype=torch.int32),
    )

    def draw(shape, dyadic_scale):
        if dyadic:
            return torch.randint(-dyadic_scale, dyadic_scale + 1, shape, generator=g) / dyadic_scale
        return torch.randn(shape, generator=g)

    tables = tuple(draw(shape, 64) for shape in nets.table_shapes(VOCAB))
    outs = ((b, view, view, 24), (b, nets.DIR_FEATURES), (b, nets.CODE_FEATURES))
    grads = tuple(draw(shape, 16).to(dtype) for shape in outs)
    return (tuple(x.to(device) for x in ids), tuple(t.to(device) for t in tables),
            tuple(x.to(device) for x in grads))


def composition_grads(ids, tables, grads, dtype):
    """The tables' gradients of ``nets.lookups`` by autograd: the
    composition the encoder ran before its lookups were one Function."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tables]
    return torch.autograd.grad(nets.lookups(*ids, dtype, leaves), leaves, grads)


def reorder_bound(ids, tables, grads, dtype):
    """Per entry, twice ``(n - 1) * 2**-24 * S`` (module docstring), with
    ``n`` the most terms an entry of the table can have, and ``S`` the
    magnitudes' sum, taken as the composition's gradients of the
    magnitudes.  ``code_pos``'s unit of bf16 rounding is added by
    :func:`assert_grads_close`, from the results."""
    image = ids[0]
    b, cells = image.shape[0], image.shape[1] * image.shape[2]
    scale = composition_grads(ids, [t.abs() for t in tables], [g.abs() for g in grads], dtype)
    terms = (b * cells,) * 3 + (b, b * MISSION_SLOTS, b)
    return [2 * (n - 1) * U32 * s for n, s in zip(terms, scale)]


def bag_bound(ids, tables, dtype, got, want):
    """How far two bags ``got`` and ``want`` may part: their 48 products
    summed in float32 in two orders (twice ``47 * 2**-24`` times the
    products' magnitudes), then each rounded to ``dtype`` (in bf16, one
    unit in the last place of the larger of the two results)."""
    scale = nets.lookups(*ids, dtype, [t.abs() for t in tables])[2].float()
    return 2 * (MISSION_SLOTS - 1) * U32 * scale + rounding(dtype, got, want)


def rounding(dtype, got, want):
    """One unit in the last place of the larger of ``got`` and ``want`` where
    ``dtype`` is bf16 (two float32 sums each rounded to it); 0 in float32."""
    if dtype != torch.bfloat16:
        return torch.zeros_like(got, dtype=torch.float32)
    return bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 at ``|x|`` (2**-133 at zero)."""
    e = torch.frexp(x.abs().float().clamp(min=2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def assert_grads_close(got, want, bounds, dtype, what: str = "") -> None:
    """Each of the six gradients within its bound of ``bounds``;
    ``code_pos``'s, rounded to bf16 where ``dtype`` is, within one more
    unit of the larger result."""
    names = ("plane 0", "plane 1", "plane 2", "direction", "codes", "code_pos")
    for name, a, b, tol in zip(names, got, want, bounds):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, (what, name)
        if name == "code_pos":
            tol = tol + rounding(dtype, a, b).to(tol.device)
        excess = (a - b).abs() - tol
        assert float(excess.max()) <= 0, (what, name, float((a - b).abs().max()))
