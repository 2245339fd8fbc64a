"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), the yardstick of every roofline
share in this benchmark."""

BYTES_PER_S = 3.35e12  # HBM3
# Float32 operations outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two, and a multiply or a max is one operation.
F32_OPS_PER_S = 67e12 / 2


def least_seconds(nbytes: int, ops: int) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory rate and the operations over their rate."""
    return max(nbytes / BYTES_PER_S, ops / F32_OPS_PER_S)
