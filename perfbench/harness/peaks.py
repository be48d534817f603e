"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W), the yardstick of every roofline
and utilization share."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# the peak of an operation by its inputs' type (torch dtype names)
FLOP_PER_S = {"bfloat16": BF16_FLOP_PER_S, "float16": BF16_FLOP_PER_S,
              "float32": F32_FLOP_PER_S}


def bound_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory's rate and the operations at the inputs' peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)
