"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12


def bound_s(nbytes: float, mm_flops: float = 0.0,
            ew_flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth, the bf16 tensor products over their peak and the
    fp32 element-wise operations over theirs."""
    return max(nbytes / HBM_BYTES_PER_S, mm_flops / BF16_TENSOR_FLOPS,
               ew_flops / FP32_FLOPS)
