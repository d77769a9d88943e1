"""Published peaks of the cards a run may land on (NVIDIA's data sheet,
SXM part, dense, at the full 700 W power limit).  Each function returns
None for a card its table lacks."""

H100 = "NVIDIA H100 80GB HBM3"

FP32_FLOPS = {H100: 67e12}
TF32_TENSOR_FLOPS = {H100: 494.7e12}
BF16_TENSOR_FLOPS = {H100: 989.4e12}
HBM_BYTES_PER_S = {H100: 3.35e12}


def fp32_peak(kind: str):
    """The float32 peak (outside the tensor cores) of the card ``kind``."""
    return FP32_FLOPS.get(kind)


def tf32_tensor_peak(kind: str):
    """The TF32 tensor-core peak of the card ``kind``."""
    return TF32_TENSOR_FLOPS.get(kind)


def bf16_tensor_peak(kind: str):
    """The bfloat16 tensor-core peak of the card ``kind``."""
    return BF16_TENSOR_FLOPS.get(kind)


def hbm_peak(kind: str):
    """The HBM bandwidth, bytes a second, of the card ``kind``."""
    return HBM_BYTES_PER_S.get(kind)
