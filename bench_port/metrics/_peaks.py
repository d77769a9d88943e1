"""Published peaks of the cards a run may land on (NVIDIA's data sheet,
SXM part, dense, at the full 700 W power limit)."""

FP32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


def fp32_peak(kind: str):
    """The float32 peak (outside the tensor cores) of the card ``kind``,
    or None for a card the table lacks."""
    return FP32_FLOPS.get(kind)
