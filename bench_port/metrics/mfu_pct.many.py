"""Useful float32 operations (metrics/_opcount.py) of the explanations inside
the profiled window / (window x the card's float32 peak)."""

from bench_port.metrics import _peaks

UNIT = "%"
LAYER = "whole step"
MOVES = "explanations_per_s"


def read(rec):
    p = rec.get("profile")
    peak = _peaks.fp32_peak(rec.get("device_kind", ""))
    if not p or not peak or p["window_s"] <= 0 or not p["useful_flops"]:
        return None
    return 100.0 * p["useful_flops"] / (p["window_s"] * peak)
