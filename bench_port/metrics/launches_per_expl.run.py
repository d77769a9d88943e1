"""Kernels the card ran in the profiled window / explanations completed in
it."""

UNIT = "launches"
LAYER = "device"
MOVES = "explain_p50_s"


def read(rec):
    p = rec.get("profile")
    if not p or not p["explanations"]:
        return None
    return p["kernels"] / p["explanations"]
