"""100 x (1 - union of the card's kernel and copy intervals / the profiled
window), from torch.profiler."""

UNIT = "%"
LAYER = "device"
MOVES = "explain_p50_s"


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
