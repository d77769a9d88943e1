"""Median latency of every request of the window (host clock, ending in a
synchronise)."""

import numpy as np

UNIT = "s"


def read(rec):
    lat = rec.get("latencies_s")
    return float(np.percentile(lat, 50)) if lat else None
