"""90th percentile latency, ms, of the traced window's requests after its
profiled slice (the profiler and the synchronising phase timers slow the
requests inside it)."""

import numpy as np

UNIT = "ms"
LAYER = "whole step"
MOVES = "explain_p50_s"


def read(rec):
    lat = rec.get("latencies_s") or []
    p = rec.get("profile")
    lat = lat[p["calls"]:] if p else lat
    return 1000.0 * float(np.percentile(lat, 90)) if lat else None
