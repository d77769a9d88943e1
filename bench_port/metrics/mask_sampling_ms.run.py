"""Explainer diagnostics phase_seconds mask_sampling, mean ms a request."""

UNIT = "ms"
LAYER = "explain/masks.py"
MOVES = "explain_p50_s"


def read(rec):
    ph, n = rec.get("phases_s"), rec.get("requests")
    if not ph or not n or not all(k in ph for k in ("mask_sampling",)):
        return None
    return 1000.0 * sum(ph[k] for k in ("mask_sampling",)) / n
