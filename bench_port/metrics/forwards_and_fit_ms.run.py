"""Explainer diagnostics phase_seconds surrogate_training (forwards, kernel,
Adam), mean ms a request."""

UNIT = "ms"
LAYER = "models plan forwards and explain/wlm.py"
MOVES = "explain_p50_s"


def read(rec):
    ph, n = rec.get("phases_s"), rec.get("requests")
    if not ph or not n or not all(k in ph for k in ("surrogate_training",)):
        return None
    return 1000.0 * sum(ph[k] for k in ("surrogate_training",)) / n
