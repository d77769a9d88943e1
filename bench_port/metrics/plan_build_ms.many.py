"""PhaseTimer phases plan_build and mask_draw of _explain_many, ms a call
(traced run; the timer synchronises)."""

UNIT = "ms"
LAYER = "explain/batch.py launch plan"
MOVES = "explanations_per_s"


def read(rec):
    ph, n = rec.get("phases_s"), rec.get("calls")
    if not ph or not n or not all(k in ph for k in ("plan_build", "mask_draw")):
        return None
    return 1000.0 * sum(ph[k] for k in ("plan_build", "mask_draw")) / n
