"""PhaseTimer phase kernel_weights_and_training of _explain_many, ms a call."""

UNIT = "ms"
LAYER = "explain surrogate"
MOVES = "explanations_per_s"


def read(rec):
    ph, n = rec.get("phases_s"), rec.get("calls")
    if not ph or not n or not all(k in ph for k in ("kernel_weights_and_training",)):
        return None
    return 1000.0 * sum(ph[k] for k in ("kernel_weights_and_training",)) / n
