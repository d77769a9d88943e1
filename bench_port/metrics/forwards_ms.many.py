"""PhaseTimer phase forwards of _explain_many (the dense stacked forwards),
ms a call."""

UNIT = "ms"
LAYER = "models dense forwards"
MOVES = "explanations_per_s"


def read(rec):
    ph, n = rec.get("phases_s"), rec.get("calls")
    if not ph or not n or not all(k in ph for k in ("forwards",)):
        return None
    return 1000.0 * sum(ph[k] for k in ("forwards",)) / n
