"""Request wall minus its mask_sampling and surrogate_training phases, mean
ms: graph build, subgraph, engine plans."""

UNIT = "ms"
LAYER = "explain/explainer.py host"
MOVES = "explain_p50_s"


def read(rec):
    ph, lat = rec.get("phases_s"), rec.get("latencies_s")
    if not ph or not lat:
        return None
    phases = ph.get("mask_sampling", 0.0) + ph.get("surrogate_training", 0.0)
    return 1000.0 * (sum(lat) - phases) / len(lat)
