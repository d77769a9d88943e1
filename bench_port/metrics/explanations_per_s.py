"""Explanations completed over the whole window's wall, which runs whole
calls."""

UNIT = "expl/s"


def read(rec):
    if rec.get("entry") != "explain_many" or rec["window_s"] <= 0:
        return None
    return rec["explanations"] / rec["window_s"]
