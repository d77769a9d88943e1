"""Process start to the first timed call: imports, CUDA init, graph, weights,
strata, warm-up."""

UNIT = "s"


def read(rec):
    return rec.get("setup_s")
