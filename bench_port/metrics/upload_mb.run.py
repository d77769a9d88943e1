"""The program's ``upload_bytes`` counter under a ``run.request``, summed over
its spans, / 1e6 a request, recorded after the profiled slice."""

from bench_port import spans

UNIT = "MB"
LAYER = "explain/explainer.py host"
MOVES = "explain_p50_s"

read = spans.READINGS["upload_mb.run"]
