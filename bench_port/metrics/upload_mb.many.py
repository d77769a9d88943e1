"""The program's ``upload_bytes`` counter under a ``many.call``, summed over its
spans, / 1e6 a call, recorded after the profiled slice."""

from bench_port import spans

UNIT = "MB"
LAYER = "explain/batch.py launch plan"
MOVES = "explanations_per_s"

read = spans.READINGS["upload_mb.many"]
