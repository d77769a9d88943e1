"""Self milliseconds of the program's ``plan.upload`` span (the plan's pinned
copies) a ``many.call``, recorded after the profiled slice."""

from bench_port import spans

UNIT = "ms"
LAYER = "explain/batch.py launch plan"
MOVES = "explanations_per_s"

read = spans.READINGS["plan_upload_ms.many"]
