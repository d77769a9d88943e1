"""Self milliseconds of the program's ``plan.stack`` span (the dense ``[Q, n, n]`` fill) a
``many.call``, recorded after the profiled slice."""

from bench_port import spans

UNIT = "ms"
LAYER = "explain/batch.py launch plan"
MOVES = "explanations_per_s"

read = spans.READINGS["plan_stack_ms.many"]
