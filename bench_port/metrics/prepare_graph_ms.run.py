"""Self milliseconds of the program's ``prepare_graph`` span (the graph rebuilt
and uploaded) a ``run.request``, recorded after the profiled slice."""

from bench_port import spans

UNIT = "ms"
LAYER = "explain/explainer.py host"
MOVES = "explain_p50_s"

read = spans.READINGS["prepare_graph_ms.run"]
