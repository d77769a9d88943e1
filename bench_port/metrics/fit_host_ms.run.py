"""Self milliseconds of the program's ``fit`` span (``shap_kernel``, the
surrogate's Adam loop) a ``run.request``, recorded after the profiled slice."""

from bench_port import spans

UNIT = "ms"
LAYER = "models plan forwards and explain/wlm.py"
MOVES = "explain_p50_s"

read = spans.READINGS["fit_host_ms.run"]
