"""100 x the card's idle seconds in the profiled slice that no span of the
program below ``run.request`` covers / the card's idle seconds there."""

from bench_port import spans

UNIT = "%"
LAYER = "device"
MOVES = "explain_p50_s"

read = spans.READINGS["idle_unnamed_pct.run"]
