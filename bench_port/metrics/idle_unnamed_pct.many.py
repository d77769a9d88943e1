"""100 x the card's idle seconds in the profiled slice that no span of the
program below ``many.call`` covers / the card's idle seconds there."""

from bench_port import spans

UNIT = "%"
LAYER = "device"
MOVES = "explanations_per_s"

read = spans.READINGS["idle_unnamed_pct.many"]
