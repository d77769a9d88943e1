"""The control, the plain reference in TF32 put in the program's place,
comes out not correct: each cell's limit lies between the program's
reading and the control's, here at a size a test run holds (on the card
the same readings are taken at the cells' own size by
``python3 -m bench_port.control``)."""

from __future__ import annotations

import pytest

from bench_port import run
from bench_port.registry import Registry

CELLS = [w["name"] for w in Registry().bench["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(tiny_bench, cell):
    ctx = run.Context(tiny_bench, cell, 2**31 + 33, "cpu")
    traffic = dict(ctx.traffic, warmup_calls=0, warmup_rounds=0)
    driver = tiny_bench.driver(traffic["entry"]).Driver(ctx, traffic)
    driver.setup()
    driver.window(0.5, False)
    sample = driver.sample()
    limits = tiny_bench.limits(cell)
    program = driver.compare(sample)
    control = driver.compare(sample, control=True)
    for name in ("score_gap", "score_gap_p99"):
        assert program[name] <= float(limits[name]) < control[name], (name, program, control)
