"""The split of the card's idle time among the program's spans, and the
span readers, on hand-made intervals and records; the recorder a traced
run opens after its profiled slice, and the readings it gives."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from bench_port import spans
from bench_port.metrics import _opcount
from bench_port.registry import Registry

CELLS = [w["name"] for w in Registry().bench["workloads"]]

MS = 1_000_000  # ns


def test_idle_is_split_by_overlap_among_nested_spans():
    # root [0, 100) ms > a [10, 60) > b [20, 30); c [70, 90) directly under the root
    tree = [(0, 100 * MS, "bikg.many.call"), (10 * MS, 60 * MS, "bikg.a"),
            (20 * MS, 30 * MS, "bikg.b"), (70 * MS, 90 * MS, "bikg.c")]
    # idle [5, 25) and [50, 80) and [95, 120): the last runs past every span
    gs = np.array([5, 50, 95]) * MS
    ge = np.array([25, 80, 120]) * MS
    by, unnamed = spans.split_idle(gs, ge, tree)
    assert by == pytest.approx({"bikg.a": 0.020, "bikg.b": 0.005, "bikg.c": 0.010})
    # root self time [5, 10) and [60, 70) and [95, 100), no span [100, 120)
    assert unnamed == pytest.approx(0.005 + 0.010 + 0.005 + 0.020)
    assert sum(by.values()) + unnamed == pytest.approx(((ge - gs).sum()) * 1e-9)


def test_idle_outside_every_span_is_unnamed():
    gs, ge = np.array([0]), np.array([10 * MS])
    assert spans.split_idle(gs, ge, []) == ({}, pytest.approx(0.010))
    by, unnamed = spans.split_idle(gs, ge, [(20 * MS, 30 * MS, "bikg.x")])
    assert by == {} and unnamed == pytest.approx(0.010)


def _record(roots, by_span, **profile):
    return {"profile": dict(spans={"roots": roots, "by_span": by_span}, **profile)}


def test_readers_take_totals_a_root():
    by = {"many.call": {
        "many.call": {"calls": 2, "total_s": 10.0, "self_s": 1.0, "plan_cache_misses": 4},
        "plan.stack": {"calls": 4, "total_s": 3.0, "self_s": 3.0, "stack_bytes": 8e9},
        "plan.upload": {"calls": 4, "total_s": 1.0, "self_s": 0.8, "upload_bytes": 10e9},
        "forwards": {"calls": 12, "total_s": 4.0, "self_s": 4.0},
    }}
    rec = _record({"many.call": 2}, by, window_s=10.0, busy_s=4.0, idle_unnamed_s=0.6)
    got = spans.readings(rec)
    assert got == pytest.approx({"plan_stack_ms.many": 1500.0, "plan_upload_ms.many": 400.0,
                                 "upload_mb.many": 5000.0, "idle_unnamed_pct.many": 10.0})


@pytest.mark.parametrize("record", [
    {}, {"profile": None}, {"profile": {"window_s": 5.0, "busy_s": 1.0}},
    _record({}, {}), {"phases_s": {"plan_build": 1.0}, "calls": 3},
])
def test_readers_return_nothing_on_a_record_without_spans(record):
    for name, read in spans.READINGS.items():
        assert read(record) is None, name
    assert spans.readings(record) == {}


def test_a_profile_and_a_recorder_give_the_split_and_the_totals():
    import time

    import torch

    from bench_port import trace
    from bikg_graph_explainability_public_tpu_torch.utils import profiling

    with trace.profiler() as prof, profiling.recording() as rec:
        with torch.profiler.record_function(trace.WINDOW):
            with profiling.span("run.request"):
                with profiling.span("prepare_graph"):
                    time.sleep(0.02)
                    profiling.count("upload_bytes", 3_000_000)
                time.sleep(0.01)
    split = spans.idle_split(prof)
    if torch.cuda.is_available():  # the card's own work is not idle
        assert sum(split["idle_by_span"].values()) > 0
    else:  # no card: the whole window is idle
        assert split["idle_by_span"]["bikg.prepare_graph"] == pytest.approx(0.02, abs=0.005)
        assert split["idle_unnamed_s"] == pytest.approx(0.01, abs=0.005)
    rec_totals = spans.recorded(rec)
    assert rec_totals["roots"] == {"run.request": 1}
    record = {"profile": dict(spans=rec_totals, window_s=0.04, busy_s=0.0, **split)}
    assert spans.readings(record)["upload_mb.run"] == pytest.approx(3.0)
    assert spans.readings(record)["prepare_graph_ms.run"] == pytest.approx(20, abs=5)


class _Clock:
    """A driver's clock that moves ``step`` seconds at each reading, so
    that a window holds the same calls however loaded the machine is."""

    def __init__(self, step: float):
        self.step = step
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


class _ClockedRegistry(Registry):
    """A registry whose drivers read :class:`_Clock` (the profiled slice
    and the run's set-up keep the real clock)."""

    def driver(self, entry: str):
        mod = super().driver(entry)
        mod.time = _Clock(0.1)
        return mod


@pytest.fixture
def traced_bench(tiny_bench, package_copy):
    """``tiny_bench`` over a copy of the harness whose traffic profiles only
    the first call or request, so that the recorder keeps the rest of the
    window, and whose ``explain_many`` calls are small; its drivers' clock
    gives a 1 s window four ``explain_many`` calls (a run cell's window is
    whole cycles of requests)."""
    for path in (package_copy / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["trace_seconds"] = 0
        if traffic["entry"] == "explain_many":
            traffic.update(queries_per_call=2, times=1, check_answers=4)
        path.write_text(json.dumps(traffic))
    return _ClockedRegistry(root=str(package_copy), benchmark=tiny_bench.benchmark_path)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_records_the_spans_after_its_profiled_slice(traced_bench, cell):
    from bench_port import run

    result, checks = run.run_cell(traced_bench, cell, 2**31 + 43, 1.0, True, "cpu")
    assert result["correct"], checks
    new = {m["name"] for m in traced_bench.bench["per_layer"] if m["name"] in spans.READINGS
           and cell in m["workloads"]}
    assert new and new <= set(result["metrics"])
    assert all(math.isfinite(result["metrics"][n]["value"]) for n in new)


@pytest.mark.parametrize("cell", CELLS)
def test_the_recorder_keeps_the_calls_after_the_profiled_slice(traced_bench, cell):
    """Only a traced window opens the recorder, after its profiled slice,
    and closes it with the window; the slice's work is in its record, and
    its count of operations is the GCN count of that work."""
    from bench_port import run
    from bikg_graph_explainability_public_tpu_torch.utils import profiling

    ctx = run.Context(traced_bench, cell, 2**31 + 45, "cpu")
    traffic = dict(ctx.traffic, warmup_calls=0, warmup_rounds=0)
    driver = traced_bench.driver(traffic["entry"]).Driver(ctx, traffic)
    driver.setup()
    untraced = driver.window(0.0, False)
    assert untraced["profile"] is None and profiling._recorder is None
    rec = driver.window(1.0, True)
    assert profiling._recorder is None
    p = rec["profile"]
    root = {"explain_many": "many.call", "explain_run": "run.request"}[traffic["entry"]]
    after = rec.get("calls", rec.get("requests")) - p["calls"]
    assert p["spans"]["roots"][root] == after > 0
    work = p["work"]
    assert len(work["queries"]) == p["explanations"] > 0
    ex = traffic["explain"]
    assert (work["rows"], work["epochs"], work["times"]) == (
        ex["interpret_samples"] * ex["epochs"], ex["epochs"], traffic["times"])
    assert p["useful_flops"] == sum(_opcount.explanation_flops(
        ctx.model_cfg, n, e, work["rows"], work["epochs"], work["times"])
        for n, e in work["queries"]) > 0
    assert set(p["device_op_s"]) >= {n for n, _ in p["device_ops"]}
