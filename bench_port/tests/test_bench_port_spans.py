"""The split of the card's idle time among the program's spans, and the
span readers, on hand-made intervals and records."""

from __future__ import annotations

import numpy as np
import pytest

from bench_port import spans

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
