#!/usr/bin/env python3
"""The program's spans in the benchmark's cells, and what a span costs.

Run from the root of a checkout::

    python3 scripts/span_readings.py cost
    python3 scripts/span_readings.py cell --workload <name> --seed <n> --seconds <s>

``cost`` times loops of 100,000 spans: with nobody listening, inside a
recorder, and under ``torch.profiler``, and reads how far one span's
recorded start and duration lie from its profile event's; it prints one
JSON line.

``cell`` sets the cell up as ``python3 -m bench_port.run`` does and runs
its traced window (``--trace 1``), with the program's recorder opened when
the profiled slice ends, so that the host times come from the calls the
profiler does not slow, and closed with the window.  It prints one JSON
line: the readings of ``bench_port/spans.py``, the card's idle time split
among the spans in the profiled slice, every span's self milliseconds and
counters a call or request, the spans recorded a call or request, the
cell's per-layer metrics, and the p50 latency of the window after the
slice.  It skips the comparison with the reference.  It needs a CUDA card
(exit code 2 without one).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
N_SPANS = 100_000


def cost() -> dict:
    """Microseconds a span (enter and exit) in each listening state."""
    import torch

    from bench_port import trace
    from bikg_graph_explainability_public_tpu_torch.utils import profiling

    def per_span_us() -> float:
        t = time.perf_counter()
        for _ in range(N_SPANS):
            with profiling.span("x"):
                pass
        return (time.perf_counter() - t) / N_SPANS * 1e6

    def empty_us() -> float:
        t = time.perf_counter()
        for _ in range(N_SPANS):
            pass
        return (time.perf_counter() - t) / N_SPANS * 1e6

    out = {"loop_us": empty_us(), "off_us": per_span_us()}
    with profiling.recording() as rec:
        out["recorder_us"] = per_span_us()
    out["recorded"] = len(rec.spans)
    with trace.profiler():
        out["profiler_us"] = per_span_us()
    with trace.profiler(), profiling.recording():
        out["profiler_and_recorder_us"] = per_span_us()
    # one span under both: where its recorded start lies from its profile event's
    with trace.profiler() as prof, profiling.recording() as rec:
        with profiling.span("clock"):
            time.sleep(0.01)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "bikg.clock"]
    out["clock_start_gap_ns"] = rec.spans[0].start_ns - ev.start_ns()
    out["clock_duration_gap_ns"] = (rec.spans[0].end_ns - rec.spans[0].start_ns) - ev.duration_ns()
    out["torch"] = torch.__version__
    return out


def _slice_class():
    """``common.Slice`` that opens a recorder when its profiler stops and
    adds the spans and the idle split to its summary."""
    from bench_port import spans
    from bench_port.drivers import common
    from bikg_graph_explainability_public_tpu_torch.utils import profiling

    class SpanSlice(common.Slice):
        recorder = None
        _recording = None

        def stop(self) -> None:
            was = self.active
            super().stop()
            if was:
                self._recording = profiling.recording()
                self.recorder = self._recording.__enter__()

        def summary(self, calls, explanations, flops):
            if self._recording is not None:
                self._recording.__exit__(None, None, None)
            out = super().summary(calls, explanations, flops)
            if out is not None:
                out.update(spans.idle_split(self._prof) or {})
                if self.recorder is not None:
                    out["spans"] = spans.recorded(self.recorder)
                    out["n_spans"] = len(self.recorder.spans)
            return out

    return SpanSlice


def cell(reg, workload: str, seed: int, seconds: float, dev) -> dict:
    """The readings of one traced window of ``workload`` on ``dev``."""
    import torch

    from bench_port import run as brun
    from bench_port import spans
    from bench_port.drivers import common

    ctx = brun.Context(reg, workload, seed, dev)
    driver = reg.driver(ctx.traffic["entry"]).Driver(ctx, ctx.traffic)
    driver.setup()
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    common.Slice = _slice_class()
    rec = driver.window(seconds, True)
    gc.unfreeze()
    p = rec["profile"]
    sp = p.get("spans") or {"roots": {}, "by_span": {}}
    table = {}
    for root, n in sp["roots"].items():
        table[root] = {
            name: dict({"self_ms": 1000.0 * t["self_s"] / n, "calls": t["calls"] / n},
                       **{k: v / n for k, v in t.items()
                          if k not in ("calls", "total_s", "self_s")})
            for name, t in sorted(sp["by_span"][root].items(), key=lambda kv: -kv[1]["self_s"])
        }
    per_layer = {}
    for m in reg.metrics_of(workload, "per_layer"):
        v = reg.metric(m["name"]).read(rec)
        if v is not None:
            per_layer[m["name"]] = v
    lat = rec.get("latencies_s") or []
    after = lat[p["calls"]:]
    cuda = dev.type == "cuda"
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "power_limit_w": brun.power_limit_w(dev) if cuda else None, "torch": torch.__version__,
        "host_memory_stats": sorted(stats()) if stats and cuda else None,
        "readings": spans.readings(rec), "per_layer": per_layer,
        "window_s": p["window_s"], "busy_s": p["busy_s"],
        "idle_unnamed_s": p.get("idle_unnamed_s"), "idle_by_span": p.get("idle_by_span"),
        "idle_gaps": p["idle_gaps"], "profiled_calls": p["calls"],
        "recorded_roots": sp["roots"], "spans_recorded": p.get("n_spans"),
        "spans": table,
        "post_slice_p50_s": statistics.median(after) if after else None,
        "post_slice_requests": len(after), "call_s": rec.get("call_s"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("cost")
    c = sub.add_parser("cell")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if args.what == "cost":
        print(json.dumps(cost()), flush=True)
        return 0
    import torch

    from bench_port import run as brun
    from bench_port.registry import Registry

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    brun._caches()
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=dev)
    reg = Registry(benchmark=os.path.join(ROOT, "BENCHMARK.json"))
    print(json.dumps(cell(reg, args.workload, args.seed, args.seconds, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
