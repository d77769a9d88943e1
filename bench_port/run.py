"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m bench_port.run --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA init, the graph and the program's objects, weights
from ``--seed`` on the card, the subgraph classes, warm-up calls) is timed
by part and printed on standard error; then whole calls run for
``--seconds``; then the peak memory is read, the program's state freed,
and a sample of the window's answers recomputed by the plain reference.
The last line of standard output is one JSON object; the numbers compared
with the reference are the last lines of standard error and the last key
of that object.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys
import time


def _process_start() -> float:
    """Seconds since this process started, by ``/proc`` where it exists."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "bikg_graph_explainability_public_tpu"}
# build, kernel and subgraph-size caches: fixed paths inside the checkout
CACHE_DIR = os.path.join(CHECKOUT, "build", "bench_port")


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


class Context:
    """Everything a cell's driver reads: the registry's pieces, the graph,
    the weights, the device, the seed, the cache directory, and the set-up
    clock by part."""

    cache_dir = CACHE_DIR

    def __init__(self, reg, workload: str, seed: int, device):
        import torch

        self.parts = {}
        self.reg = reg
        self.workload = reg.workload(workload)
        self.cfg = reg.config(self.workload["config"])
        self.traffic = reg.traffic(self.workload["traffic"])
        self.model_cfg = self.cfg["model"]
        self.family = reg.family(self.model_cfg["family"])
        self.ref_family = reg.reference_family(self.model_cfg["family"])
        self.seed = int(seed)
        self.device = torch.device(device)
        from bench_port import graphgen

        with self.part("graph"):
            self.gg = graphgen.generate(self.cfg["graph"])
            self.edges = self.gg.merged_edges()
            self.etype = self.family.edge_types(self.gg, self.model_cfg)
        with self.part("weights"):
            self.params = make_weights(self.family.param_specs(self.model_cfg), self.seed,
                                       self.device)

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t


def make_weights(specs, seed: int, device):
    """Every parameter ``U(-limit, limit)`` from one draw on ``device`` by a
    generator seeded with ``seed``, float32 as served."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, limit in specs:
        k = math.prod(shape)
        out[name] = (flat[at : at + k] * limit).reshape(shape).contiguous()
        at += k
    return out


def power_limit_w(dev):
    """The card's power limit in watts, as ``nvidia-smi`` reads it, or None."""
    import subprocess

    visible = [v for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if v]
    i = dev.index or 0
    query = ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", visible[i] if i < len(visible) else str(i)]
    try:
        out = subprocess.run(query, capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(reg, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float = None):
    """Set up, run the window, compare: ``(result dict, checks)``."""
    import torch

    t_start = T0 if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda":
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=dev)
        kind = torch.cuda.get_device_name(dev)
        cuda_init = time.perf_counter() - t
    else:
        kind, cuda_init = "cpu", 0.0
    ctx = Context(reg, workload, seed, dev)
    ctx.parts["cuda_init"] = cuda_init
    driver = reg.driver(ctx.traffic["entry"]).Driver(ctx, ctx.traffic)
    driver.setup()
    with ctx.part("gc"):
        # set-up's garbage is collected here, not in the window, and what
        # set-up keeps is left out of the window's collections
        gc.collect()
        gc.freeze()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    ctx.parts["imports"] = setup_s - sum(ctx.parts.values())
    print("setup parts (s): " + json.dumps({k: round(v, 4) for k, v in ctx.parts.items()}),
          file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = driver.window(seconds, trace)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if rec.get("call_s"):
        print("call seconds: " + json.dumps([round(c, 4) for c in rec["call_s"]]), file=sys.stderr)
    rec.update(setup_s=setup_s, device_kind=kind)

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics_of(ctx.workload["name"], kind_key):
        val = reg.metric(m["name"]).read(rec)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        # the float32 peak of metrics/_peaks.py holds at the full 700 W
        device_info["power_limit_w"] = power_limit_w(dev)
    prof = rec.get("profile")
    if prof:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])

    driver.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = reg.limits(ctx.workload["name"])
    t = time.perf_counter()
    sample = driver.sample()
    numbers = driver.compare(sample)
    print(f"reference: {len(sample)} answers in {time.perf_counter() - t:.2f} s", file=sys.stderr)
    correct = (rec["failed"] == 0 and rec["explanations"] > 0
               and all(v <= float(limits[k]) for k, v in numbers.items()))
    # a number that is not finite (the program's scores were not) prints as null
    checks = {k: {"value": v if math.isfinite(v) else None, "limit": float(limits[k])}
              for k, v in numbers.items()}
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics, "device": device_info}
    if prof:
        result["breakdown"] = {"device_ops": [[n, s] for n, s in prof["device_ops"]],
                               "idle_gaps": [[n, s] for n, s in prof["idle_gaps"]]}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from bench_port.registry import Registry

    reg = Registry(benchmark=os.path.join(os.getcwd(), "BENCHMARK.json"))
    chips = int(reg.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0")
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}, which the benchmark may not import", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
