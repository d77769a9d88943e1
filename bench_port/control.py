"""Readings that set a cell's limits: the program against the plain
reference (the sound readings), and the reference in TF32 against the same
reference (the control), on many seeds in one process.

    python3 -m bench_port.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control-seeds <k>]

Each seed makes new weights, a new program model and a new schedule, runs
the cell's entry for a short window at the cell's own load (whole calls),
and compares the sample a run compares; the control is read on the first
``k`` seeds (all by default).  One JSON line a seed.  The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first k seeds only")
    ap.add_argument("--self", action="store_true",
                    help="also the reference against a second run of itself")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch

    from bench_port import run
    from bench_port.registry import Registry

    reg = Registry(benchmark=os.path.join(os.getcwd(), "BENCHMARK.json"))
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        ctx = run.Context(reg, args.workload, seed, args.device)
        # no warm-up: the readings need answers, not steady timings
        traffic = dict(ctx.traffic, warmup_calls=0, warmup_rounds=0)
        driver = reg.driver(traffic["entry"]).Driver(ctx, traffic)
        driver.setup()
        rec = driver.window(args.seconds, False)
        driver.free()
        gc.collect()
        torch.cuda.empty_cache()
        sample = driver.sample()
        out = {"workload": args.workload, "seed": seed, "answers": len(sample),
               "explanations": rec["explanations"], "failed": rec["failed"],
               "program": driver.compare(sample)}
        out["program_gaps"] = driver.last_gaps
        if i < n_control:
            out["control"] = driver.compare(sample, control=True)
            out["control_gaps"] = driver.last_gaps
        if args.self:
            out["self"] = driver.compare(sample, control="self")
            out["self_gaps"] = driver.last_gaps
        out["subgraph_nodes"] = [int(driver.nodes[a["gene"]]) for a in sample]
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        del driver, ctx
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
