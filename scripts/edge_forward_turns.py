#!/usr/bin/env python3
"""The unrestricted ELL edge forward of two or more checkouts of the
PyTorch port, timed in turns on one card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/edge_forward_turns.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout (this one is ``.``).  Each run is a
process of its own that imports that checkout's package and its
``chip_smoke.py``, builds the kernels the forward launches into that
checkout's build directory, and drives ``chip_smoke.py``'s edge-forward
configuration: GCN-128x2 (seeded weights) on the 100k-node / 1M-edge graph,
1000 edge masks drawn on the card (70 % kept), chunks of 50, query row 17,
``FastBatchedGCN(restrict=False)``.  After one warm-up pass it times three
passes (host clock ending in a synchronize) and prints one JSON line per
run: the passes' seconds, the peak device memory of the last pass and the
launches of each kernel in it, with the card's name and power limit.
Without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PASSES = 3


def child(root: str) -> int:
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.models.fast_gcn import FastBatchedGCN

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    feat, ei, _ = cs.random_graph(cs.BIG_N, cs.BIG_E, seed=0)
    model, _ = cs.gcn_128x2(seed=0, device=dev)
    graph = from_arrays(feat, ei, device=dev)
    engine = FastBatchedGCN(model.model_def, graph, restrict=False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    masks = torch.rand((1000, graph.e_pad), generator=gen, device=dev) > 0.3
    masks[:, graph.num_edges:] = False

    def run():
        return engine.query_outputs(masks, cs.EDGE_QUERY, "edge_prediction", chunk_size=cs.BIG_B)

    out = run()  # builds the kernels
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{root}: non-finite outputs")
    walls = []
    for _ in range(PASSES):
        torch.cuda.reset_peak_memory_stats(dev)
        cs.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": root,
        "forwards_s": walls,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "launches": {k: v for k, v in cs.read_counts().items() if v},
        "output_sum": float(out.double().sum()),
        "card": smi,
    }), flush=True)
    return 0


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        return child(os.path.abspath(sys.argv[2]))
    if not torch.cuda.is_available():
        print("edge_forward_turns: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
