#!/usr/bin/env python3
"""``chip_smoke.py``'s ``explain_many`` phase for two or more checkouts of
the PyTorch port, in turns on one card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/explain_many_turns.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is the root of a checkout (this one is ``.``).  Each run is a
process of its own that imports that checkout's package and its
``chip_smoke.py`` and calls its ``phase_explain_many``: the 36-node
fixture, then bench.py's explanation workload (20k / 160k, GCN-128, 16
queries) in Shapley and community mode, each held against the CPU.  The
phase launches no hand kernel, so nothing is built.  Each run prints a line
naming its ROOT, the phase's own lines, and the card's name and power
limit.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def child(root: str) -> int:
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs

    with open(os.path.join(root, "config", "configs.json")) as f:
        config = json.load(f)
    print(f"== {root}", flush=True)
    cs.phase_explain_many(torch.device("cuda", 0), config)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"== {root}: {smi}", flush=True)
    return 0


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        return child(os.path.abspath(sys.argv[2]))
    if not torch.cuda.is_available():
        print("explain_many_turns: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
