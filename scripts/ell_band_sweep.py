#!/usr/bin/env python3
"""The band walk of kernels 2.6/2.7 (``ops/csrc/spmm_ell_weighted.cu`` of
the PyTorch port) swept on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/ell_band_sweep.py

It times the kernel at the production shape of ``chip_smoke.py``'s ladder
(100k nodes / 1M edges, K = 32, B = 50, F = 128, float32, the same seeded
inputs) with the bands and work-item sizes of ``PLANS``, with static and
broadcast weights (the modes that take the band walk).  Each plan's output
is first held equal to the port's own call, bit for bit; the timings run in
turns (the list, then reversed, twice) and the best of the four is
printed, with the gather rate (the summed slots' source bytes over that
time).  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (band columns, passes of a warp over an item): 32 rows an item, and 16 at
#: the chosen 64 columns
PLANS = ((32, 8), (48, 16), (64, 16), (64, 8))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ell_band_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc
    from bikg_graph_explainability_public_tpu_torch.ops.ell import build_neighbor_table

    cs.phase_header()
    dev = torch.device("cuda", 0)
    feat, ei, _ = cs.random_graph(cs.BIG_N, cs.BIG_E, seed=0)
    table = build_neighbor_table(from_arrays(feat, ei, device=dev))
    b = cs.BIG_B
    feats, weights, _, _ = cs.ladder_inputs(table, b, cs.HIDDEN, torch.float32, 7)
    valid = table.valid > 0
    for mode in ("static", "broadcast"):
        w_slot = weights[mode]
        want = sc.spmm_ell_weighted(table, w_slot, feats, b)
        if mode == "static":
            read = int(valid.sum()) * feats.shape[1]
        else:
            read = int(((w_slot[..., 0] != 0) & valid).sum()) * feats.shape[1]
        calls = {}
        for band, passes in PLANS:
            calls[f"band={band} passes={passes}"] = (
                lambda band=band, passes=passes: sc._weighted_launch(
                    sc.SPMM_ELL_WEIGHTED["v3"], table, w_slot, feats, b, band, passes))
        for name, call in calls.items():
            if not torch.equal(torch.nan_to_num(call(), nan=7.0), torch.nan_to_num(want, nan=7.0)):
                raise AssertionError(f"{mode} {name}: differs from the port's call")
        names = list(calls)
        ms = {name: [] for name in names}
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                ms[name].append(cs.cuda_ms(calls[name], 20))
        for name in names:
            best = min(ms[name])
            print(f"{mode} {name}: {best:.4f} ms, gather {read * 4 / best / 1e6:.1f} GB/s; "
                  f"all runs {[round(v, 4) for v in ms[name]]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
