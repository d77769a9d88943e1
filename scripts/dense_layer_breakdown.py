#!/usr/bin/env python3
"""Where the time of the fused dense layers' aggregation goes, on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/dense_layer_breakdown.py

It builds variants of ``ops/csrc/masked_gcn_layer.cu`` of the PyTorch port
with parts of the aggregation kernel removed (the epilogue, the epilogue's
loads, its stores, the products), times each against the kernel as it is at
the bench's subgraph shape (N = 2048, B = 250, C = 128; the same inputs as
``chip_smoke.py``'s dense phase), in turns, and prints the milliseconds of
each.  The variants compute wrong outputs and exist only here; the port
never loads them.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each variant: the source text to replace and what replaces it (cols > 0
# in every launch, so a branch on cols < 0 keeps code that never runs)
EPILOGUE = "      finish_tile<PER_SAMPLE>(d0, d1, v0, j0, n0, e);\n"
PRODUCTS = (
    "          wgmma_m64n128k16(d0, da + 2 * kk, db + 2 * kk);\n"
    "          // rows 64 .. 127 of the A tile: 64 rows of 128 bytes further\n"
    "          wgmma_m64n128k16(d1, da + (64 * 128 >> 4) + 2 * kk, db + 2 * kk);\n"
)
LOADS = (
    "          sv[k] = __ldg(e.s + row);\n"
    "          sw[k] = __ldg(e.self_w + row);\n"
    "          const float* xr = e.xw + (PER_SAMPLE ? row : vr[k]) * c + ch;\n"
    "#pragma unroll\n"
    "          for (int ii = 0; ii < 4; ++ii) x[ii][k] = __ldg(reinterpret_cast<const float2*>(xr + 8 * ii));\n"
)
STORE = "          *reinterpret_cast<float2*>(orow + 8 * ii) = make_float2(o0, o1);\n"
NO_EPILOGUE = (EPILOGUE, "      if (e.cols < 0) " + EPILOGUE.lstrip())
VARIANTS = {
    "kernel": [],
    "no epilogue": [NO_EPILOGUE],
    "epilogue without its loads": [
        (LOADS, "          sv[k] = 1.0f;\n"
                "          sw[k] = 0.5f;\n"
                "#pragma unroll\n"
                "          for (int ii = 0; ii < 4; ++ii) x[ii][k] = make_float2(1.0f, 2.0f);\n")
    ],
    "epilogue without its stores": [
        (STORE, "          if (o0 == 123.456f) " + STORE.lstrip())
    ],
    "loads only (no products, no epilogue)": [
        NO_EPILOGUE,
        (PRODUCTS, "          if (e.cols < 0) wgmma_m64n128k16(d0, da, db);\n"),
    ],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dense_layer_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from bikg_graph_explainability_public_tpu_torch.ops import cuda_build as cb
    from bikg_graph_explainability_public_tpu_torch.ops import gcn_layer_cuda as g

    cs.phase_header()
    src = open(os.path.join(cb.CSRC, "masked_gcn_layer.cu")).read()
    out_dir = os.path.join(os.path.dirname(cb.BUILD_DIR), "dense_layer_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is not in the source once")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    fns = {}
    for i, (name, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} does not build:\n{err[-3000:]}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"v{i}.so")).masked_gcn_agg
        fn.argtypes = g._AGG_ARGS
        fn.restype = ctypes.c_int
        fns[name] = fn

    class Variant:
        symbol = "masked_gcn_agg"

        def __init__(self, fn):
            self.fn = fn

        def launch(self, *args):
            rc = self.fn(*args)
            if rc:
                raise RuntimeError(f"variant launch failed: cudaError {rc}")

    dev = torch.device("cuda", 0)
    x = cs._dense_case(dev, cs.SUB_N, cs.SUB_E, cs.SUB_B, cs.HIDDEN, cs.HIDDEN, seed=2)
    a, s, sw, bias = x["adj16"], x["s"], x["self_w"], x["bias"]
    dense_ops = 2 * cs.SUB_N ** 2 * cs.SUB_B * cs.HIDDEN
    for per_sample in (False, True):
        xw = torch.matmul(x["h"], x["w_t"]) if per_sample else x["xw"]
        st = g.scaled_operand_plain(s, xw)
        names = list(fns)
        ms = {name: [] for name in names}
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                k = Variant(fns[name])
                ms[name].append(cs.cuda_ms(
                    lambda: g._aggregate(k, a, st, xw, s, sw, bias, True, per_sample), 20))
        layer = "2.2 (per-sample operand)" if per_sample else "2.1 (shared operand)"
        for name in names:
            best = min(ms[name])
            print(f"aggregation of {layer}, {name}: {best:.4f} ms "
                  f"({dense_ops / best / 1e9:.1f} dense bf16 TFLOP/s); all runs "
                  f"{[round(v, 4) for v in ms[name]]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
