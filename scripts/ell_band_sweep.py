#!/usr/bin/env python3
"""The band walk of the static ELL gather-sums (``ops/csrc/ell_band.cuh`` of
the PyTorch port) swept on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/ell_band_sweep.py

It times the walk at the production shape of ``chip_smoke.py``'s ladder
(100k nodes / 1M edges, K = 32, B = 50, F = 128, float32, the same seeded
inputs) with the bands and work-item sizes of ``PLANS``, in four modes: the
valid-prefix sum (kernel 2.5, ``ell_valid_sum``), the same with the output
scale (kernel 2.3, ``gather_sum_static``), and kernel 2.6's static and
broadcast weights.  Each plan's output is first held equal to the port's
own call, bit for bit; the timings run in turns (the list, then reversed,
twice) and the best of the four is printed, with the gather rate (the
summed slots' source bytes over that time).

Then the bulk-copy variant (``VARIANT``): the valid sum and the scaled sum
built from a copy of the header in which each row's whole segment of a
slot (256 bytes) comes in by one ``cp.async.bulk``, completed on an
``mbarrier``, in place of 16 lanes' 16-byte ``cp.async``; held bit for bit
against the port's call and timed in turns with it, at the default plan.
Without CUDA it exits with code 2.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (band columns, passes of a warp over an item): 32 rows an item, and 16 at
#: the chosen 64 columns
PLANS = ((32, 8), (48, 16), (64, 16), (64, 8))

_BULK_HELPERS = r"""
// The bulk-copy variant: one lane of a row's group copies each slot's
// segment (the group's active lanes x 16 bytes) with cp.async.bulk onto the
// group's mbarrier; the group waits on its phase, then adds the landed
// segments as the cp.async path does.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(a), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(done) : "r"(a), "r"(parity) : "memory");
  return done != 0;
}

// A wait that lasts seconds means a broken pipeline: trap (a launch error)
// instead of hanging.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!bar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void sum_row_bulk(float* acc, const T* __restrict__ feats, int64_t w,
                                             int64_t c0, const int32_t* rn, int d, uint4* gather,
                                             uint64_t* bar, uint32_t& phase, int lane, int lrow,
                                             int lanes, int act) {
  using L = Lane<T, VEC>;
  const unsigned mask = (act == 32 ? 0xffffffffu : ((1u << act) - 1u)) << (lrow * lanes);
  const uint32_t seg = static_cast<uint32_t>(act) * 16u;
  uint4* dst0 = gather + lrow * lanes;
  for (int jj = 0; jj < d; jj += kBatch) {
    const int nb = min(d - jj, kBatch);
    __syncwarp(mask);  // the group has read the last batch's segments
    if (lane == lrow * lanes) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_expect(bar + lrow, static_cast<uint32_t>(nb) * seg);
      for (int u = 0; u < nb; ++u) {
        bulk_copy(dst0 + u * 32, feats + static_cast<int64_t>(rn[jj + u]) * w + c0, seg,
                  bar + lrow);
      }
    }
    bar_wait(bar + lrow, phase);
    phase ^= 1u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < nb) L::add(gather[u * 32 + lane], acc);
    }
  }
}

"""

#: the bulk-copy variant: (anchor in ell_band.cuh, replacement), each anchor
#: found once
VARIANT = [
    ("  int32_t deg[kWarpRows];\n};", "  int32_t deg[kWarpRows];\n  uint64_t bar[32];\n};"),
    ("template <int VEC>\n__device__ __forceinline__ void store_stream",
     _BULK_HELPERS + "template <int VEC>\n__device__ __forceinline__ void store_stream"),
    ("  int item = 0;\n  if (lane == 0) item = atomicAdd(counter, 1);",
     "  {\n    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(sm.bar + lane));\n"
     "    asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\" :: \"r\"(a) : \"memory\");\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
     "    __syncwarp();\n  }\n  uint32_t bphase = 0;\n"
     "  int item = 0;\n  if (lane == 0) item = atomicAdd(counter, 1);"),
    ("    const bool on = lrow < per_pass && col < w;",
     "    const bool on = lrow < per_pass && col < w;\n"
     "    const int64_t left = (w - c0 + VEC - 1) / VEC;  // lanes of the band inside W\n"
     "    const int act = left < lanes ? static_cast<int>(left) : lanes;"),
    ("          sum_row<T, VEC, WT>(acc, feats, w, col, sm.nbr + r * kt, sm.w + r * kt, d,"
     " sm.gather,\n                              lane);",
     "          if constexpr (WT == Weights::kUnit && kAsync<T, VEC>) {\n"
     "            sum_row_bulk<T, VEC>(acc, feats, w, c0, sm.nbr + r * kt, d, sm.gather, sm.bar,\n"
     "                                 bphase, lane, lrow, lanes, act);\n"
     "          } else {\n"
     "            sum_row<T, VEC, WT>(acc, feats, w, col, sm.nbr + r * kt, sm.w + r * kt, d,\n"
     "                                sm.gather, lane);\n"
     "          }"),
]


def build_variant(cb) -> ctypes.CDLL:
    """``gather_sum_static.cu`` built against the bulk-copy header, into
    ``build/ell_band_sweep/``; prints the compiler's register report."""
    import chip_smoke as cs

    out_dir = os.path.join(os.path.dirname(cb.BUILD_DIR), "ell_band_sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cb.CSRC, "ell_band.cuh")) as f:
        text = f.read()
    for old, new in VARIANT:
        if text.count(old) != 1:
            raise RuntimeError(f"bulk variant: anchor {old[:40]!r} is not in the header once")
        text = text.replace(old, new)
    with open(os.path.join(out_dir, "ell_band.cuh"), "w") as f:
        f.write(text)
    src = os.path.join(out_dir, "gather_sum_static.cu")
    shutil.copy(os.path.join(cb.CSRC, "gather_sum_static.cu"), src)
    so = os.path.join(out_dir, "libgather_sum_static_bulk.so")
    proc = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"bulk variant does not build:\n{proc.stderr[-4000:]}")
    for line in cs.ptxas_summary(proc.stderr):
        print(f"  bulk variant: {line}", flush=True)
    return ctypes.CDLL(so)


class Variant:
    """A stand-in for a :class:`Kernel` of the port: the same C function of
    another build, launched with the same arguments."""

    def __init__(self, fn, kernel):
        self.fn, self.symbol, self.argtypes = fn, kernel.symbol, kernel.argtypes
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int

    def launch(self, *args):
        rc = self.fn(*args)
        if rc:
            raise RuntimeError(f"variant launch failed: cudaError {rc}")


def same(a, b) -> bool:
    """Bit for bit, NaN where NaN."""
    import torch

    return torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))


def time_in_turns(cs, calls: dict, reps: int = 20) -> dict:
    """{name: [ms of four runs]}: the list, reversed, the list, reversed."""
    names = list(calls)
    ms = {name: [] for name in names}
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            ms[name].append(cs.cuda_ms(calls[name], reps))
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ell_band_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from bikg_graph_explainability_public_tpu_torch.graph import from_arrays
    from bikg_graph_explainability_public_tpu_torch.ops import cuda_build as cb
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc
    from bikg_graph_explainability_public_tpu_torch.ops.ell import build_neighbor_table

    cs.phase_header()
    dev = torch.device("cuda", 0)
    feat, ei, _ = cs.random_graph(cs.BIG_N, cs.BIG_E, seed=0)
    table = build_neighbor_table(from_arrays(feat, ei, device=dev))
    b = cs.BIG_B
    feats, weights, ps, _ = cs.ladder_inputs(table, b, cs.HIDDEN, torch.float32, 7)
    valid = table.valid > 0
    w = feats.shape[1]
    read_valid = int(valid.sum()) * w

    # mode -> (the port's call, the launch at a plan, summed slots' bytes)
    modes = {
        "valid (2.5)": (
            lambda: sc.ell_valid_sum(table, feats, b),
            lambda band, passes: sc._static_launch(sc.ELL_VALID_SUM["v6"], table, feats, b,
                                                   None, band, passes),
            read_valid),
        "scaled (2.3)": (
            lambda: sc.gather_sum_static(table, feats, b, ps),
            lambda band, passes: sc._static_launch(sc.GATHER_SUM_STATIC, table, feats, b, ps,
                                                   band, passes),
            read_valid),
    }
    for mode in ("static", "broadcast"):
        w_slot = weights[mode]
        read = read_valid if mode == "static" else int(((w_slot[..., 0] != 0) & valid).sum()) * w
        modes[f"{mode} (2.6)"] = (
            lambda w_slot=w_slot: sc.spmm_ell_weighted(table, w_slot, feats, b),
            lambda band, passes, w_slot=w_slot: sc._weighted_launch(
                sc.SPMM_ELL_WEIGHTED["v3"], table, w_slot, feats, b, band, passes),
            read)
    for mode, (port, at, read) in modes.items():
        want = port()
        calls = {f"band={band} passes={passes}": (lambda band=band, passes=passes: at(band, passes))
                 for band, passes in PLANS}
        for name, call in calls.items():
            if not same(call(), want):
                raise AssertionError(f"{mode} {name}: differs from the port's call")
        ms = time_in_turns(cs, calls)
        for name in calls:
            best = min(ms[name])
            print(f"{mode} {name}: {best:.4f} ms, gather {read * 4 / best / 1e6:.1f} GB/s; "
                  f"all runs {[round(v, 4) for v in ms[name]]}", flush=True)

    lib = build_variant(cb)
    bulk = {"valid (2.5)": Variant(lib.ell_valid_sum, sc.ELL_VALID_SUM["v6"]),
            "scaled (2.3)": Variant(lib.gather_sum_static, sc.GATHER_SUM_STATIC)}
    calls = {}
    for mode, kernel in bulk.items():
        port = modes[mode][0]
        scale = ps if kernel.symbol == "gather_sum_static" else None
        calls[f"{mode} cp.async"] = port
        calls[f"{mode} cp.async.bulk"] = (
            lambda kernel=kernel, scale=scale: sc._static_launch(kernel, table, feats, b, scale))
        if not same(calls[f"{mode} cp.async.bulk"](), port()):
            raise AssertionError(f"bulk variant {mode}: differs from the port's call")
    ms = time_in_turns(cs, calls)
    for name in calls:
        best = min(ms[name])
        print(f"bulk variant, {name}: {best:.4f} ms, "
              f"gather {read_valid * 4 / best / 1e6:.1f} GB/s; "
              f"all runs {[round(v, 4) for v in ms[name]]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
