#!/usr/bin/env python3
"""The band walk of the static ELL gather-sums (``ops/csrc/ell_band.cuh`` of
the PyTorch port) swept on the card.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/ell_band_sweep.py

It times the walk at the production shape of ``chip_smoke.py``'s ladder
(100k nodes / 1M edges, K = 32, B = 50, F = 128, float32, the same seeded
inputs) with the bands and work-item sizes of ``PLANS``, in five modes: the
valid-prefix sum (kernel 2.5, ``ell_valid_sum``), the same with the output
scale (kernel 2.3, ``gather_sum_static``), kernel 2.6's static and
broadcast weights, and kernel 2.4 on sample-major per-sample weights
``[B, N, K]`` (``batched_gather_sum(..., w_sample=)``).  Each plan's output is first held equal to the port's
own call, bit for bit; the timings run in turns (the list, then reversed,
twice) and the best of the four is printed, with the gather rate (the
summed slots' source bytes over that time).

Then the bulk-copy variant (``VARIANT``): the valid sum and the scaled sum
built from a copy of the header in which each row's whole segment of a
slot (256 bytes) comes in by one ``cp.async.bulk``, completed on an
``mbarrier``, in place of 16 lanes' 16-byte ``cp.async``; held bit for bit
against the port's call and timed in turns with it, at the default plan.

Then kernel 2.9 (``spmm_ell_all_slots``, the guarded walk) at the ELL
prototype's run shape (``chip_smoke.proto_inputs``: 100k nodes, 1M edges,
K = 32, F = 128, float32, seed 0): the plans of ``PLANS_29`` (two 64-column
bands or one 128-column band, and rows per item), each held bit for bit
against the port's call and timed in turns beside the flag pass and the
entry; then three variants, each built from a copy of the header and timed
in turns with the port's walk at each band: ``TRAILING`` (a row's slots
stay in place and only those after its last taken slot are dropped, in
place of the compaction), ``STREAM`` (a lane group's slots gathered across
row boundaries in full batches, in place of a round trip per row) and
``PREFETCH`` (an L2 prefetch of the next item's indices and weights).  Without CUDA
it exits with code 2.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (band columns, passes of a warp over an item): 16 and 32 rows an item at
#: 32 and at the chosen 64 columns, and 32 rows at 48 columns
PLANS = ((32, 4), (32, 8), (48, 16), (64, 8), (64, 16))
#: kernel 2.9's (band columns, passes): two 64-column bands a row (32 and 16
#: rows an item), one 128-column band (a warp a row: 32, 16 and 8 rows); at
#: K = 32 the port's rule (``spmm_cuda.guard_rows``) allows 16
PLANS_29 = ((64, 16), (64, 8), (128, 32), (128, 16), (128, 8))

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
    ("            sum_row<T, VEC, WT>(acc, feats, w, col, sm.nbr + r * kt, sm.w + r * kt, d,\n"
     "                                sm.gather, lane);",
     "            if constexpr (WT == Weights::kUnit && kAsync<T, VEC>) {\n"
     "              sum_row_bulk<T, VEC>(acc, feats, w, c0, sm.nbr + r * kt, d, sm.gather,\n"
     "                                   sm.bar, bphase, lane, lrow, lanes, act);\n"
     "            } else {\n"
     "              sum_row<T, VEC, WT>(acc, feats, w, col, sm.nbr + r * kt, sm.w + r * kt, d,\n"
     "                                  sm.gather, lane);\n"
     "            }"),
]


#: the trailing-zero variant of kernel 2.9: each staged slot stays in its
#: place and a row's count is one past its last taken slot, so interior
#: zero-weight slots over finite rows are gathered and add 0 * x
TRAILING = [
    ("  return make_int2(run + __popc(m & ((1u << lane) - 1u)), run + __popc(m));",
     "  return make_int2(off + lane - g0, m ? off + 32 - __clz(m) - g0 : run);"),
    ("          if (take[t]) {\n            sm.nbr[r * kt + p.x] = pn[t];",
     "          if (i < nrows * kt && j0 + (i - r * kt) < sm.deg[r]) {\n"
     "            sm.nbr[r * kt + p.x] = pn[t];"),
]


_STREAM_HELPERS = r"""// kGuard with 16-byte lanes: the taken slots of one lane group's rows (r0,
// r0 + step, ... below nrows; cnt[r] of them at r * kt of the staged run)
// gathered as one stream, kBatch at a time, so that a round trip may finish
// one row and start the next and every trip but the group's last carries
// kBatch slots.  Each row's slots are added in slot order, from +0 (in a
// later slot tile, from the partial sum the earlier one stored), and the row
// is stored once its last slot is added; a row with no taken slot stores +0
// in the first tile and keeps its partial sum in a later one.  out: this
// lane's columns of the item's first row.
template <typename T, int VEC>
__device__ __forceinline__ void guard_stream(const T* __restrict__ feats, int64_t w, int64_t col,
                                             float* out, const int32_t* rn, const float* rw,
                                             const int32_t* cnt, int kt, int r0, int step,
                                             int nrows, int j0, uint4* gather, int lane) {
  using L = Lane<T, VEC>;
  // the first row at or after r with a taken slot (nrows where none is left)
  auto next_row = [&](int r) {
    while (r < nrows && cnt[r] == 0) r += step;
    return r;
  };
  if (j0 == 0) {
    const float zero[VEC] = {};
    for (int r = r0; r < nrows; r += step) {
      if (cnt[r] == 0) store_stream<VEC>(out + r * w, zero);
    }
  }
  int ri = next_row(r0), ji = 0;  // the next slot to copy
  int rs = ri, js = 0;            // the next slot to add
  float acc[VEC];
  while (ri < nrows) {
    // fill the batch from the rows' runs: the copies of one run issue
    // together (their indices are independent reads), and a row's count is
    // read once per run, not per slot
    int nb = 0;
    while (nb < kBatch && ri < nrows) {
      const int c = cnt[ri];
      const int m = min(c - ji, kBatch - nb);
      const int32_t* src = rn + ri * kt + ji;
      for (int u = 0; u < m; ++u) {
        copy16_if(true, gather + (nb + u) * 32 + lane,
                  feats + static_cast<int64_t>(src[u]) * w + col);
      }
      nb += m;
      ji += m;
      if (ji == c) {
        ri = next_row(ri + step);
        ji = 0;
      }
    }
    copies_landed();
    for (int u0 = 0; u0 < nb;) {
      const int c = cnt[rs];
      const int m = min(c - js, nb - u0);
      float* o = out + rs * w;
      if (js == 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = j0 == 0 ? 0.0f : o[i];
      }
      const float* wts = rw + rs * kt + js;
      for (int u = 0; u < m; ++u) L::fma(gather[(u0 + u) * 32 + lane], wts[u], acc);
      u0 += m;
      js += m;
      if (js == c) {
        store_stream<VEC>(o, acc);
        rs = next_row(rs + step);
        js = 0;
      }
    }
  }
}

"""

#: the stream variant of kernel 2.9: a lane group's taken slots of all its
#: rows gathered kBatch at a time across row boundaries (so that every round
#: trip but the last is full), each row's run issued as one burst, in place
#: of a round trip per row
STREAM = [
    ("// The walk.  w_slot is null under kUnit",
     _STREAM_HELPERS + "// The walk.  w_slot is null under kUnit"),
    ("      if (on) {\n        for (int r = lrow; r < nrows; r += per_pass) {",
     "      if constexpr (WT == Weights::kGuard && kAsync<T, VEC>) {\n"
     "        if (on) {\n"
     "          guard_stream<T, VEC>(feats, w, col, out + v0 * w + col, sm.nbr, sm.w, cnt, kt,\n"
     "                               lrow, per_pass, nrows, j0, sm.gather, lane);\n"
     "        }\n"
     "      } else if (on) {\n        for (int r = lrow; r < nrows; r += per_pass) {"),
]

_PREFETCH_HELPER = r"""// A hint to bring the 128-byte line at p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

"""
_PREFETCH = r"""        if constexpr (WT == Weights::kGuard) {
          // and its indices and weights, fetched into L2, so that its
          // staging waits on L2 and not on device memory
          if (next < items) {
            const int64_t nv0 = next % chunks * rows;
            const int64_t base = nv0 * k, len = (nv0 + rows < n ? rows : n - nv0) * k;
            for (int64_t e = lane * 32; e < len; e += 32 * 32) {
              prefetch_l2(nbr + base + e);
              prefetch_l2(w_slot + base + e);
            }
          }
        }
"""

#: kernel 2.9 with an L2 prefetch of the next item's indices and weights,
#: issued where the walk reads the next item's degrees ahead
PREFETCH = [
    ("// This thread's cp.async copies have landed",
     _PREFETCH_HELPER + "// This thread's cp.async copies have landed"),
    ("        pscale = first_scale(next);\n",
     "        pscale = first_scale(next);\n" + _PREFETCH),
]


def build_variant(cb, variant, source: str, name: str) -> ctypes.CDLL:
    """``csrc/<source>`` built against a copy of ``ell_band.cuh`` with the
    ``variant``'s (anchor, replacement) pairs applied, into
    ``build/ell_band_sweep/lib<name>.so``; prints the compiler's register
    report."""
    import chip_smoke as cs

    out_dir = os.path.join(os.path.dirname(cb.BUILD_DIR), "ell_band_sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cb.CSRC, "ell_band.cuh")) as f:
        text = f.read()
    for old, new in variant:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: anchor {old[:40]!r} is not in the header once")
        text = text.replace(old, new)
    with open(os.path.join(out_dir, "ell_band.cuh"), "w") as f:
        f.write(text)
    src = os.path.join(out_dir, source)
    shutil.copy(os.path.join(cb.CSRC, source), src)
    so = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name} does not build:\n{proc.stderr[-4000:]}")
    for line in cs.ptxas_summary(proc.stderr):
        print(f"  {name}: {line}", flush=True)
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


def print_turns(label: str, ms: dict, read: int) -> None:
    """The best of each call's rounds, its gather rate (``read`` bytes over
    that time) and every round."""
    for name, runs in ms.items():
        best = min(runs)
        print(f"{label}{name}: {best:.4f} ms, gather {read / best / 1e6:.1f} GB/s; "
              f"all runs {[round(v, 4) for v in runs]}", flush=True)


def sweep_all_slots() -> None:
    """Kernel 2.9's plans and its trailing-zero variant at the prototype's
    shape (see the head of this file)."""
    import torch
    import chip_smoke as cs
    from bikg_graph_explainability_public_tpu_torch.ops import cuda_build as cb
    from bikg_graph_explainability_public_tpu_torch.ops import spmm_cuda as sc

    dev = torch.device("cuda", 0)
    x, nbr, wk, _, _, _, _ = cs.proto_inputs(dev)
    table = sc.all_slots_table(nbr)
    bad = sc.nonfinite_rows(x)
    want = sc.spmm_ell_all_slots(nbr, wk, x, table=table)
    n, f = x.shape
    read = int((wk != 0).sum()) * f * x.element_size()  # the taken slots' segments
    sms = sc._sm_count(dev.index)
    walk = sc.SPMM_ELL_ALL_SLOTS
    calls = {"entry (flag pass + walk)": lambda: sc.spmm_ell_all_slots(nbr, wk, x, table=table),
             "flag pass": lambda: sc.nonfinite_rows(x)}
    for band, passes in PLANS_29:
        rows = sc.band_plan(n, f, x.element_size(), 4, sms, band, passes,
                            sc.GUARD_MAX_ROWS).rows
        call = (lambda band=band, passes=passes:
                sc._guard_launch(walk, table, wk, x, bad, band, passes, sc.GUARD_MAX_ROWS))
        if not same(call(), want):
            raise AssertionError(f"2.9 band={band} passes={passes}: differs from the port's call")
        calls[f"walk band={band} rows={rows}"] = call
    print_turns("2.9 ", cs.in_turns(calls, 20, rounds=4), read)

    variants = {
        name: Variant(build_variant(cb, anchors, "spmm_ell_all_slots.cu",
                                    f"spmm_ell_all_slots_{tag}").spmm_ell_all_slots, walk)
        for name, tag, anchors in (("trailing zeros only", "trailing", TRAILING),
                                   ("stream across rows", "stream", STREAM),
                                   ("L2 prefetch", "prefetch", PREFETCH))
    }
    calls = {}
    for band in (64, 128):
        calls[f"band={band} port"] = (
            lambda band=band: sc._guard_launch(walk, table, wk, x, bad, band))
        for name, kernel in variants.items():
            call = (lambda band=band, kernel=kernel:
                    sc._guard_launch(kernel, table, wk, x, bad, band))
            if not same(call(), want):
                raise AssertionError(f"2.9 {name} band={band}: differs from the port's call")
            calls[f"band={band} {name}"] = call
    print_turns("2.9 walk ", cs.in_turns(calls, 20, rounds=4), read)


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
    # kernel 2.4: the ladder's per-sample weights, sample-major; it multiplies,
    # so every valid slot is read
    w_bnk = weights["per_sample"].permute(2, 0, 1).contiguous()
    modes["sample-major (2.4)"] = (
        lambda: sc.batched_gather_sum(table, None, feats, b, w_sample=w_bnk),
        lambda band, passes: sc._static_launch(sc.BATCHED_GATHER_SUM, table, feats, b, w_bnk,
                                               band, passes),
        read_valid)
    for mode, (port, at, read) in modes.items():
        want = port()
        calls = {f"band={band} passes={passes}": (lambda band=band, passes=passes: at(band, passes))
                 for band, passes in PLANS}
        for name, call in calls.items():
            if not same(call(), want):
                raise AssertionError(f"{mode} {name}: differs from the port's call")
        print_turns(f"{mode} ", cs.in_turns(calls, 20, rounds=4), read * 4)

    lib = build_variant(cb, VARIANT, "gather_sum_static.cu", "gather_sum_static_bulk")
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
    print_turns("bulk variant, ", cs.in_turns(calls, 20, rounds=4), read_valid * 4)
    del feats, weights, table
    sweep_all_slots()
    return 0


if __name__ == "__main__":
    sys.exit(main())
