// Slot-weighted ELL gather-sum (Hopper, sm_90a): a band-major walk whose
// column band of the source rows stays in L2.
//
//   out[v, s*F:(s+1)*F] = sum_{k < deg[v]} term(w[v, k, s], feats[nbr[v, k], s*F:(s+1)*F])
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), out [N, W] float32.  The
// weights w_slot are float32 with wb weights per slot:
//
//   static [N, K]        wb = 1, one weight per slot for every column; each
//                        valid slot adds w * x (a multiply);
//   broadcast [N, K, 1]  wb = 1, and per-sample [N, K, B], wb = B; each
//                        valid slot adds w * x where w != 0 and nothing where
//                        w == 0 (a select: that slot's source row is not read).
//
// Sums accumulate in float32, slots in order.
//
// Replaces ops/spmm_pallas.py::spmm_ell_pallas of the JAX package with
// sched="v3" (-> _kernel, spmm_pallas.py:288: static mode :387-399, the
// select :405) and sched="fused" (-> _kernel_fused :436, _row_reduce :273-285).
// Both TPU schedules compute this one function; they differ in how DMA
// issue and the reduce share the TPU core, which has no counterpart here.
//
// Bound: memory.  One multiply-add per gathered element is far below the
// card's arithmetic rate.  The least any design moves is each distinct
// source row that a summed slot names read once, the valid slots' indices
// and weights once and the output written once: 5.1 GB, 1.53 ms at the
// 100k-node / 1M-edge production shape (W = 6400 float32).
//
// Static and broadcast weights (one weight per slot) take the band walk of
// ell_band.cuh, shared with kernels 2.3, 2.5 and 2.8 (gather_sum_static.cu):
// a band-major, L2-resident walk over 64-column bands of the source rows,
// whose design, band and guarantees that header describes.  This file adds
// the weight policy (kStatic, kSelect) and the per-sample schedule below.
// Kernel 2.9 (spmm_ell_all_slots.cu) is held bit for bit against the static
// mode on a table whose every slot is valid.
// Swept on the H100 (scripts/ell_band_sweep.py): bands of 32 and 48 columns
// were slower than 64 (more items and index reads per byte gathered), and an
// L2 evict_last policy on the gathers gained nothing once they went through
// cp.async (PERF.md).
//
// The per-sample mode keeps the simple design (spmm_ell_row_kernel): a band
// lies in one sample, so the walk would read one weight per 32-byte sector
// of [N, K, B] (32 MB a band, 3.2 GB a call); it measured slower there than
// this schedule, which reads 8 samples' weights per sector.  (Kernel 2.4
// walks sample-major weights [B, N, K], batched_gather_sum.cu.)
//
// Both schedules: slot k >= deg[v] is never read (NaN in source rows that
// only invalid slots name cannot reach the sum, rows of degree 0 come out as
// exact zeros); in the select modes the source row of a slot of weight 0 is
// never read; the static mode multiplies and keeps 0 * NaN; offsets are
// 64-bit (N * W is above 2^31 at the production shape).

#include "ell_band.cuh"

namespace {

// The per-sample mode (w_slot [N, K, B]): one block per (destination row,
// column tile), threads striding over the row's columns; each thread's VEC
// columns lie in one sample (F % VEC == 0), so it reads one weight per slot.
template <typename T, int VEC, bool SELECT>
__global__ void spmm_ell_row_kernel(const T* __restrict__ feats, const int32_t* __restrict__ nbr,
                                    const int32_t* __restrict__ deg,
                                    const float* __restrict__ w_slot, float* __restrict__ out,
                                    int64_t k, int64_t w, int64_t f, int64_t wb) {
  using L = Lane<T, VEC>;
  const int64_t v = blockIdx.x;
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= w) return;
  const int32_t d = deg[v];
  const int32_t* row = nbr + v * k;
  const float* wrow = w_slot + v * k * wb + col / f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int32_t j = 0; j < d; ++j) {
    const float wt = __ldg(wrow + j * wb);
    if (SELECT && wt == 0.0f) continue;
    const int64_t src = __ldg(row + j);
    L::fma(__ldg(reinterpret_cast<const typename L::Raw*>(feats + src * w + col)), wt, acc);
  }
  float* o = out + v * w + col;
  if constexpr (VEC == 1) {
    o[0] = acc[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(o + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feats, const void* nbr, const void* deg, const void* ws,
                   void* out, int64_t n, int64_t k, int64_t w, int64_t f, int64_t wb,
                   bool select, int band, int rows, int grid, void* counter,
                   cudaStream_t stream) {
  if (wb != 1) {
    const T* x = static_cast<const T*>(feats);
    const int32_t* nb = static_cast<const int32_t*>(nbr);
    const int32_t* dg = static_cast<const int32_t*>(deg);
    const float* wp = static_cast<const float*>(ws);
    float* o = static_cast<float*>(out);
    const int64_t lanes = w / VEC;  // threads needed per row
    int threads = 256;
    if (lanes < threads) threads = static_cast<int>((lanes + 31) / 32 * 32);
    const int64_t tiles = (lanes + threads - 1) / threads;
    if (n > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidConfiguration;
    const dim3 blocks(static_cast<unsigned>(n), static_cast<unsigned>(tiles));
    auto kernel = select ? spmm_ell_row_kernel<T, VEC, true> : spmm_ell_row_kernel<T, VEC, false>;
    kernel<<<blocks, threads, 0, stream>>>(x, nb, dg, wp, o, k, w, f, wb);
    return cudaGetLastError();
  }
  if (select) {
    return launch_band<T, VEC, Weights::kSelect, false>(feats, nbr, deg, ws, nullptr, out, n, k, w,
                                                        f, band, rows, grid, counter, stream);
  }
  return launch_band<T, VEC, Weights::kStatic, false>(feats, nbr, deg, ws, nullptr, out, n, k, w, f,
                                                      band, rows, grid, counter, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  wb: weights per slot (1, or B = W / F
// for per-sample weights, which take the row schedule).  select: 1 for the
// broadcast and per-sample modes (skip slots of weight 0), 0 for the static
// mode (multiply).  band, rows, grid: the band walk's columns a band, rows an
// item and persistent blocks; counter: one int32 that is 0 at the launch.
// vec: 1, or 16 bytes' worth of elements (4 float32 / 8 bfloat16) when F is
// a multiple of it and the feature and output pointers are 16-byte aligned
// (checked by the caller).  Returns cudaGetLastError() after the launch.
extern "C" int spmm_ell_weighted(const void* feats, int dtype, const void* nbr,
                                 const void* deg, const void* w_slot, void* out,
                                 int64_t n, int64_t k, int64_t w, int64_t f, int64_t wb,
                                 int select, int band, int rows, int grid, void* counter,
                                 int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sel = select != 0;
  if (wb != 1 && wb != w / f) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, band, rows, grid,
                           counter, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, band, rows, grid,
                           counter, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, band, rows,
                                   grid, counter, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, band, rows,
                                   grid, counter, s);
  }
  return static_cast<int>(err);
}
