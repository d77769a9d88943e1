// The ELL prototype's all-slot sum (Hopper, sm_90a): kernel 2.9.
//
//   out[v, :] = sum over all K slots k, in slot order, of wk[v, k] * x[nbr[v, k], :]
//
// nbr [N, K] int32, wk [N, K] float32, x [N_src, F] float32 or bfloat16,
// out [N, F] float32.  The prototype's table (benchmarks/exp_spmm_kernels.py
// ::build_ell) pads each row to K with slots nbr = 0, wk = 0, and its kernel
// sums them like the others.
//
// Replaces benchmarks/exp_spmm_pallas_proto.py::make_pallas_ell of the JAX
// package (-> pallas_call :86 -> _kernel :21), whose body computes
// (wk[:, :, None] * g3).sum(axis=1) over the K gathered rows (:66-67).
//
// Exactness: why a slot may be skipped.  The walk's accumulator starts at
// +0.0f and adds each term as one fused multiply-add, fma(wt, x, acc), in
// slot order, as kernel 2.6's static walk (kStatic) does.
//   * Round-to-nearest gives +0 for +0 + -0 and for an exact cancellation,
//     so the accumulator is -0.0f only where a negative product underflows
//     to zero.
//   * A zero-weight slot (wt == 0.0f, which includes -0.0f) whose x[u, c] is
//     finite adds fma(0, x, acc) = acc + (+-0): the sum bit for bit as it
//     was, except that a -0.0f may become +0.0f, the same value.
//   * Where x[u, c] is +-Inf or NaN, 0 * x is NaN, the column's sum becomes
//     NaN, and NaN stays.
// Hence a slot may be skipped exactly when wt == 0 and row u holds only
// finite values; every other slot is summed as kStatic sums it.  The result
// is kStatic's bit for bit (torch.equal on the finite entries, zeros of
// either sign equal, and the same NaN positions) on every input.
//
// The design, two launches and no host synchronisation:
//   1. nonfinite_rows: bad[u] = 1 where row u of x holds a non-finite value
//      (exponent bits all set), one warp per row, 16-byte loads where the
//      rows allow them, one ballot a row.  It reads x once: 51.2 MB at the
//      prototype's shape (N_src = 100000, F = 128, float32), 0.015 ms at
//      3.35 TB/s.
//   2. The band walk of ell_band.cuh under the kGuard policy: per work item
//      (column band, chunk of rows) a warp stages the slots' indices and
//      weights, reads the flags of the zero-weight slots' rows, and compacts
//      the taken slots (wt != 0 or bad[nbr]) of each row to the front of its
//      staged run with one ballot per 32 slots, keeping their order; each
//      row then gathers only its taken slots, in one round trip where it
//      has at most 16.  An item has as many rows as stage all K slots in
//      one tile (spmm_cuda.guard_rows: 16 at K = 32), so that it takes one
//      staging round trip.  At the prototype's shape 2.2M of the 3.2M slots
//      are padding on row 0: under kStatic every warp gathered row 0's
//      segment of each band about 22 times per destination row (an L2 hot
//      spot: 1.253 ms on an H100 80GB HBM3, PERF.md), and 2.2M gathers
//      carried a zero weight.
//
// Swept on the H100 (scripts/ell_band_sweep.py, PERF.md): two 64-column
// bands and one 128-column band tie; 32 rows an item (two slot tiles) lost
// 4-10 %; skipping trailing zeros alone in place of the compaction, a
// stream of a lane group's slots across rows in full batches of 16, and an
// L2 prefetch of the next item's indices and weights were all slower.
//
// Bound: memory.  A multiply-add per taken slot and column is far below the
// card's arithmetic rate.  The least any design moves is every slot's index
// and weight once (the all-slot sum must look at each), each distinct
// source row that a slot names once and the output once: 0.128 GB, 0.038 ms
// at the prototype's shape (chip_smoke.py).  The flag pass adds x's 51.2 MB.
//
// Offsets are 64-bit; the walk reads no slot k >= deg[v] (all K here).

#include "ell_band.cuh"

namespace {

// Whether a lane's raw bits hold a non-finite value: float32 exponent bits
// 0x7f800000 all set, bfloat16 0x7f80 (either half of a 32-bit word).
__device__ __forceinline__ bool nonfinite_f32(uint32_t x) {
  return (x & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool nonfinite_bf16(uint32_t x) { return (x & 0x7f80u) == 0x7f80u; }

template <typename T, int VEC>
__device__ __forceinline__ bool nonfinite(typename Lane<T, VEC>::Raw x) {
  if constexpr (VEC == 1) {
    return sizeof(T) == 4 ? nonfinite_f32(x) : nonfinite_bf16(x);
  } else {
    const uint32_t h[4] = {x.x, x.y, x.z, x.w};
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      any |= sizeof(T) == 4 ? nonfinite_f32(h[i]) : nonfinite_bf16(h[i]) || nonfinite_f32(h[i]);
    }
    return any;
  }
}

constexpr int kFlagThreads = 256;

// One warp per row of x [n, f]: its lanes read the row VEC elements at a
// time, and a ballot sets bad[row].
template <typename T, int VEC>
__global__ void __launch_bounds__(kFlagThreads)
nonfinite_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ bad, int64_t n, int64_t f) {
  using Raw = typename Lane<T, VEC>::Raw;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kFlagThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // whole warps: a warp's lanes share the row
  const T* xr = x + row * f;
  bool any = false;
  for (int64_t c = static_cast<int64_t>(lane) * VEC; c < f; c += 32 * VEC) {
    any |= nonfinite<T, VEC>(*reinterpret_cast<const Raw*>(xr + c));
  }
  const unsigned m = __ballot_sync(0xffffffffu, any);
  if (lane == 0) bad[row] = m != 0;
}

template <typename T, int VEC>
cudaError_t launch_flags(const void* x, void* bad, int64_t n, int64_t f, cudaStream_t stream) {
  const int64_t blocks = (n * 32 + kFlagThreads - 1) / kFlagThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  nonfinite_rows_kernel<T, VEC><<<static_cast<unsigned>(blocks), kFlagThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(bad), n, f);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* nbr, const void* deg, const void* wk,
                   const void* bad, void* out, int64_t n, int64_t k, int64_t f, int band,
                   int rows, int grid, void* counter, cudaStream_t stream) {
  return launch_band<T, VEC, Weights::kGuard, false>(x, nbr, deg, wk, nullptr, out, n, k, f, f,
                                                     band, rows, grid, counter, stream, bad);
}

}  // namespace

// bad [n] uint8 = 1 where row r of x [n, f] holds +-Inf or NaN, else 0.
// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth of elements
// (4 float32 / 8 bfloat16) when f is a multiple of it and x is 16-byte
// aligned (checked by the caller).  Returns cudaGetLastError() after the
// launch.
extern "C" int nonfinite_rows(const void* x, int dtype, void* bad, int64_t n, int64_t f, int vec,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch_flags<float, 4>(x, bad, n, f, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch_flags<float, 1>(x, bad, n, f, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch_flags<__nv_bfloat16, 8>(x, bad, n, f, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch_flags<__nv_bfloat16, 1>(x, bad, n, f, s);
  }
  return static_cast<int>(err);
}

// The all-slot sum over the table (nbr, deg) with weights wk, skipping the
// zero-weight slots whose source row bad[] does not flag.  dtype: 0 =
// float32, 1 = bfloat16.  band, rows, grid: the band walk's columns a band,
// rows an item (at most 128) and persistent blocks; counter: one int32 that
// is 0 at the launch.  vec: as nonfinite_rows, for x and out.  Returns
// cudaGetLastError() after the launch.
extern "C" int spmm_ell_all_slots(const void* x, int dtype, const void* nbr, const void* deg,
                                  const void* wk, const void* bad, void* out, int64_t n,
                                  int64_t k, int64_t f, int band, int rows, int grid,
                                  void* counter, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(x, nbr, deg, wk, bad, out, n, k, f, band, rows, grid, counter, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(x, nbr, deg, wk, bad, out, n, k, f, band, rows, grid, counter, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(x, nbr, deg, wk, bad, out, n, k, f, band, rows, grid, counter,
                                   s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(x, nbr, deg, wk, bad, out, n, k, f, band, rows, grid, counter,
                                   s);
  }
  return static_cast<int>(err);
}
