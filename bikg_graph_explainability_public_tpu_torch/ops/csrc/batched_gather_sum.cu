// Weighted ELL gather-sum with per-slot, per-sample weights (Hopper, sm_90a).
//
//   out[v, s*F:(s+1)*F] = sum_{k < deg[v]} w[s, v, k] * feats[nbr[v, k], s*F:(s+1)*F]
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), w_bnk [B, N, K] float32
// (sample-major: the engine's coefficient tensor as it is made), out [N, W]
// float32.  Sums accumulate in float32, slots in order; each term is w * x,
// the product rounded before the sum, so a valid slot of weight 0 still adds
// 0 * x and the sum is bit for bit the plain version's.
//
// Replaces ops/spmm_pallas.py::batched_gather_sum of the JAX package: the
// weighted v7 schedule, spmm_ell_pallas(sched="v7") -> _spmm_v7 ->
// _kernel_v7 (spmm_pallas.py:1074) with weighted=True.  The JAX entry takes
// slot-major weights w_slot [N, K, B]; slot_transpose (below) makes the
// sample-major copy for callers that hold those.
//
// Bound: memory.  One multiply-add per gathered element is far below the
// card's arithmetic rate.  The least any design moves is each distinct
// source row that a valid slot names read once, the valid slots' indices
// and B weights once and the output written once: 5.3 GB, 1.59 ms at the
// 100k-node / 1M-edge production shape (W = 6400 float32, B = 50).
//
// The design: the band walk of ell_band.cuh, shared with kernels 2.3, 2.5,
// 2.8 and 2.6/2.7, under the kSample weight policy.  Work items are
// (64-column band, 32 destination rows), walked band-major by warps that
// take them from a global counter, so that one band of the source rows
// (25.6 MB at N = 100000) stays in the 50 MB L2 while every destination row
// is summed over it.  A 64-column band lies in one sample s (F = 128), so
// the item's weights are the contiguous run w_bnk[s, v0 .. v0 + 32, :],
// staged in shared memory with the indices as kStatic stages [N, K]: each
// sample's [N, K] slice (12.8 MB) is read from HBM once and from L2 for the
// sample's second band.  Where a band spans samples (F < band, or F not a
// multiple of it) each lane reads its own sample's weights.  The row
// schedule this replaces (one block per destination row and column tile,
// on [N, K, B]) read each slot's source segment from HBM again: 28.2 GB a
// call, 9.11 ms against the walk's 5.80 and the transpose + walk's 6.36
// (PERF.md, timed in turns), so the slot-major entry takes the transpose.
//
// slot_transpose: w_slot [R, B] -> w_bnk [B, R] with R = N * K, through
// 32 x 32 tiles in shared memory (one 128-byte segment read and one written
// per warp and tile row); bound by its bytes, 2 * N * K * B * 4.
//
// Slot k >= deg[v] is never read (NaN in source rows that only invalid
// slots name cannot reach the sum, rows of degree 0 come out as exact
// zeros); offsets are 64-bit (N * W is above 2^31 at the production shape).

#include "ell_band.cuh"

namespace {

constexpr int kTile = 32;      // the transpose's tile edge
constexpr int kTileRows = 8;   // its block: kTile x kTileRows threads

__global__ void __launch_bounds__(kTile * kTileRows)
slot_transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int64_t rows,
                      int64_t b) {
  __shared__ float tile[kTile][kTile + 1];  // +1: the column reads hit 32 banks
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t s0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int tx = threadIdx.x;
#pragma unroll
  for (int i = threadIdx.y; i < kTile; i += kTileRows) {
    const int64_t r = r0 + i, s = s0 + tx;
    if (r < rows && s < b) tile[i][tx] = __ldg(in + r * b + s);
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.y; i < kTile; i += kTileRows) {
    const int64_t s = s0 + i, r = r0 + tx;
    if (s < b && r < rows) out[s * rows + r] = tile[tx][i];
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feats, const void* nbr, const void* deg, const void* w_bnk,
                   void* out, int64_t n, int64_t k, int64_t w, int64_t f, int band, int rows,
                   int grid, void* counter, cudaStream_t stream) {
  return launch_band<T, VEC, Weights::kSample, false>(feats, nbr, deg, w_bnk, nullptr, out, n, k,
                                                      w, f, band, rows, grid, counter, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  band, rows, grid: the band walk's
// columns a band, rows an item and persistent blocks (spmm_cuda.band_plan);
// counter: one int32 that is 0 at the launch.  vec: 1, or 16 bytes' worth of
// elements (4 float32 / 8 bfloat16) when F is a multiple of it and the
// feature and output pointers are 16-byte aligned (checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int batched_gather_sum(const void* feats, int dtype, const void* nbr,
                                  const void* deg, const void* w_bnk, void* out,
                                  int64_t n, int64_t k, int64_t w, int64_t f, int band,
                                  int rows, int grid, void* counter, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(feats, nbr, deg, w_bnk, out, n, k, w, f, band, rows, grid, counter, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(feats, nbr, deg, w_bnk, out, n, k, w, f, band, rows, grid, counter, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(feats, nbr, deg, w_bnk, out, n, k, w, f, band, rows, grid,
                                   counter, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(feats, nbr, deg, w_bnk, out, n, k, w, f, band, rows, grid,
                                   counter, s);
  }
  return static_cast<int>(err);
}

// w_slot [rows, b] float32 -> w_bnk [b, rows] float32 (rows = N * K).
// Returns cudaGetLastError() after the launch.
extern "C" int slot_transpose(const void* w_slot, void* w_bnk, int64_t rows, int64_t b,
                              void* stream) {
  const int64_t gx = (rows + kTile - 1) / kTile, gy = (b + kTile - 1) / kTile;
  if (rows < 1 || b < 1 || gx > 0x7fffffffLL || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slot_transpose_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                          dim3(kTile, kTileRows), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_slot), static_cast<float*>(w_bnk), rows, b);
  return static_cast<int>(cudaGetLastError());
}
