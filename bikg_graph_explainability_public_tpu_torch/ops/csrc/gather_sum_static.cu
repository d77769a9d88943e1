// Static separable ELL gather-sum with a fused output scale (Hopper, sm_90a).
//
//   out[v, s*F:(s+1)*F] = post_scale[v, s] * sum_{k < deg[v]} feats[nbr[v, k], s*F:(s+1)*F]
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), post_scale [N, B] float32 or
// null, out [N, W] float32.  Sums accumulate in float32, slots in order,
// then one multiply by the scale.
//
// Replaces ops/spmm_pallas.py::gather_sum_static of the JAX package: the
// v7 schedule, spmm_ell_pallas(sched="v7") -> _spmm_v7 -> _kernel_v7
// (spmm_pallas.py:1074) in static mode with has_scale.  The same walk
// without the scale is exported a second time as ell_valid_sum (end of
// file) for the v6 and v5 schedules.
//
// Bound: memory.  There is no arithmetic to speak of (one add per gathered
// element, one multiply per output element).  The least any design moves
// is each distinct source row that a valid slot names read once, the valid
// slots' indices, deg and post_scale once and the output written once:
// 5.1 GB, 1.54 ms at the 100k-node / 1M-edge production shape (W = 6400
// float32).
//
// The design: the band walk of ell_band.cuh, shared with the static and
// broadcast modes of kernels 2.6/2.7 (spmm_ell_weighted.cu), under the kUnit
// weight policy: no weight array, each valid slot adds x, so it stages only
// indices and the sum is bit for bit the plain version's.  Work items are
// (64-column band, 32 destination rows), walked band-major by warps that
// take them from a global counter, so that one band of the source rows
// (25.6 MB at N = 100000) stays in the 50 MB L2; each row's valid prefix is
// gathered with cp.async into shared memory and the sums go out with
// streaming stores.  The scale is applied once, in the row's last slot tile
// (a row of degree above 512 / rows slots takes more than one, and a later
// tile adds to the partial sum an earlier one stored).  Slot k >= deg[v] is
// never read, so non-finite values in rows that no valid slot names cannot
// reach the sum, and rows of degree 0 come out as exact zeros (times the
// scale).  Offsets are 64-bit: N * W is above 2^31 at the production shape.

#include "ell_band.cuh"

namespace {

template <typename T, int VEC>
cudaError_t launch(const void* feats, const void* nbr, const void* deg, const void* post_scale,
                   void* out, int64_t n, int64_t k, int64_t w, int64_t f, int band, int rows,
                   int grid, void* counter, cudaStream_t stream) {
  if (post_scale != nullptr) {
    return launch_band<T, VEC, Weights::kUnit, true>(feats, nbr, deg, nullptr, post_scale, out, n,
                                                     k, w, f, band, rows, grid, counter, stream);
  }
  return launch_band<T, VEC, Weights::kUnit, false>(feats, nbr, deg, nullptr, nullptr, out, n, k,
                                                    w, f, band, rows, grid, counter, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  band, rows, grid: the band walk's
// columns a band, rows an item and persistent blocks (spmm_cuda.band_plan);
// counter: one int32 that is 0 at the launch.  vec: 1, or 16 bytes' worth of
// elements (4 float32 / 8 bfloat16) when F is a multiple of it and the
// feature and output pointers are 16-byte aligned (checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int gather_sum_static(const void* feats, int dtype, const void* nbr,
                                 const void* deg, const void* post_scale, void* out,
                                 int64_t n, int64_t k, int64_t w, int64_t f, int band,
                                 int rows, int grid, void* counter, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(feats, nbr, deg, post_scale, out, n, k, w, f, band, rows, grid,
                           counter, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(feats, nbr, deg, post_scale, out, n, k, w, f, band, rows, grid,
                           counter, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(feats, nbr, deg, post_scale, out, n, k, w, f, band, rows,
                                   grid, counter, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(feats, nbr, deg, post_scale, out, n, k, w, f, band, rows,
                                   grid, counter, s);
  }
  return static_cast<int>(err);
}

// The valid-prefix sum without an output scale: the unscaled walk above,
// exported under its own name so that its launches count apart from kernel
// 2.3's.  Replaces the JAX package's spmm_ell_pallas with sched="v6"
// (-> _kernel_v6, spmm_pallas.py:867) and sched="v5" (-> _kernel_v5 :549):
// both sum the valid slots of each row and differ from v7 only in how the
// TPU schedules its row DMAs.
extern "C" int ell_valid_sum(const void* feats, int dtype, const void* nbr, const void* deg,
                             void* out, int64_t n, int64_t k, int64_t w, int64_t f, int band,
                             int rows, int grid, void* counter, int vec, void* stream) {
  return gather_sum_static(feats, dtype, nbr, deg, nullptr, out, n, k, w, f, band, rows, grid,
                           counter, vec, stream);
}
