// Slot-weighted ELL gather-sum (Hopper, sm_90a).
//
//   out[v, s*F:(s+1)*F] = sum_{k < deg[v]} term(w[v, k, s], feats[nbr[v, k], s*F:(s+1)*F])
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), out [N, W] float32.  The
// weights w_slot are float32 with wb weights per slot:
//
//   static [N, K]     wb = 1, one weight per slot for every column; each
//                     valid slot adds w * x (a multiply);
//   broadcast [N, K, 1]  wb = 1, and per-sample [N, K, B]  wb = B; each
//                     valid slot adds w * x where w != 0 and nothing where
//                     w == 0 (a select: that slot's source row is not read).
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
// card's arithmetic rate.  The least any design could move is each distinct
// source row that a slot of non-zero weight names read once, the valid
// slots' indices and weights read once and the output written once; a
// gather design reads the source row once per slot instead, about five
// times more at the 100k-node / 1M-edge shape.
//
// The simple design is kernel 2.3's (gather_sum_static.cu): one block per
// (destination row, column tile), threads striding over the row's columns
// with 16-byte loads, so that a warp reads 512 contiguous bytes of one
// neighbour row per load; the row's indices and weights are read through
// the broadcast path.  Each thread's VEC columns lie in one sample
// (F % VEC == 0), so it reads one weight per slot.  It never reads slot
// k >= deg[v], so NaN in source rows that only invalid slots name cannot
// reach the sum and rows of degree 0 come out as exact zeros; in the select
// modes it also skips the source row of a slot whose weight is 0, so a NaN
// row that only zero-weight slots name does not reach the sum either (the
// TPU select's result; kernel 2.4 multiplies and keeps 0 * NaN).  Offsets
// are 64-bit: N * W is close to 2^31 at the production shape.  What it does
// not do: reuse a source row across the destinations that share it (only
// the L2 cache does that) or balance rows of unequal degree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void fma(const float* p, float w, float* acc) {
    acc[0] += w * __ldg(p);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void fma(const float* p, float w, float* acc) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] += w * x.x;
    acc[1] += w * x.y;
    acc[2] += w * x.z;
    acc[3] += w * x.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void fma(const __nv_bfloat16* p, float w, float* acc) {
    acc[0] += w * __bfloat162float(p[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void fma(const __nv_bfloat16* p, float w, float* acc) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += w * f.x;
      acc[2 * i + 1] += w * f.y;
    }
  }
};

template <typename T, int VEC, bool SELECT>
__global__ void spmm_ell_weighted_kernel(const T* __restrict__ feats,
                                         const int32_t* __restrict__ nbr,
                                         const int32_t* __restrict__ deg,
                                         const float* __restrict__ w_slot,
                                         float* __restrict__ out, int64_t k,
                                         int64_t w, int64_t f, int64_t wb) {
  const int64_t v = blockIdx.x;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= w) return;
  const int32_t d = deg[v];
  const int32_t* row = nbr + v * k;
  // wb == 1: one weight per slot for all samples; wb == B: this thread's
  // sample (VEC > 1 only when F % VEC == 0, so the lanes share it)
  const float* wrow = w_slot + v * k * wb + (wb == 1 ? 0 : col / f);
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int32_t j = 0; j < d; ++j) {
    const float wt = __ldg(wrow + j * wb);
    if (SELECT && wt == 0.0f) continue;
    const int64_t src = __ldg(row + j);
    Vec<T, VEC>::fma(feats + src * w + col, wt, acc);
  }
  float* o = out + v * w + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(o)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = acc[i];
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* feats, const void* nbr, const void* deg,
                   const void* w_slot, void* out, int64_t n, int64_t k, int64_t w,
                   int64_t f, int64_t wb, bool select, cudaStream_t stream) {
  const int64_t lanes = w / VEC;  // threads needed per row
  int threads = 256;
  if (lanes < threads) threads = static_cast<int>((lanes + 31) / 32 * 32);
  const int64_t tiles = (lanes + threads - 1) / threads;
  if (n > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(tiles));
  const T* x = static_cast<const T*>(feats);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const int32_t* dg = static_cast<const int32_t*>(deg);
  const float* ws = static_cast<const float*>(w_slot);
  float* o = static_cast<float*>(out);
  if (select) {
    spmm_ell_weighted_kernel<T, VEC, true>
        <<<grid, threads, 0, stream>>>(x, nb, dg, ws, o, k, w, f, wb);
  } else {
    spmm_ell_weighted_kernel<T, VEC, false>
        <<<grid, threads, 0, stream>>>(x, nb, dg, ws, o, k, w, f, wb);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  wb: weights per slot (1, or B = W / F
// for per-sample weights).  select: 1 for the broadcast and per-sample
// modes (skip slots of weight 0), 0 for the static mode (multiply).  vec: 1,
// or 16 bytes' worth of elements (4 float32 / 8 bfloat16) when F is a
// multiple of it and the feature and output pointers are 16-byte aligned
// (checked by the caller).  Returns cudaGetLastError() after the launch.
extern "C" int spmm_ell_weighted(const void* feats, int dtype, const void* nbr,
                                 const void* deg, const void* w_slot, void* out,
                                 int64_t n, int64_t k, int64_t w, int64_t f,
                                 int64_t wb, int select, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sel = select != 0;
  if (wb != 1 && wb != w / f) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(feats, nbr, deg, w_slot, out, n, k, w, f, wb, sel, s);
  }
  return static_cast<int>(err);
}
