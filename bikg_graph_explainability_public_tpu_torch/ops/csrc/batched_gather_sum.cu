// Weighted ELL gather-sum with per-slot, per-sample weights (Hopper, sm_90a).
//
//   out[v, s*F:(s+1)*F] = sum_{k < deg[v]} w_slot[v, k, s] * feats[nbr[v, k], s*F:(s+1)*F]
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), w_slot [N, K, B] float32,
// out [N, W] float32.  Sums accumulate in float32, slots in order; each term
// is w * x, so a valid slot of weight 0 still adds 0 * x.
//
// Replaces ops/spmm_pallas.py::batched_gather_sum of the JAX package: the
// weighted v7 schedule, spmm_ell_pallas(sched="v7") -> _spmm_v7 ->
// _kernel_v7 (spmm_pallas.py:1074) with weighted=True.
//
// Bound: memory.  One multiply-add per gathered element is far below the
// card's arithmetic rate.  The least any design could move is each distinct
// source row read once, the weights and indices of the valid slots read
// once and the output written once; a gather design reads each source row
// once per edge instead, about five times more at the 100k-node / 1M-edge
// shape.
//
// The simple design is kernel 2.3's (gather_sum_static.cu): one block per
// (destination row, column tile), threads striding over the row's columns
// with 16-byte loads, so a warp reads 512 contiguous bytes of one neighbour
// row per load; the row's indices are read through the broadcast path.
// Each thread's VEC columns lie in one sample (F % VEC == 0), so it reads
// one weight w_slot[v, k, col / F] per slot, which the F / VEC threads of
// that sample share through the same broadcast.  The TPU kernel relies on
// zero weights in invalid slots and sums all K; this one never reads slot
// k >= deg[v], so NaN in source rows that only invalid slots name cannot
// reach the sum (0 * NaN) and rows of degree 0 come out as exact zeros.
// Offsets are 64-bit: N * W is close to 2^31 at the production shape.
// What it does not do: reuse a source row across the destinations that
// share it (only the L2 cache does that) or balance rows of unequal degree.

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

template <typename T, int VEC>
__global__ void batched_gather_sum_kernel(const T* __restrict__ feats,
                                          const int32_t* __restrict__ nbr,
                                          const int32_t* __restrict__ deg,
                                          const float* __restrict__ w_slot,
                                          float* __restrict__ out, int64_t k,
                                          int64_t w, int64_t f, int64_t b) {
  const int64_t v = blockIdx.x;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= w) return;
  const int32_t d = deg[v];
  const int32_t* row = nbr + v * k;
  // VEC > 1 only when F % VEC == 0: the lanes share one sample index
  const float* wrow = w_slot + v * k * b + col / f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int32_t j = 0; j < d; ++j) {
    const int64_t src = __ldg(row + j);
    const float wt = __ldg(wrow + j * b);
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
                   int64_t f, cudaStream_t stream) {
  const int64_t lanes = w / VEC;  // threads needed per row
  int threads = 256;
  if (lanes < threads) threads = static_cast<int>((lanes + 31) / 32 * 32);
  const int64_t tiles = (lanes + threads - 1) / threads;
  if (n > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(tiles));
  batched_gather_sum_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(nbr),
      static_cast<const int32_t*>(deg), static_cast<const float*>(w_slot),
      static_cast<float*>(out), k, w, f, w / f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth of elements
// (4 float32 / 8 bfloat16) when F is a multiple of it and the feature and
// output pointers are 16-byte aligned (checked by the caller).  Returns
// cudaGetLastError() after the launch.
extern "C" int batched_gather_sum(const void* feats, int dtype, const void* nbr,
                                  const void* deg, const void* w_slot, void* out,
                                  int64_t n, int64_t k, int64_t w, int64_t f,
                                  int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(feats, nbr, deg, w_slot, out, n, k, w, f, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(feats, nbr, deg, w_slot, out, n, k, w, f, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(feats, nbr, deg, w_slot, out, n, k, w, f, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(feats, nbr, deg, w_slot, out, n, k, w, f, s);
  }
  return static_cast<int>(err);
}
