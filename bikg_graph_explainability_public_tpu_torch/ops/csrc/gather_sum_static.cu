// Static separable ELL gather-sum with a fused output scale (Hopper, sm_90a).
//
//   out[v, s*F:(s+1)*F] = post_scale[v, s] * sum_{k < deg[v]} feats[nbr[v, k], s*F:(s+1)*F]
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), post_scale [N, B] float32 or
// null, out [N, W] float32.  Sums accumulate in float32, slots in order.
//
// Replaces ops/spmm_pallas.py::gather_sum_static of the JAX package: the
// v7 schedule, spmm_ell_pallas(sched="v7") -> _spmm_v7 -> _kernel_v7
// (spmm_pallas.py:1074) in static mode with has_scale.  The same kernel
// without the scale is exported a second time as ell_valid_sum (end of
// file) for the v6 and v5 schedules.
//
// Bound: memory.  There is no arithmetic to speak of (one add per gathered
// element, one multiply per output element).  A gather design moves
// (sum_v deg[v] + N) * B*F * 4 bytes of float32 features (each neighbour row
// read once per edge, each output row written once; the count that the
// repo's bench.py:417 uses) plus the nbr, deg and post_scale reads.  The least
// any design could move is each distinct source row read once and the
// output written once.
//
// The simple design: one block per (destination row, column tile), threads
// striding over the row's columns with 16-byte loads (4 floats or 8 bf16)
// so that a warp reads 512 contiguous bytes of one neighbour row per load,
// and the whole row of neighbour indices is read through the broadcast path
// (every thread of the block reads the same index).  It never reads slot k
// of row v when k >= deg[v], so non-finite values in padded source rows
// cannot reach the sum and rows of degree 0 come out as exact zeros.
// Offsets are 64-bit: N * W comes close to 2^31 at the production shapes.
// What it does not do: reuse a source row across the destinations that
// share it (only the L2 cache does that), balance rows of unequal degree,
// or overlap the index reads with the feature loads beyond what the
// unrolled loop keeps in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void add(const float* p, float* acc) {
    acc[0] += __ldg(p);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void add(const float* p, float* acc) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] += x.x;
    acc[1] += x.y;
    acc[2] += x.z;
    acc[3] += x.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* p, float* acc) {
    acc[0] += __bfloat162float(p[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void add(const __nv_bfloat16* p, float* acc) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

template <typename T, int VEC, bool SCALE>
__global__ void gather_sum_static_kernel(const T* __restrict__ feats,
                                         const int32_t* __restrict__ nbr,
                                         const int32_t* __restrict__ deg,
                                         const float* __restrict__ post_scale,
                                         float* __restrict__ out, int64_t k,
                                         int64_t w, int64_t f, int64_t b) {
  const int64_t v = blockIdx.x;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
  if (col >= w) return;
  const int32_t d = deg[v];
  const int32_t* row = nbr + v * k;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int32_t j = 0; j < d; ++j) {
    const int64_t src = __ldg(row + j);
    Vec<T, VEC>::add(feats + src * w + col, acc);
  }
  if constexpr (SCALE) {
    // VEC > 1 only when F % VEC == 0: the lanes share one sample index
    const float sc = post_scale[v * b + col / f];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= sc;
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
            const void* post_scale, void* out, int64_t n, int64_t k, int64_t w,
            int64_t f, cudaStream_t stream) {
  const int64_t lanes = w / VEC;  // threads needed per row
  int threads = 256;
  if (lanes < threads) threads = static_cast<int>((lanes + 31) / 32 * 32);
  const int64_t tiles = (lanes + threads - 1) / threads;
  if (n > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(tiles));
  const T* x = static_cast<const T*>(feats);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const int32_t* dg = static_cast<const int32_t*>(deg);
  const float* ps = static_cast<const float*>(post_scale);
  float* o = static_cast<float*>(out);
  const int64_t b = w / f;
  if (ps != nullptr) {
    gather_sum_static_kernel<T, VEC, true>
        <<<grid, threads, 0, stream>>>(x, nb, dg, ps, o, k, w, f, b);
  } else {
    gather_sum_static_kernel<T, VEC, false>
        <<<grid, threads, 0, stream>>>(x, nb, dg, ps, o, k, w, f, b);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth of elements
// (4 float32 / 8 bfloat16) when W and F are multiples of it and the feature
// and output pointers are 16-byte aligned (checked by the caller).  Returns
// cudaGetLastError() after the launch.
extern "C" int gather_sum_static(const void* feats, int dtype, const void* nbr,
                                 const void* deg, const void* post_scale,
                                 void* out, int64_t n, int64_t k, int64_t w,
                                 int64_t f, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(feats, nbr, deg, post_scale, out, n, k, w, f, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(feats, nbr, deg, post_scale, out, n, k, w, f, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(feats, nbr, deg, post_scale, out, n, k, w, f, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(feats, nbr, deg, post_scale, out, n, k, w, f, s);
  }
  return static_cast<int>(err);
}

// The valid-prefix sum without an output scale: the unscaled instantiation
// above, exported under its own name so that its launches count apart from
// kernel 2.3's.  Replaces the JAX package's spmm_ell_pallas with sched="v6"
// (-> _kernel_v6, spmm_pallas.py:867) and sched="v5" (-> _kernel_v5 :549):
// both sum the valid slots of each row and differ from v7 only in how the
// TPU schedules its row DMAs.
extern "C" int ell_valid_sum(const void* feats, int dtype, const void* nbr,
                             const void* deg, void* out, int64_t n, int64_t k,
                             int64_t w, int64_t f, int vec, void* stream) {
  return gather_sum_static(feats, dtype, nbr, deg, nullptr, out, n, k, w, f, vec, stream);
}
