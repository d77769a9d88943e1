// Fused dense masked GCN layer over a batch of mask scalings (Hopper, sm_90a).
//
//   out[b, v, c] = act( s[b, v] * sum_u A[v, u] * bf16(s[b, u] * XW_b[u, c])
//                       + self_w[b, v] * XW_b[v, c] + bias[c] )
//
// A [N, N] bfloat16 (edge multiplicities, exact in bf16), s and self_w
// [B, N] float32, bias [C] float32 or null, out [B, N, C] float32; act is
// ReLU or the identity.  XW_b is either one batch-shared XW [N, C] float32
// (masked_gcn_agg with per_sample = 0) or per-sample XW [B, N, C] float32
// (per_sample = 1), which batched_transform computes first as h_b @ W in
// float32 from h [B, N, C_in] and W [C_in, C].
//
// Replaces ops/pallas_gcn.py of the JAX package: masked_gcn_layer ->
// _layer_kernel_shared (pallas_gcn.py:76) with the shared operand, and
// masked_gcn_layer_batched -> _layer_kernel_batched (pallas_gcn.py:104),
// whose h_b @ W runs inside the TPU kernel; here it is the first of two
// hand-written launches.
//
// Bound: operations.  The aggregation is a bf16 product of A [N, N] with the
// B samples' scaled operands side by side, [N, B*C]: 2 N^2 B C operations,
// 268 GFLOP at N = 2048, B = 250, C = 128, against about 0.8 GB of
// operands and output.  The transform adds 2 B N C_in C float32
// operations.
//
// The simple design.  The aggregation is one tiled bf16 tensor-core product
// (WMMA 16x16x16 fragments, float32 accumulation) over the columns
// j = b * C + c of all samples at once, so C = 16 and C = 128 tile alike.
// A block computes a 128 x 128 output tile with 8 warps (64 x 32 each) and
// walks K = N in steps of 32.  Its prologue builds the operand tile in
// shared memory: A's rows by 16-byte loads, and bf16(s * XW) for each
// column's own sample, rounded to nearest even as the TPU kernel's
// astype(bfloat16) rounds.  Its epilogue applies the destination scale, the
// self term, the bias and the ReLU on the way out.  Row tiles are the
// fast grid axis, so the blocks that share a column tile's operand run
// together and read it from L2.  Ragged edges (N, B*C not multiples of the
// tile) load zeros and store nothing.  What it does not do: wgmma, TMA or a
// multi-stage pipeline (one tile in shared memory at a time), or skip the
// zero blocks of a sparse A.
//
// The transform is a plain float32 tiled product: 64 x 64 tiles, 256
// threads of 4 x 4 outputs each, K in steps of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;          // 8 warps: 2 rows x 4 columns
constexpr int WM = 64, WN = 32;       // one warp's output tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int LDA = BK + 8;           // padded shared-memory strides (bf16)
constexpr int LDB = BN + 8;

template <bool PER_SAMPLE>
__global__ void __launch_bounds__(THREADS)
masked_gcn_agg_kernel(const __nv_bfloat16* __restrict__ adj,
                      const float* __restrict__ xw, const float* __restrict__ s,
                      const float* __restrict__ self_w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int64_t n, int64_t c, int64_t cols, bool relu, bool avec) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / (BN / WN), wc = warp % (BN / WN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;

  // the operand column this thread builds: j = n0 + tid % BN, rows
  // tid / BN + 2 i of each K step
  const int bj = tid % BN;
  const int brow = tid / BN;
  const int64_t jcol = n0 + bj;
  const bool jvalid = jcol < cols;
  const int64_t jb = jvalid ? jcol / c : 0;
  const int64_t jc = jvalid ? jcol % c : 0;
  const float* s_j = s + jb * n;
  const float* xw_j = (PER_SAMPLE ? xw + jb * n * c : xw) + jc;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int64_t k0 = 0; k0 < n; k0 += BK) {
    for (int t = tid; t < BM * BK / 8; t += THREADS) {
      const int r = t / (BK / 8);
      const int kc = (t % (BK / 8)) * 8;
      const int64_t gr = m0 + r, gk = k0 + kc;
      __nv_bfloat16* dst = As + r * LDA + kc;
      if (avec && gr < n && gk + 8 <= n) {
        *reinterpret_cast<uint4*>(dst) =
            __ldg(reinterpret_cast<const uint4*>(adj + gr * n + gk));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < n && gk + e < n) ? adj[gr * n + gk + e] : zero;
      }
    }
#pragma unroll 4
    for (int r = brow; r < BK; r += THREADS / BN) {
      const int64_t u = k0 + r;
      Bs[r * LDB + bj] = (jvalid && u < n)
                             ? __float2bfloat16(s_j[u] * xw_j[u * c])
                             : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wr * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * LDB + wc * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t v = m0 + wr * WM + i * 16 + e / 16;
        const int64_t col = n0 + wc * WN + j * 16 + e % 16;
        if (v < n && col < cols) {
          const int64_t b = col / c, ch = col % c;
          const float* xw_b = PER_SAMPLE ? xw + b * n * c : xw;
          float val = s[b * n + v] * sc[e] + self_w[b * n + v] * xw_b[v * c + ch];
          if (bias != nullptr) val += bias[ch];
          if (relu) val = fmaxf(val, 0.0f);
          out[(b * n + v) * c + ch] = val;
        }
      }
      __syncwarp();
    }
  }
}

constexpr int TM = 64, TN = 64, TK = 16;

__global__ void __launch_bounds__(256)
batched_transform_kernel(const float* __restrict__ h, const float* __restrict__ w,
                         float* __restrict__ out, int64_t rows, int64_t cin,
                         int64_t c) {
  __shared__ float Hs[TK][TM + 4];
  __shared__ float Ws[TK][TN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int64_t k0 = 0; k0 < cin; k0 += TK) {
    for (int t = threadIdx.x; t < TM * TK; t += 256) {
      const int m = t / TK, k = t % TK;
      const int64_t gr = r0 + m, gk = k0 + k;
      Hs[k][m] = (gr < rows && gk < cin) ? h[gr * cin + gk] : 0.0f;
    }
    for (int t = threadIdx.x; t < TK * TN; t += 256) {
      const int k = t / TN, nn = t % TN;
      const int64_t gk = k0 + k, gc = c0 + nn;
      Ws[k][nn] = (gk < cin && gc < c) ? w[gk * c + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Hs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = c0 + tx + 16 * j;
      if (col < c) out[r * c + col] = acc[i][j];
    }
  }
}

}  // namespace

// The aggregation with its prologue and epilogue.  per_sample: xw is
// [B, N, C] (else [N, C]); bias may be null; avec: N % 8 == 0 and adj is
// 16-byte aligned (checked by the caller).  Returns cudaGetLastError()
// after the launch.
extern "C" int masked_gcn_agg(const void* adj, const void* xw, const void* s,
                              const void* self_w, const void* bias, void* out,
                              int64_t n, int64_t c, int64_t b, int per_sample,
                              int relu, int avec, void* stream) {
  const int64_t cols = b * c;
  const int64_t row_tiles = (n + BM - 1) / BM;
  const int64_t col_tiles = (cols + BN - 1) / BN;
  if (n <= 0 || cols <= 0 || row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const __nv_bfloat16*>(adj);
  const auto* x = static_cast<const float*>(xw);
  const auto* sp = static_cast<const float*>(s);
  const auto* sw = static_cast<const float*>(self_w);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (per_sample) {
    masked_gcn_agg_kernel<true><<<grid, THREADS, 0, st>>>(a, x, sp, sw, bi, o, n, c,
                                                          cols, relu != 0, avec != 0);
  } else {
    masked_gcn_agg_kernel<false><<<grid, THREADS, 0, st>>>(a, x, sp, sw, bi, o, n, c,
                                                           cols, relu != 0, avec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [rows, C] = h [rows, C_in] @ w [C_in, C], float32.  Returns
// cudaGetLastError() after the launch.
extern "C" int batched_transform(const void* h, const void* w, void* out,
                                 int64_t rows, int64_t cin, int64_t c,
                                 void* stream) {
  const int64_t row_tiles = (rows + TM - 1) / TM;
  const int64_t col_tiles = (c + TN - 1) / TN;
  if (rows <= 0 || c <= 0 || row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  batched_transform_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<float*>(out), rows, cin, c);
  return static_cast<int>(cudaGetLastError());
}
