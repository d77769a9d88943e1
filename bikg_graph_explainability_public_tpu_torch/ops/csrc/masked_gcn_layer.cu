// Fused dense masked GCN layer over a batch of mask scalings (Hopper, sm_90a).
//
//   out[b, v, c] = act( s[b, v] * sum_u A[v, u] * bf16(s[b, u] * XW_b[u, c])
//                       + self_w[b, v] * XW_b[v, c] + bias[c] )
//
// A [N, N] bfloat16 (edge multiplicities, exact in bf16) with a row stride
// `ld` that is a multiple of 8 (the wrapper pads a copy when N is not), s
// and self_w [B, N] float32, bias [C] float32 or null, out [B, N, C]
// float32; act is ReLU or the identity.  XW_b is either one batch-shared XW
// [N, C] float32 (kernel 2.1) or per-sample XW [B, N, C] float32 (kernel
// 2.2), which batched_transform computes as h_b @ W in float32.
//
// Replaces ops/pallas_gcn.py of the JAX package: masked_gcn_layer ->
// _layer_kernel_shared (pallas_gcn.py:76) with the shared operand, and
// masked_gcn_layer_batched -> _layer_kernel_batched (pallas_gcn.py:104).
//
// Bound: operations.  The aggregation is a bf16 product of A [N, N] with the
// B samples' scaled operands side by side: 2 N^2 B C operations, 268 GFLOP
// at N = 2048, B = 250, C = 128 (0.27 ms at the dense bf16 peak), against
// about 0.8 GB of operands and output.  2.2's transform adds 2 B N C_in C
// float32 operations.
//
// The design, two launches per layer:
//
// 1. The scaled operand, written once to device memory, K-major:
//    S^T [B*C, ld] bf16, row j = b*C + c, column u, holding
//    bf16(s[b, u] * XW_b[u, c]) rounded to nearest even (the TPU kernel's
//    astype(bfloat16)).  For 2.1 scaled_operand builds it from XW (held in
//    L2) through a shared-memory transpose with 16-byte stores; for 2.2 the
//    float32 transform writes it from its epilogue beside hw.  The TPU
//    kernel kept this operand in VMEM; here it costs one write and one read
//    of B*C*N bf16 (131 MB at the production shape).
// 2. The aggregation, a warp-specialised, persistent TMA + wgmma GEMM over
//    128 x 128 tiles of (v, j), one block per SM.  One producer thread
//    keeps a 4-stage ring of A [128 x 64] and S^T [128 x 64] tiles in
//    flight with cp.async.bulk.tensor under the 128-byte swizzle, each stage
//    tracked by a full and an empty mbarrier, tile after tile.  Two consumer
//    warpgroups take the block's tiles in turn ("ping-pong"): each issues
//    wgmma.mma_async m64n128k16 for both 64-row halves of its tile (bf16
//    in, float32 accumulators in registers) straight from the swizzled
//    tiles, keeping one k-tile's group in flight, and hands the tensor
//    cores to the other warpgroup (an mbarrier each way) once its last
//    k-tile is issued.  Its epilogue then runs under the other's products,
//    straight from the accumulators: the scale s[b, v], the self term
//    self_w[b, v] * XW_b[v, c], bias and ReLU, with 8-byte loads and stores
//    issued in groups of 32 columns so that a group's loads are in flight
//    together.  setmaxnreg gives the consumers 240 registers (128
//    accumulators and a group's operands without spilling), the producer
//    24.  Row tiles are the fast tile axis, so the tiles in flight share a
//    few column tiles of S^T (read from L2) and all of A.  Ragged N and B*C
//    come from TMA's zero fill and a masked epilogue.
//
//    The ring has 4 stages: a deeper one is slower, since it takes L1's
//    share of the SM's 256 KB and the epilogue's loads go through L1.  Its
//    times and where they go (chip_smoke.py, scripts/dense_layer_breakdown.py)
//    are in PERF.md.
//
// batched_transform is a register-tiled float32 SIMT product (128 x 128
// tiles, 8 x 8 outputs a thread, double-buffered shared memory).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// the aggregation
// ---------------------------------------------------------------------------

constexpr int BM = 128;                      // rows v of a tile: two m64 halves
constexpr int BN = 128;                      // columns j of a tile: m64n128k16
constexpr int BK = 64;                       // 64 bf16 = 128 bytes, the swizzle's width
constexpr int STAGES = 4;
constexpr int THREADS = 384;                 // warpgroups 0, 1 consume in turn; 2 produces
constexpr int A_BYTES = BM * BK * 2;         // 16 KB
constexpr int B_BYTES = BN * BK * 2;         // 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + room to align to 1 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// seconds means a broken pipeline: trap (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle (what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes): start address,
// leading offset 16 B (unused by this layout), 1024 B between 8-row groups,
// layout type 1 (128-byte swizzle).  A k16 step inside the 64-wide tile
// adds 32 bytes to the start address (2 in the descriptor's units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

struct Epilogue {
  const float* xw;      // [N, C] shared, or [B, N, C] per sample
  const float* s;       // [B, N]
  const float* self_w;  // [B, N]
  const float* bias;    // [C] or null
  float* out;           // [B, N, C]
  int n, c, cols, relu, vec;
};

__device__ __forceinline__ float act(float x, int relu) { return relu ? fmaxf(x, 0.0f) : x; }

// The layer's epilogue for one tile, straight from the accumulators.  In
// wgmma's layout a thread holds the rows v0 + {0, 8} (d0) and v0 + {64, 72}
// (d1) and, for i = 0 .. 15, the columns j0 + 8 i and j0 + 8 i + 1 (j0 = n0 +
// 2 (lane % 4)): d[4 i + 2 r + e] is row v0 + 8 r, column j0 + 8 i + e.  A
// quad of lanes covers 32 contiguous bytes of a row, so the 8-byte loads and
// stores use whole sectors.
//
// With e.vec (C % 32 == 0; xw, bias and out 8-byte aligned) the columns go
// in groups of 32, each inside one sample: a group's scales s[b, v] and
// self_w[b, v] are loaded once per row, and all of its loads are issued
// before its first store, so that they are in flight together (the
// compiler may not move a load above a store that could alias it).  Any
// other input takes the elementwise path.
template <bool PER_SAMPLE>
__device__ __forceinline__ void finish_tile(const float (&d0)[64], const float (&d1)[64], int v0,
                                            int j0, int n0, const Epilogue& e) {
  const int64_t n = e.n, c = e.c;
  const int vr[4] = {v0, v0 + 8, v0 + 64, v0 + 72};
  if (e.vec) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int jg = n0 + 32 * g;  // the group's first column
      if (jg >= e.cols) break;
      const int b = jg / e.c;
      const int ch = j0 + 32 * g - b * e.c;  // this thread's first channel
      const int64_t rb = b * n;
      float2 bb[4], x[4][4];
      float sv[4], sw[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        bb[ii] = e.bias != nullptr ? __ldg(reinterpret_cast<const float2*>(e.bias + ch + 8 * ii))
                                   : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (vr[k] < e.n) {
          const int64_t row = rb + vr[k];
          sv[k] = __ldg(e.s + row);
          sw[k] = __ldg(e.self_w + row);
          const float* xr = e.xw + (PER_SAMPLE ? row : vr[k]) * c + ch;
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) x[ii][k] = __ldg(reinterpret_cast<const float2*>(xr + 8 * ii));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (vr[k] >= e.n) break;
        float* orow = e.out + (rb + vr[k]) * c + ch;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = 4 * g + ii;
          const float a0 = k < 2 ? d0[4 * i + 2 * k] : d1[4 * i + 2 * (k - 2)];
          const float a1 = k < 2 ? d0[4 * i + 2 * k + 1] : d1[4 * i + 2 * (k - 2) + 1];
          const float o0 = act(sv[k] * a0 + sw[k] * x[ii][k].x + bb[ii].x, e.relu);
          const float o1 = act(sv[k] * a1 + sw[k] * x[ii][k].y + bb[ii].y, e.relu);
          *reinterpret_cast<float2*>(orow + 8 * ii) = make_float2(o0, o1);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = vr[k];
      if (v >= e.n) break;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = j0 + 8 * i + q;
          if (j >= e.cols) continue;
          const int b = j / e.c, ch = j - b * e.c;
          const int64_t row = b * n + v;
          const float a = k < 2 ? d0[4 * i + 2 * k + q] : d1[4 * i + 2 * (k - 2) + q];
          float o = e.s[row] * a + e.self_w[row] * e.xw[(PER_SAMPLE ? row : v) * c + ch];
          if (e.bias != nullptr) o += e.bias[ch];
          e.out[row * c + ch] = act(o, e.relu);
        }
      }
    }
  }
}

// A persistent grid, one block per SM; block g takes the tiles g, g + G,
// g + 2G, ... (G blocks), and its two consumer warpgroups take them in
// turn.  Tile t covers rows (t % row_tiles) * BM and columns
// (t / row_tiles) * BN: row tiles are the fast axis.
template <bool PER_SAMPLE>
__global__ void __launch_bounds__(THREADS, 1)
masked_gcn_agg_kernel(__grid_constant__ const CUtensorMap map_a,
                      __grid_constant__ const CUtensorMap map_s, const Epilogue e,
                      int row_tiles, int tiles) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t turn[2];
  // the 128-byte swizzle repeats every 1 KB: tiles start on 1 KB boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int ktiles = (e.n + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_u32(&full[i]), 1);   // the producer's expect_tx arrival
      mbar_init(smem_u32(&empty[i]), 4);  // lane 0 of each warp of one consumer warpgroup
    }
    mbar_init(smem_u32(&turn[0]), 4);
    mbar_init(smem_u32(&turn[1]), 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every k-tile's two TMA loads, tile after
    // tile, as far ahead as the ring allows
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % row_tiles) * BM, n0 = (t / row_tiles) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(smem_u32(&empty[st]), ((it / STAGES) & 1) ^ 1);
          const uint32_t fb = smem_u32(&full[st]);
          // out-of-bounds elements are zero-filled and count in the bytes
          mbar_expect_tx(fb, STAGE_BYTES);
          const uint32_t sa = base + st * STAGE_BYTES;
          tma_load_2d(sa, &map_a, fb, kt * BK, m0);
          tma_load_2d(sa + A_BYTES, &map_s, fb, kt * BK, n0);
        }
      }
    }
  } else {
    // consumers: warpgroup wg takes the block's tiles q = wg, wg + 2, ...
    // Their products take the tensor cores in turn: tile q's begin when
    // all of tile q - 1's have been issued (the `turn` barriers), so one
    // warpgroup's epilogue runs under the other's products, and a
    // warpgroup never waits on a ring phase more than one round ahead.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    int waits = 0;
    float d0[64], d1[64];
    for (int q = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;
         q += 2, tile += 2 * gridDim.x) {
      if (q > 0) mbar_wait(smem_u32(&turn[wg]), (waits++) & 1);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        d0[i] = 0.0f;
        d1[i] = 0.0f;
      }
      int it = q * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int st = it % STAGES;
        mbar_wait(smem_u32(&full[st]), (it / STAGES) & 1);
        const uint32_t sa = base + st * STAGE_BYTES;
        const uint64_t da = sw128_desc(sa);
        const uint64_t db = sw128_desc(sa + A_BYTES);
        pin(d0);
        pin(d1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_m64n128k16(d0, da + 2 * kk, db + 2 * kk);
          // rows 64 .. 127 of the A tile: 64 rows of 128 bytes further
          wgmma_m64n128k16(d1, da + (64 * 128 >> 4) + 2 * kk, db + 2 * kk);
        }
        wgmma_commit();
        // the previous k-tile's group has retired: its stage is free
        wgmma_wait<1>();
        pin(d0);
        pin(d1);
        if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
      }
      // every k-tile of this tile has arrived and is issued: the other
      // warpgroup's products may queue behind the last group
      if (lane == 0) mbar_arrive(smem_u32(&turn[wg ^ 1]));
      wgmma_wait<0>();
      pin(d0);
      pin(d1);
      if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
      const int m0 = (tile % row_tiles) * BM, n0 = (tile / row_tiles) * BN;
      const int v0 = m0 + warp * 16 + lane / 4, j0 = n0 + 2 * (lane % 4);
      finish_tile<PER_SAMPLE>(d0, d1, v0, j0, n0, e);
    }
  }
}

// ---------------------------------------------------------------------------
// the scaled operand of 2.1 and the float32 transform of 2.2
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&p);
}

constexpr int OU = 64, OC = 64, OB = 8;  // a block: 64 nodes x 64 channels x 8 samples

// st[b*C + c, u] = bf16(s[b, u] * xw[u, c]); the tiles of xw and s are
// staged in shared memory (zeros past N: the padding columns come out 0),
// and xw's is transposed there, 8 nodes per 16-byte store
__global__ void __launch_bounds__(256)
scaled_operand_kernel(const float* __restrict__ xw, const float* __restrict__ s,
                      __nv_bfloat16* __restrict__ st, int64_t n, int c, int64_t b, int64_t ld) {
  __shared__ float xs[OU][OC + 1];
  __shared__ float ss[OB][OU];
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * OU;
  const int c0 = blockIdx.y * OC;
  const int64_t b0 = static_cast<int64_t>(blockIdx.z) * OB;
  for (int i = threadIdx.x; i < OU * OC; i += 256) {
    const int uu = i / OC, cc = i % OC;
    const int64_t u = u0 + uu;
    const int col = c0 + cc;
    xs[uu][cc] = (u < n && col < c) ? xw[u * c + col] : 0.0f;
  }
  for (int i = threadIdx.x; i < OB * OU; i += 256) {
    const int bb = i / OU, uu = i % OU;
    const int64_t bi = b0 + bb, u = u0 + uu;
    ss[bb][uu] = (bi < b && u < n) ? s[bi * n + u] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < OB * OC * (OU / 8); i += 256) {
    const int uv = i % (OU / 8);
    const int cc = (i / (OU / 8)) % OC;
    const int bb = i / ((OU / 8) * OC);
    const int64_t bi = b0 + bb, u = u0 + uv * 8;
    const int col = c0 + cc;
    if (bi >= b || col >= c || u >= n) continue;
    uint32_t w4[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int e = uv * 8 + 2 * p;
      w4[p] = pack_bf16(ss[bb][e] * xs[e][cc], ss[bb][e + 1] * xs[e + 1][cc]);
    }
    // u < n and ld = N rounded up to 8: the 8 columns lie inside the row
    *reinterpret_cast<uint4*>(st + (bi * c + col) * ld + u) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
}

constexpr int TM = 128, TN = 128, TK = 8;

// hw [rows, C] = h [rows, C_in] @ w [C_in, C] in float32 (rows = B*N), and
// st[b*C + c, u] = bf16(s[b, u] * hw[b*N + u, c]).  256 threads of 8 x 8
// outputs: rows ty*8 .. +7, columns tx*4 .. +3 and 64 + tx*4 .. +3.
__global__ void __launch_bounds__(256, 2)
batched_transform_kernel(const float* __restrict__ h, const float* __restrict__ w,
                         const float* __restrict__ s, float* __restrict__ hw,
                         __nv_bfloat16* __restrict__ st, int64_t rows, int64_t n, int cin, int c,
                         int64_t ld, int vec) {
  __shared__ __align__(16) float Hs[2][TK][TM + 4];
  __shared__ __align__(16) float Ws[2][TK][TN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * TM;
  const int c0 = blockIdx.y * TN;
  const int hm = t / 2, hk = (t % 2) * 4;   // loads h[r0 + hm, k0 + hk .. +3]
  const int wk = t / 32, wc = (t % 32) * 4;  // loads w[k0 + wk, c0 + wc .. +3]
  float hr[4], wr[4];

  auto load = [&](int k0) {
    const int64_t r = r0 + hm;
    const int k = k0 + hk;
    if (vec && r < rows && k < cin) {
      const float4 v = *reinterpret_cast<const float4*>(h + r * cin + k);
      hr[0] = v.x; hr[1] = v.y; hr[2] = v.z; hr[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) hr[i] = (r < rows && k + i < cin) ? h[r * cin + k + i] : 0.0f;
    }
    const int kw = k0 + wk, col = c0 + wc;
    if (vec && kw < cin && col < c) {
      const float4 v = *reinterpret_cast<const float4*>(w + static_cast<int64_t>(kw) * c + col);
      wr[0] = v.x; wr[1] = v.y; wr[2] = v.z; wr[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wr[i] = (kw < cin && col + i < c) ? w[static_cast<int64_t>(kw) * c + col + i] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) Hs[buf][hk + i][hm] = hr[i];
    *reinterpret_cast<float4*>(&Ws[buf][wk][wc]) = make_float4(wr[0], wr[1], wr[2], wr[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int ktiles = (cin + TK - 1) / TK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load((kt + 1) * TK);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Hs[buf][k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Hs[buf][k][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) store(buf ^ 1);
    __syncthreads();
  }

  // hw, for the self term
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = r0 + ty * 8 + i;
    if (r >= rows) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = c0 + half * 64 + tx * 4;
      if (vec && col < c) {
        *reinterpret_cast<float4*>(hw + r * c + col) =
            make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                        acc[i][half * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < c) hw[r * c + col + e] = acc[i][half * 4 + e];
      }
    }
  }

  // the scaled operand, transposed: a thread's 8 rows are 8 consecutive
  // nodes u of one sample when they start on a multiple of 8 inside it
  const int64_t rr = r0 + ty * 8;
  if (rr >= rows) return;
  const int64_t b = rr / n, u = rr - b * n;
  float sv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sv[i] = rr + i < rows ? s[rr + i] : 0.0f;  // s[b, u] = s[b*N + u]
  const bool whole = u % 8 == 0 && u + 8 <= n && rr + 8 <= rows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + half * 64 + tx * 4 + e;
      const int jc = half * 4 + e;
      if (col >= c) continue;
      if (whole) {
        *reinterpret_cast<uint4*>(st + (b * c + col) * ld + u) = make_uint4(
            pack_bf16(sv[0] * acc[0][jc], sv[1] * acc[1][jc]),
            pack_bf16(sv[2] * acc[2][jc], sv[3] * acc[3][jc]),
            pack_bf16(sv[4] * acc[4][jc], sv[5] * acc[5][jc]),
            pack_bf16(sv[6] * acc[6][jc], sv[7] * acc[7][jc]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int64_t r = rr + i;
          if (r >= rows) break;
          const int64_t bi = r / n, ui = r - bi * n;
          st[(bi * c + col) * ld + ui] = __float2bfloat16_rn(sv[i] * acc[i][jc]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands it out, so
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [outer, inner] bf16 matrix with row stride ld (elements), read in
// boxes of [box_outer, 64] under the 128-byte swizzle, zeros out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int64_t inner, int64_t outer, int64_t ld,
              uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The aggregation.  adj [N, ld] bf16 and st [B*C, ld] bf16 (ld % 8 == 0,
// ld >= N, both 16-byte aligned); per_sample: xw is [B, N, C] (else
// [N, C]); bias may be null; vec: C % 32 == 0 and xw, bias, out 8-byte
// aligned (checked by the caller).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue if a tensor map cannot be encoded.
extern "C" int masked_gcn_agg(const void* adj, const void* st, const void* xw, const void* s,
                              const void* self_w, const void* bias, void* out, int64_t n,
                              int64_t ld, int64_t c, int64_t b, int per_sample, int relu,
                              int vec, void* stream) {
  const int64_t cols = b * c;
  const int64_t row_tiles = (n + BM - 1) / BM;
  const int64_t tiles = row_tiles * ((cols + BN - 1) / BN);
  if (n <= 0 || cols <= 0 || c <= 0 || ld < n || ld % 8 != 0 || n > 0x7fffffffLL ||
      cols > 0x7fffffffLL - 8 * BN || tiles > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(adj) % 16 != 0 || reinterpret_cast<uintptr_t>(st) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap map_a, map_s;
  if (!make_map(&map_a, adj, n, n, ld, BM) || !make_map(&map_s, st, n, cols, ld, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  const Epilogue e{static_cast<const float*>(xw),   static_cast<const float*>(s),
                   static_cast<const float*>(self_w), static_cast<const float*>(bias),
                   static_cast<float*>(out),        static_cast<int>(n),
                   static_cast<int>(c),             static_cast<int>(cols),
                   relu,                            vec};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int rt = static_cast<int>(row_tiles), nt = static_cast<int>(tiles);
  if (per_sample) {
    cudaFuncSetAttribute(masked_gcn_agg_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    masked_gcn_agg_kernel<true><<<grid, THREADS, SMEM_BYTES, strm>>>(map_a, map_s, e, rt, nt);
  } else {
    cudaFuncSetAttribute(masked_gcn_agg_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    masked_gcn_agg_kernel<false><<<grid, THREADS, SMEM_BYTES, strm>>>(map_a, map_s, e, rt, nt);
  }
  return static_cast<int>(cudaGetLastError());
}

// 2.1's operand: st [B*C, ld] bf16 from xw [N, C] and s [B, N] float32
// (ld % 8 == 0, ld >= N, st 16-byte aligned).  Returns cudaGetLastError().
extern "C" int scaled_operand(const void* xw, const void* s, void* st, int64_t n, int64_t c,
                              int64_t b, int64_t ld, void* stream) {
  const int64_t u_tiles = (n + OU - 1) / OU, c_tiles = (c + OC - 1) / OC, b_tiles = (b + OB - 1) / OB;
  if (n <= 0 || c <= 0 || b <= 0 || ld < n || ld % 8 != 0 || u_tiles > 0x7fffffffLL ||
      c_tiles > 65535 || b_tiles > 65535 || reinterpret_cast<uintptr_t>(st) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(u_tiles), static_cast<unsigned>(c_tiles),
                  static_cast<unsigned>(b_tiles));
  scaled_operand_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(st), n, static_cast<int>(c), b, ld);
  return static_cast<int>(cudaGetLastError());
}

// 2.2's transform: hw [B*N, C] = h [B*N, C_in] @ w [C_in, C] float32, and
// its operand st [B*C, ld] bf16 (ld % 8 == 0, ld >= N, st 16-byte
// aligned); vec: C_in % 4 == 0, C % 4 == 0 and h, w, hw 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int batched_transform(const void* h, const void* w, const void* s, void* hw,
                                 void* st, int64_t b, int64_t n, int64_t cin, int64_t c,
                                 int64_t ld, int vec, void* stream) {
  const int64_t rows = b * n;
  const int64_t row_tiles = (rows + TM - 1) / TM;
  const int64_t col_tiles = (c + TN - 1) / TN;
  if (rows <= 0 || c <= 0 || cin < 0 || ld < n || ld % 8 != 0 || cin > 0x7fffffffLL ||
      row_tiles > 0x7fffffffLL || col_tiles > 65535 ||
      reinterpret_cast<uintptr_t>(st) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  batched_transform_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const float*>(s),
      static_cast<float*>(hw), static_cast<__nv_bfloat16*>(st), rows, n,
      static_cast<int>(cin), static_cast<int>(c), ld, vec);
  return static_cast<int>(cudaGetLastError());
}
