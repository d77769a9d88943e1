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
// What bounded the simple design (one block per destination row and
// 1024-column tile): a column tile of all N source rows spans 410 MB, so
// every slot fetched its source segment from HBM again: 25.6 GB of gathers
// and 2.56 GB of output, 5.5x the bound, at the HBM rate (8.55 ms).
//
// The band walk (static and broadcast weights).  A work item is (band of
// `band` columns, chunk of `rows` destination rows), numbered band-major;
// each warp takes its items from a global counter (zeroed by the caller),
// the next one while it works on the current, so the warps in flight cover
// less than one band whatever order the hardware runs them in.  A band's
// source columns, N x band x itemsize bytes, stay in L2 while every
// destination row is summed over them: HBM carries each feature byte about
// once and the repeated gathers are L2 hits.  Per item the warp stages the
// chunk's degrees (read ahead, during the previous item), then the valid
// prefixes of its indices and weights, in its own shared memory, up to
// kt = 512 / rows slots a row at a time.  Each row's band / VEC lanes then
// gather its valid prefix, up to 16 slots at once, with cp.async: 16 bytes a
// lane into shared memory, not registers, so that a warp has two rows' whole
// prefixes in flight (8 KB) at four blocks an SM.  In the select modes the
// copies are predicated rather than branched, since the two rows of a warp
// skip different slots.  Sums go out with streaming stores (st.global.cs),
// so that the 2.56 GB of output do not push the band out of L2.  Scalar
// lanes (F not a multiple of 16 bytes) gather into registers.  No warp waits
// for another, so nothing can hang.
//
// Band chosen: 256 bytes of each source row, 64 float32 / 128 bfloat16
// columns, 25.6 MB at N = 100000; spmm_cuda.band_plan halves it while
// N x band x itemsize exceeds its L2 budget.  Swept on the H100
// (scripts/ell_band_sweep.py): 32 and 48 columns were slower (more items and
// index reads per byte gathered), and an L2 evict_last policy on the
// gathers gained nothing once they went through cp.async (PERF.md).
//
// The per-sample mode keeps the simple design (spmm_ell_row_kernel): a band
// lies in one sample, so the walk would read one weight per 32-byte sector
// of [N, K, B] (32 MB a band, 3.2 GB a call); it measured slower there than
// this schedule, which reads 8 samples' weights per sector, and a
// sample-major copy of the weights cost more than it saved.
//
// Both schedules: slot k >= deg[v] is never read (NaN in source rows that
// only invalid slots name cannot reach the sum, rows of degree 0 come out as
// exact zeros); in the select modes the source row of a slot of weight 0 is
// never read; the static mode multiplies and keeps 0 * NaN; offsets are
// 64-bit (N * W is above 2^31 at the production shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // threads of a block; each warp takes its own items
constexpr int kWarps = kThreads / 32;
constexpr int kWarpStage = 512;      // slots a warp stages at a time
constexpr int kStagePerLane = kWarpStage / 32;
constexpr int kWarpRows = 256;       // rows of a work item at most
constexpr int kBatch = 16;           // slots of a row in flight (cp.async path)
constexpr int kUnroll = 8;           // slots of a row in flight (register path)

// One warp's shared memory: the landing slots of its cp.async gathers (one
// 16-byte slot per lane and slot of the batch) and its staged item.
struct WarpSmem {
  uint4 gather[kBatch * 32];
  int32_t nbr[kWarpStage];
  float w[kWarpStage];
  int32_t deg[kWarpRows];
};
constexpr int kSmemBytes = kWarps * static_cast<int>(sizeof(WarpSmem));

// The scalar lanes' feature loads: read-only, no L1 allocation (no reuse
// for a random graph).  volatile: a load must not be hoisted above the test
// that guards it (slot valid, weight non-zero).
template <typename Raw>
__device__ __forceinline__ Raw load_band(const void* p);

template <>
__device__ __forceinline__ uint32_t load_band<uint32_t>(const void* p) {
  uint32_t r;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

template <>
__device__ __forceinline__ uint16_t load_band<uint16_t>(const void* p) {
  uint16_t r;
  asm volatile("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(r) : "l"(p));
  return r;
}

// 16 bytes from global memory to this lane's shared slot, past L1, where
// `take` holds (predicated, not branched).
__device__ __forceinline__ void copy16_if(bool take, uint4* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
               "@p cp.async.cg.shared.global [%0], [%1], 16;\n\t}"
               :: "r"(d), "l"(src), "r"(static_cast<int>(take)) : "memory");
}

// This thread's cp.async copies have landed (each lane reads only its own).
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// One lane's VEC columns: their raw bits and the multiply-add of those into
// the float32 sums.
template <typename T, int VEC>
struct Lane;

template <>
struct Lane<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    acc[0] += w * __uint_as_float(x.x);
    acc[1] += w * __uint_as_float(x.y);
    acc[2] += w * __uint_as_float(x.z);
    acc[3] += w * __uint_as_float(x.w);
  }
};

template <>
struct Lane<float, 1> {
  using Raw = uint32_t;
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    acc[0] += w * __uint_as_float(x);
  }
};

template <>
struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    const uint32_t h[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += w * bf16_lo(h[i]);
      acc[2 * i + 1] += w * bf16_hi(h[i]);
    }
  }
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using Raw = uint16_t;
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    acc[0] += w * __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
};

// Whether the band walk's lanes gather through cp.async (16-byte lanes).
template <typename T, int VEC>
constexpr bool kAsync = sizeof(T) * VEC == 16;

// Adds d slots of one row to acc, in order; rn / rw are the row's staged
// indices and weights.  A slot whose weight is 0 in the select modes is
// neither read nor summed.
template <typename T, int VEC, bool SELECT>
__device__ __forceinline__ void sum_row(float* acc, const T* __restrict__ feats, int64_t w,
                                        int64_t col, const int32_t* rn, const float* rw, int d,
                                        uint4* gather, int lane) {
  using L = Lane<T, VEC>;
  if constexpr (kAsync<T, VEC>) {
    // the segments land in shared memory: the whole valid prefix in flight
    for (int jj = 0; jj < d; jj += kBatch) {
      if constexpr (SELECT) {
        // the two rows of a warp skip different slots: predicated copies, so
        // that the rows' copies issue together; a slot not taken adds 0 * 0
        // (its shared slot is not read), as the plain version adds
        // where(take, term, 0)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = jj + u;
          const float wt = j < d ? rw[j] : 0.0f;
          const bool take = j < d && wt != 0.0f;
          copy16_if(take, gather + u * 32 + lane,
                    feats + static_cast<int64_t>(take ? rn[j] : 0) * w + col);
        }
        copies_landed();
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = jj + u;
          const float wt = j < d ? rw[j] : 0.0f;
          const bool take = j < d && wt != 0.0f;
          const uint4 x = gather[u * 32 + lane];
          L::fma(take ? x : uint4{0u, 0u, 0u, 0u}, take ? wt : 0.0f, acc);
        }
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = jj + u;
          if (j < d) copy16_if(true, gather + u * 32 + lane, feats + static_cast<int64_t>(rn[j]) * w + col);
        }
        copies_landed();
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (jj + u < d) L::fma(gather[u * 32 + lane], rw[jj + u], acc);
        }
      }
    }
  } else {
    for (int jj = 0; jj < d; jj += kUnroll) {
      typename L::Raw x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = jj + u;
        x[u] = typename L::Raw{};
        if (j < d && (!SELECT || rw[j] != 0.0f)) {
          x[u] = load_band<typename L::Raw>(feats + static_cast<int64_t>(rn[j]) * w + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = jj + u;
        if (j < d && (!SELECT || rw[j] != 0.0f)) L::fma(x[u], rw[j], acc);
      }
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_stream(float* o, const float* acc) {
  if constexpr (VEC == 1) {
    __stcs(o, acc[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      __stcs(reinterpret_cast<float4*>(o + i), make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
    }
  }
}

// The band walk: static and broadcast weights, w_slot [N, K].
template <typename T, int VEC, bool SELECT>
__global__ void __launch_bounds__(kThreads)
spmm_ell_band_kernel(const T* __restrict__ feats, const int32_t* __restrict__ nbr,
                     const int32_t* __restrict__ deg, const float* __restrict__ w_slot,
                     float* __restrict__ out, int64_t n, int64_t k, int64_t w, int band,
                     int rows, int* __restrict__ counter) {
  extern __shared__ uint4 smem[];
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem)[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;

  const int lanes = band / VEC;          // lanes of one row
  const int per_pass = 32 / lanes;       // rows a warp sums side by side
  const int lrow = lane / lanes;         // this lane's row within a pass
  const int64_t lcol = static_cast<int64_t>(lane % lanes) * VEC;
  const int kt = kWarpStage / rows;      // slots of a row staged at a time
  const int64_t chunks = (n + rows - 1) / rows;
  const int64_t items = chunks * ((w + band - 1) / band);

  // the degree of row `lane` of an item (0 past its rows)
  auto first_deg = [&](int it) {
    const int64_t v = it % chunks * rows + lane;
    return it < items && lane < rows && v < n ? __ldg(deg + v) : 0;
  };
  int item = 0;
  if (lane == 0) item = atomicAdd(counter, 1);
  item = __shfl_sync(0xffffffffu, item, 0);
  int pdeg = first_deg(item);  // read ahead: the degrees of the item's first 32 rows
  while (item < items) {
    // take the next item now; its number is read once this one is staged
    int next = 0;
    if (lane == 0) next = atomicAdd(counter, 1);
    const int64_t c0 = item / chunks * band;  // the band's first column
    const int64_t v0 = item % chunks * rows;  // the chunk's first row
    const int nrows = static_cast<int>(n - v0 < rows ? n - v0 : rows);
    int maxdeg = 0;
    for (int r = lane; r < nrows; r += 32) {
      const int d = r < 32 ? pdeg : __ldg(deg + v0 + r);
      sm.deg[r] = d;
      maxdeg = max(maxdeg, d);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) maxdeg = max(maxdeg, __shfl_xor_sync(0xffffffffu, maxdeg, o));
    __syncwarp();
    const int64_t col = c0 + lcol;
    const bool on = lrow < per_pass && col < w;

    // slot tiles: one when every row's valid prefix fits (kt >= deg); a
    // later tile adds to the sums the earlier one stored (the same lane's row)
    for (int j0 = 0; j0 == 0 || j0 < maxdeg; j0 += kt) {
      // all of a lane's staging loads in flight at once, then the stores
      int32_t pn[kStagePerLane];
      float pw[kStagePerLane];
#pragma unroll
      for (int t = 0; t < kStagePerLane; ++t) {
        const int i = lane + 32 * t;
        const int r = i / kt;
        const int j = j0 + (i - r * kt);
        if (i < nrows * kt && j < sm.deg[r]) {
          pn[t] = __ldg(nbr + (v0 + r) * k + j);
          pw[t] = __ldg(w_slot + (v0 + r) * k + j);
        }
      }
#pragma unroll
      for (int t = 0; t < kStagePerLane; ++t) {
        const int i = lane + 32 * t;
        const int r = i / kt;
        if (i < nrows * kt && j0 + (i - r * kt) < sm.deg[r]) {
          sm.nbr[i] = pn[t];
          sm.w[i] = pw[t];
        }
      }
      __syncwarp();
      if (j0 == 0) {  // the next item's number and degrees, in flight during the gathers
        next = __shfl_sync(0xffffffffu, next, 0);
        pdeg = first_deg(next);
      }
      if (on) {
        for (int r = lrow; r < nrows; r += per_pass) {
          const int d = min(sm.deg[r] - j0, kt);  // this tile's valid slots of row r
          if (j0 > 0 && d <= 0) continue;         // summed and stored by an earlier tile
          float acc[VEC];
          float* o = out + (v0 + r) * w + col;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = j0 == 0 ? 0.0f : o[i];
          sum_row<T, VEC, SELECT>(acc, feats, w, col, sm.nbr + r * kt, sm.w + r * kt, d,
                                  sm.gather, lane);
          store_stream<VEC>(o, acc);
        }
      }
      __syncwarp();  // the staged tile is read before the next overwrites it
    }
    item = next;
  }
}

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
  const T* x = static_cast<const T*>(feats);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const int32_t* dg = static_cast<const int32_t*>(deg);
  const float* wp = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  if (wb != 1) {
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
  // the band walk's plan (spmm_cuda.band_plan), checked
  if (band < VEC || band % VEC || band / VEC > 32) return cudaErrorInvalidValue;
  if (rows < 1 || rows > kWarpRows) return cudaErrorInvalidValue;
  const int64_t items = (n + rows - 1) / rows * ((w + band - 1) / band);
  // every warp takes one number past the last item
  if (grid < 1 || items + 2LL * grid * kWarps > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = select ? spmm_ell_band_kernel<T, VEC, true> : spmm_ell_band_kernel<T, VEC, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(x, nb, dg, wp, o, n, k, w, band, rows,
                                                 static_cast<int*>(counter));
  return cudaGetLastError();
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
