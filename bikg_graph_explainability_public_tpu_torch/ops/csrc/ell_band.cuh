// The band walk shared by the ELL gather-sums (Hopper, sm_90a):
// gather_sum_static.cu (kernels 2.3, 2.5 and 2.8), the static and broadcast
// modes of spmm_ell_weighted.cu (kernels 2.6 and 2.7), batched_gather_sum.cu
// (kernel 2.4, per-sample weights held sample-major) and
// spmm_ell_all_slots.cu (kernel 2.9, the guarded mode).
//
//   out[v, c] = scale(v, c) * sum_{k < deg[v]} term(w[v, k], feats[nbr[v, k], c])
//
// feats [N_src, W] (W = B*F) float32 or bfloat16, nbr [N, K] int32, deg [N]
// int32 (the valid-prefix length of each row), out [N, W] float32.  What a
// valid slot adds is the weight policy, a template parameter:
//
//   kUnit    no weight array: x (an add, no multiply, so the sum is bit for
//            bit the plain version's out += x);
//   kStatic  w_slot [N, K]: w * x (a multiply);
//   kSelect  w_slot [N, K] (one weight per slot for every sample): w * x
//            where w != 0 and nothing where w == 0 (that slot's source row
//            is not read);
//   kSample  w_bnk [B, N, K] (one weight per slot and sample, sample-major):
//            w[s, v, k] * x on the columns of sample s, the product rounded
//            before the sum (no fused multiply-add), so that the sum is bit
//            for bit the plain version's term = w * x; out += term;
//   kGuard   w_slot [N, K] and bad [N_src] (1 where a source row holds a
//            non-finite value): w * x as kStatic adds it, on the slots where
//            w != 0 or bad[nbr] (the others are neither read nor summed), so
//            that the sum is kStatic's wherever that is finite, and NaN
//            where kStatic's is (spmm_ell_all_slots.cu gives the argument).
//
// With SCALE the finished sum of each column c is multiplied once by
// post_scale[v, c / F] ([N, B] float32).  Sums accumulate in float32, slots
// in order.
//
// Bound: memory.  One add (or multiply-add) per gathered element is far
// below the card's arithmetic rate.  The least any design moves is each
// distinct source row that a summed slot names read once, the valid slots'
// indices (and weights) once and the output written once: 5.1 GB, 1.53 ms
// at the 100k-node / 1M-edge production shape (W = 6400 float32).  A design
// that reads each slot's source segment from HBM again (one block per
// destination row and column tile: a column tile of all N source rows spans
// 410 MB) moves 25.6 GB of gathers, 5.5x the bound.
//
// The walk.  A work item is (band of `band` columns, chunk of `rows`
// destination rows), numbered band-major; each warp takes its items from a
// global counter (zeroed by the caller), the next one while it works on the
// current, so the warps in flight cover less than one band whatever order
// the hardware runs them in.  A band's source columns, N x band x itemsize
// bytes, stay in L2 while every destination row is summed over them: HBM
// carries each feature byte about once and the repeated gathers are L2
// hits.  Per item the warp stages the chunk's degrees (read ahead, during
// the previous item), then the valid prefixes of its indices (and weights;
// kUnit stages indices only), in its own shared memory, up to
// kt = 512 / rows slots a row at a time (kGuard: the power of two at or
// below it).  Each row's band / VEC lanes then
// gather its valid prefix, up to 16 slots at once, with cp.async: 16 bytes a
// lane into shared memory, not registers, so that a warp has two rows' whole
// prefixes in flight (8 KB) at four blocks an SM.  In the select mode the
// copies are predicated rather than branched, since the two rows of a warp
// skip different slots.  Sums go out with streaming stores (st.global.cs),
// so that the 2.56 GB of output do not push the band out of L2.  Scalar
// lanes (F not a multiple of 16 bytes) gather into registers.  No warp
// waits for another, so nothing can hang.
//
// Sample-major weights (kSample).  A band of F columns or fewer that lies in
// one sample s = c0 / F needs, for its item of rows v0 .. v0 + rows, the run
// w_bnk[s, v0 .. v0 + rows, 0 .. K): rows x K contiguous floats, the same
// run that kStatic stages from [N, K], at a base offset of s * N * K (64-bit).
// So the walk stages it the same way and moves the same weight bytes: each
// sample's [N, K] slice (12.8 MB at the production shape) is read from HBM
// for its first band and from L2 for the next.  The slot-major [N, K, B]
// layout would read one weight per 32-byte sector there (PERF.md, PR 5).
// Where a band spans samples (F < band, or F not a multiple of it) each lane
// reads its own sample's weights, w_bnk[col / F, v, j0 ..], from global memory
// (a lane's VEC columns lie in one sample since F % VEC == 0).
//
// The scale (SCALE).  A row of degree above kt takes several slot tiles: a
// later tile adds to the partial sum that the earlier one stored, so the
// scale is applied only in the row's last tile (j0 + kt >= deg); a row of
// degree 0 stores 0 * scale.  Where the band lies in one sample (F a
// multiple of the band, as at the production shape) the item's scales are
// staged in shared memory with its degrees, read ahead with them: a scale
// read at the end of each row cost a round trip per row (2.3 6.04 ms
// against 2.5's 4.91, PERF.md).  Where a band spans several samples
// (F < band: scalar lanes, or narrow samples) each lane reads its own,
// post_scale[v, col / F].
//
// Band chosen: 256 bytes of each source row, 64 float32 / 128 bfloat16
// columns, 25.6 MB at N = 100000; spmm_cuda.band_plan halves it while
// N x band x itemsize exceeds its L2 budget (PERF.md,
// scripts/ell_band_sweep.py).
//
// The guarded select (kGuard).  Each staged slot is taken where its weight
// is non-zero or bad[] flags its source row; the taken slots of a row's
// tile are compacted to the front of the row's staged run, in slot order,
// before any copy issues: a lane's place is the count of taken slots before
// it in its row, from one warp ballot per 32 staged slots (kt a power of
// two, so a row's run is a group of kt lanes of one ballot, or kt / 32 whole
// ballots), and the row's taken count goes into the upper half of the
// warp's deg[] (rows <= kWarpRows / 2).  A row of d taken slots is then one
// round trip of d copies where d <= kBatch, however its zero weights lie;
// the select mode's predicated batches take ceil(deg / kBatch) trips.
//
// Guarantees: slot k >= deg[v] is never read (NaN in source rows that only
// invalid slots name cannot reach the sum, rows of degree 0 come out as
// exact zeros, times the scale); in the select mode the source row of a
// slot of weight 0 is never read, in the guarded mode only where that row
// is flagged; the static and sample-major modes multiply and keep 0 * NaN;
// offsets are 64-bit (N * W is above 2^31 at the production shape).

#pragma once

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

// What a valid slot adds (see the head of this file).
enum class Weights { kUnit, kStatic, kSelect, kSample, kGuard };

// One warp's shared memory: the landing slots of its cp.async gathers (one
// 16-byte slot per lane and slot of the batch) and its staged item.
struct WarpSmem {
  uint4 gather[kBatch * 32];
  int32_t nbr[kWarpStage];
  union {
    float w[kWarpStage];     // the slots' weights (kStatic, kSelect, kSample, kGuard)
    float scale[kWarpRows];  // the rows' scales (kUnit with SCALE)
  };
  // the rows' degrees; under kGuard those below kWarpRows / 2, the rows'
  // taken counts in the current slot tile above
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

// acc + w * x: one fused multiply-add, or (RN) the product rounded before
// the sum, as a plain w * x followed by an add rounds it.
template <bool RN>
__device__ __forceinline__ float madd(float acc, float w, float x) {
  if constexpr (RN) {
    return __fadd_rn(acc, __fmul_rn(w, x));
  } else {
    return acc + w * x;
  }
}

// One lane's VEC columns: their raw bits, and their addition (add) or
// multiply-addition (fma, RN as madd) into the float32 sums.
template <typename T, int VEC>
struct Lane;

template <>
struct Lane<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void add(Raw x, float* acc) {
    acc[0] += __uint_as_float(x.x);
    acc[1] += __uint_as_float(x.y);
    acc[2] += __uint_as_float(x.z);
    acc[3] += __uint_as_float(x.w);
  }
  template <bool RN = false>
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    acc[0] = madd<RN>(acc[0], w, __uint_as_float(x.x));
    acc[1] = madd<RN>(acc[1], w, __uint_as_float(x.y));
    acc[2] = madd<RN>(acc[2], w, __uint_as_float(x.z));
    acc[3] = madd<RN>(acc[3], w, __uint_as_float(x.w));
  }
};

template <>
struct Lane<float, 1> {
  using Raw = uint32_t;
  static __device__ __forceinline__ void add(Raw x, float* acc) { acc[0] += __uint_as_float(x); }
  template <bool RN = false>
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    acc[0] = madd<RN>(acc[0], w, __uint_as_float(x));
  }
};

template <>
struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void add(Raw x, float* acc) {
    const uint32_t h[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += bf16_lo(h[i]);
      acc[2 * i + 1] += bf16_hi(h[i]);
    }
  }
  template <bool RN = false>
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    const uint32_t h[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = madd<RN>(acc[2 * i], w, bf16_lo(h[i]));
      acc[2 * i + 1] = madd<RN>(acc[2 * i + 1], w, bf16_hi(h[i]));
    }
  }
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using Raw = uint16_t;
  static __device__ __forceinline__ void add(Raw x, float* acc) {
    acc[0] += __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  template <bool RN = false>
  static __device__ __forceinline__ void fma(Raw x, float w, float* acc) {
    acc[0] = madd<RN>(acc[0], w, __uint_as_float(static_cast<uint32_t>(x) << 16));
  }
};

// Whether the band walk's lanes gather through cp.async (16-byte lanes).
template <typename T, int VEC>
constexpr bool kAsync = sizeof(T) * VEC == 16;

// Slot j's term (x, or w * x) added to acc.
template <typename T, int VEC, Weights WT>
__device__ __forceinline__ void add_term(typename Lane<T, VEC>::Raw x, const float* rw, int j,
                                         float* acc) {
  if constexpr (WT == Weights::kUnit) {
    Lane<T, VEC>::add(x, acc);
  } else {
    Lane<T, VEC>::template fma<WT == Weights::kSample>(x, rw[j], acc);
  }
}

// Adds d slots of one row to acc, in order; rn / rw are the row's staged
// indices and weights (rw unread under kUnit; under kSample, where the band
// spans samples, the lane's own weights in global memory).  A slot whose weight is 0
// in the select mode is neither read nor summed.
template <typename T, int VEC, Weights WT>
__device__ __forceinline__ void sum_row(float* acc, const T* __restrict__ feats, int64_t w,
                                        int64_t col, const int32_t* rn, const float* rw, int d,
                                        uint4* gather, int lane) {
  using L = Lane<T, VEC>;
  if constexpr (kAsync<T, VEC>) {
    // the segments land in shared memory: the whole valid prefix in flight
    for (int jj = 0; jj < d; jj += kBatch) {
      if constexpr (WT == Weights::kSelect) {
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
          if (jj + u < d) add_term<T, VEC, WT>(gather[u * 32 + lane], rw, jj + u, acc);
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
        if (j < d && (WT != Weights::kSelect || rw[j] != 0.0f)) {
          x[u] = load_band<typename L::Raw>(feats + static_cast<int64_t>(rn[j]) * w + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = jj + u;
        if (j < d && (WT != Weights::kSelect || rw[j] != 0.0f)) add_term<T, VEC, WT>(x[u], rw, j, acc);
      }
    }
  }
}

// kGuard's compaction of one ballot: for this lane's slot, its place in its
// row's staged run (the taken slots before it in the row, so that the taken
// slots keep their order), and the row's taken count so far.  m: the taken
// lanes of this lane's row in this ballot, which starts at lane g0 and at
// slot off of the row; run: the row's count before this ballot.
__device__ __forceinline__ int2 guard_place(unsigned m, int lane, int g0, int off, int run) {
  return make_int2(run + __popc(m & ((1u << lane) - 1u)), run + __popc(m));
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

// The walk.  w_slot is null under kUnit (w_bnk [B, N, K] under kSample),
// post_scale null unless SCALE, bad null unless kGuard.
template <typename T, int VEC, Weights WT, bool SCALE>
__global__ void __launch_bounds__(kThreads)
ell_band_kernel(const T* __restrict__ feats, const int32_t* __restrict__ nbr,
                const int32_t* __restrict__ deg, const float* __restrict__ w_slot,
                const float* __restrict__ post_scale, const uint8_t* __restrict__ bad,
                float* __restrict__ out, int64_t n, int64_t k, int64_t w, int64_t f, int band,
                int rows, int* __restrict__ counter) {
  extern __shared__ uint4 smem[];
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem)[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;

  const int lanes = band / VEC;          // lanes of one row
  const int per_pass = 32 / lanes;       // rows a warp sums side by side
  const int lrow = lane / lanes;         // this lane's row within a pass
  const int64_t lcol = static_cast<int64_t>(lane % lanes) * VEC;
  // slots of a row staged at a time (kGuard: a power of two, for its ballots)
  const int kt = WT == Weights::kGuard ? 1 << (31 - __clz(kWarpStage / rows))
                                       : kWarpStage / rows;
  int32_t* const cnt = sm.deg + kWarpRows / 2;  // kGuard: the rows' taken slots in a tile
  const int64_t chunks = (n + rows - 1) / rows;
  const int64_t items = chunks * ((w + band - 1) / band);
  const int64_t samples = w / f;         // B, the columns of post_scale

  // the degree of row `lane` of an item (0 past its rows)
  auto first_deg = [&](int it) {
    const int64_t v = it % chunks * rows + lane;
    return it < items && lane < rows && v < n ? __ldg(deg + v) : 0;
  };
  // SCALE: the scale of row `lane` of an item in the sample where its band
  // starts (0 past its rows)
  auto first_scale = [&](int it) {
    const int64_t v = it % chunks * rows + lane;
    return SCALE && it < items && lane < rows && v < n
               ? __ldg(post_scale + v * samples + it / chunks * band / f)
               : 0.0f;
  };
  int item = 0;
  if (lane == 0) item = atomicAdd(counter, 1);
  item = __shfl_sync(0xffffffffu, item, 0);
  // read ahead: the degrees (and scales) of the item's first 32 rows
  int pdeg = first_deg(item);
  float pscale = first_scale(item);
  while (item < items) {
    // take the next item now; its number is read once this one is staged
    int next = 0;
    if (lane == 0) next = atomicAdd(counter, 1);
    const int64_t c0 = item / chunks * band;  // the band's first column
    const int64_t v0 = item % chunks * rows;  // the chunk's first row
    // kSample: where the staged weights start, the slice of sample c0 / F
    const int64_t wbase = WT == Weights::kSample ? c0 / f * n * k : 0;
    const int nrows = static_cast<int>(n - v0 < rows ? n - v0 : rows);
    int maxdeg = 0;
    for (int r = lane; r < nrows; r += 32) {
      const int d = r < 32 ? pdeg : __ldg(deg + v0 + r);
      sm.deg[r] = d;
      maxdeg = max(maxdeg, d);
      if constexpr (SCALE) {
        sm.scale[r] = r < 32 ? pscale : __ldg(post_scale + (v0 + r) * samples + c0 / f);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) maxdeg = max(maxdeg, __shfl_xor_sync(0xffffffffu, maxdeg, o));
    __syncwarp();
    const int64_t col = c0 + lcol;
    const bool on = lrow < per_pass && col < w;
    // SCALE and kSample: where the band lies in one sample (as at the
    // production shape) the lanes take their rows' staged scales or
    // weights; where it spans several (F < band) each lane reads its own,
    // post_scale[v0 + r, col / F] or w_bnk[col / F, v0 + r, ..]
    // (VEC > 1 only where F % VEC == 0: the lane's columns lie in one sample)
    const bool staged = c0 / f == (min(c0 + band, w) - 1) / f;
    const float* ps = SCALE ? post_scale + v0 * samples + col / f : nullptr;
    const float* lw = WT == Weights::kSample ? w_slot + col / f * n * k + v0 * k : nullptr;

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
          if constexpr (WT != Weights::kUnit) pw[t] = __ldg(w_slot + wbase + (v0 + r) * k + j);
        }
      }
      if constexpr (WT == Weights::kGuard) {
        // which slots are taken: the flags of zero-weight slots' rows, all
        // in flight, then one ballot per 32 slots places the taken ones
        bool take[kStagePerLane];
#pragma unroll
        for (int t = 0; t < kStagePerLane; ++t) {
          const int i = lane + 32 * t;
          const int r = i / kt;
          take[t] = i < nrows * kt && j0 + (i - r * kt) < sm.deg[r];
          if (take[t] && pw[t] == 0.0f) take[t] = __ldg(bad + pn[t]) != 0;
        }
        int run = 0;  // the taken slots of a row that spans ballots (kt > 32)
#pragma unroll
        for (int t = 0; t < kStagePerLane; ++t) {
          const int i = lane + 32 * t;
          const unsigned bal = __ballot_sync(0xffffffffu, take[t]);
          const int g0 = kt < 32 ? lane & ~(kt - 1) : 0;  // the row's first lane
          const int off = kt < 32 ? 0 : (32 * t) & (kt - 1);  // the ballot's first slot in the row
          if (off == 0) run = 0;
          const int2 p = guard_place(kt < 32 ? bal & (((1u << kt) - 1u) << g0) : bal, lane, g0,
                                     off, run);
          const int r = i / kt;
          if (take[t]) {
            sm.nbr[r * kt + p.x] = pn[t];
            sm.w[r * kt + p.x] = pw[t];
          }
          // the row's run ends in this ballot: its count
          if (lane == g0 && off + 32 >= kt && r < nrows) cnt[r] = p.y;
          run = p.y;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kStagePerLane; ++t) {
          const int i = lane + 32 * t;
          const int r = i / kt;
          if (i < nrows * kt && j0 + (i - r * kt) < sm.deg[r]) {
            sm.nbr[i] = pn[t];
            if constexpr (WT != Weights::kUnit) sm.w[i] = pw[t];
          }
        }
      }
      __syncwarp();
      if (j0 == 0) {  // the next item's number and degrees, in flight during the gathers
        next = __shfl_sync(0xffffffffu, next, 0);
        pdeg = first_deg(next);
        pscale = first_scale(next);
      }
      if (on) {
        for (int r = lrow; r < nrows; r += per_pass) {
          const int dr = sm.deg[r];
          // this tile's valid (kGuard: taken) slots of row r
          const int d = WT == Weights::kGuard ? cnt[r] : min(dr - j0, kt);
          if (j0 > 0 && d <= 0) continue;         // summed and stored by an earlier tile
          float acc[VEC];
          float* o = out + (v0 + r) * w + col;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = j0 == 0 ? 0.0f : o[i];
          if (WT == Weights::kSample && !staged) {
            sum_row<T, VEC, WT>(acc, feats, w, col, sm.nbr + r * kt, lw + r * k + j0, d,
                                sm.gather, lane);
          } else {
            sum_row<T, VEC, WT>(acc, feats, w, col, sm.nbr + r * kt, sm.w + r * kt, d,
                                sm.gather, lane);
          }
          if constexpr (SCALE) {
            if (j0 + kt >= dr) {  // the row's last tile: its sum is whole
              const float sc =
                  staged ? sm.scale[r] : __ldg(ps + static_cast<int64_t>(r) * samples);
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[i] *= sc;
            }
          }
          store_stream<VEC>(o, acc);
        }
      }
      __syncwarp();  // the staged tile is read before the next overwrites it
    }
    item = next;
  }
}

// Checks the plan (spmm_cuda.band_plan) and launches the walk: `grid`
// persistent blocks of kThreads; `counter` one int32 that is 0 at the launch;
// `bad` the source rows' flags (kGuard only).  Returns cudaGetLastError()
// after the launch.
template <typename T, int VEC, Weights WT, bool SCALE>
cudaError_t launch_band(const void* feats, const void* nbr, const void* deg, const void* w_slot,
                        const void* post_scale, void* out, int64_t n, int64_t k, int64_t w,
                        int64_t f, int band, int rows, int grid, void* counter,
                        cudaStream_t stream, const void* bad = nullptr) {
  if (band < VEC || band % VEC || band / VEC > 32) return cudaErrorInvalidValue;
  if (rows < 1 || rows > (WT == Weights::kGuard ? kWarpRows / 2 : kWarpRows)) {
    return cudaErrorInvalidValue;
  }
  if ((WT == Weights::kGuard) != (bad != nullptr)) return cudaErrorInvalidValue;
  if ((SCALE || WT == Weights::kSample) && (f < 1 || w % f)) return cudaErrorInvalidValue;
  const int64_t items = (n + rows - 1) / rows * ((w + band - 1) / band);
  // every warp takes one number past the last item
  if (grid < 1 || items + 2LL * grid * kWarps > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = ell_band_kernel<T, VEC, WT, SCALE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const int32_t*>(nbr),
      static_cast<const int32_t*>(deg), static_cast<const float*>(w_slot),
      static_cast<const float*>(post_scale), static_cast<const uint8_t*>(bad),
      static_cast<float*>(out), n, k, w, f, band, rows, static_cast<int*>(counter));
  return cudaGetLastError();
}

}  // namespace
