// The recurrences' products over rows read from L2 (gru_seq.cu,
// lstm_seq.cu; gru_seq_bwd.cu takes the reduce-scatter).
//
// A recurrence step multiplies rows of a state exchanged through global
// memory (h_{t-1}, r*h_{t-1}) with the gate columns of U that a block
// owns. Each block needs all H entries of each of its rows, written by
// every other block the step before, so each product waits for L2 after a
// grid barrier: the forwards read each value once a block, straight into a
// ring of registers, and multiply it on the CUDA cores with U held in
// shared memory as f32. Partial sums over k are reduced over the lanes
// that split k, by a reduce-scatter that leaves each lane the sums it
// owns: every output has one owner and one order of sums, so the results
// are the same from run to run.
//
// The forwards' plan (ops/rnn_kernels.py forward_plan): a block owns
// UNITS hidden units (8 or 16, a template argument) for `rows` batch rows
// (8, 16 or 32, at most 256 threads). A warp takes RL rows (4; the
// LSTM's 16-unit blocks 2). Its two half-warps split each product: both
// read the warp's rows (the same 16-byte pieces, one request a warp
// instruction), lane kl the columns 64 it + 4 kl .. +3, and each half
// multiplies them with its own columns of U -- half of the gates, or,
// for a one-gate product, half of the units -- so that the 32 lanes of a
// warp load 32 different float4s of U from shared memory (four
// wavefronts, none wasted) and each feeds RL x 4 FMAs. A reduce-scatter
// over the 16 lanes of a half and one exchange between the halves leave
// each lane all the gates of the RL x UNITS / 32 (row, unit)s it owns
// (Prod::owned). Where the plan says so, a pair of warps takes the same
// rows and splits the column steps (KSplit). Each kernel is compiled
// twice: for a grid of at most one block an SM (255 registers a thread, a
// ring of 16/RL column steps of loads) and for denser grids (128
// registers, 8/RL steps).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace paddle_tpu_torch {
namespace recur {

namespace cg = cooperative_groups;

// lanes of a half-warp, which split k; the threads a block has at most
constexpr int kHalf = 16;
constexpr int kMaxThreads = 256;

// One halving step of reduce_scatter: lanes l and l ^ LB keep the halves
// of v[0 .. 2 HALF) that bit LB of l selects, each adding the other's copy
// of its half.
template <int LB, int HALF, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool hi = lane & LB;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = hi ? v[j] : v[j + HALF];
    const float keep = hi ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, LB);
  }
}

// The sum over the lanes that differ in bits LB, LB/2 .. 1 of the lane
// index, of each of v[0 .. N): lane l is left with the sums of indices
// (l mod 2LB) * N/(2LB) .. +N/(2LB)-1 in v[0 ..). A fixed tree of
// shuffles, so the sums are deterministic. Every lane of the warp calls it.
template <int LB, int N, int HALF = N / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  static_assert(HALF >= 1, "more lanes than values");
  halve<LB, HALF>(v, lane);
  if constexpr (LB > 1) reduce_scatter<LB / 2, N, HALF / 2>(v, lane);
}

__device__ __forceinline__ float comp(const float4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

// four consecutive f32 of an exchange, read past L1 (the exchanges are
// written by other blocks during the kernel, and L1 is not coherent)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// N (1 or 2) consecutive elements as f32, and their stores (the pair
// 2N-aligned)
template <int N, typename DT>
__device__ __forceinline__ void load_n(const DT* p, float (&v)[N]) {
  if constexpr (N == 2 && sizeof(DT) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (N == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f32(p[i]);
  }
}
template <int N, typename DT>
__device__ __forceinline__ void store_n(const float (&v)[N], DT* p) {
  if constexpr (N == 2 && sizeof(DT) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) store_f32(v[i], p + i);
  }
}

// Ask L2 for the line at p ahead of its load. Unlike a load it leaves
// nothing outstanding in the thread, so a grid barrier's fence does not
// wait for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// N (1 or 2) consecutive elements kept as loaded, in the I/O dtype, and
// converted to f32 where used: a bf16 value converted where it is loaded
// makes the thread wait there for the load
template <int N, typename DT>
struct Raw {
  using V = typename std::conditional<
      N == 1, DT,
      typename std::conditional<sizeof(DT) == 4, float2,
                                __nv_bfloat162>::type>::type;
  V raw;
  __device__ Raw() : raw() {}
  __device__ void load(const DT* p) { raw = *reinterpret_cast<const V*>(p); }
  __device__ float operator[](int i) const {
    if constexpr (N == 1) {
      return to_f32(raw);
    } else if constexpr (sizeof(DT) == 4) {
      return i ? raw.y : raw.x;
    } else {
      return __bfloat162float(i ? raw.y : raw.x);
    }
  }
};

// Whether a grid of `blocks` has an SM to each block on this card: the
// forwards then launch their bodies compiled for one block an SM (255
// registers a thread: a deeper ring of loads, no spills), else those for
// two (128)
__host__ inline bool one_an_sm(long blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return blocks <= sms;
}

// the forwards' plans: UNITS hidden units x rows batch rows a block, RL
// rows a warp (or a pair of warps, parts = 2), at most kMaxThreads
// threads
__host__ inline bool plan_taken(int units, int rows, int parts, int rl) {
  return (units == 8 || units == 16) &&
         (rows == 8 || rows == 16 || rows == 32) &&
         (parts == 1 || parts == 2) && 32 * parts * rows / rl <= kMaxThreads;
}

// column steps of 64 k a product takes
__host__ __device__ inline int col_steps(int H) { return (H + 63) / 64; }

// shared memory of a forward kernel: U's NGT gates for UNITS units (H
// padded to 64), f32
__host__ __device__ inline size_t fwd_smem_bytes(int NGT, int H, int units) {
  return static_cast<size_t>(NGT) * col_steps(H) * 64 * units *
         sizeof(float);
}
// and the pairs' scratch after it (KSplit): 512 bytes a pair of warps
constexpr int kPairBytes = 32 * 4 * sizeof(float);

// How a warp shares a product's k with the other warp of its pair: the
// pair (warps 2i, 2i+1 where parts = 2) takes the same rows, warp `part`
// the column steps part, part + parts, ..; the second warp hands its sums
// to the first through `red` (32 x 4 floats of shared memory a pair) at
// named barrier `bar`, and the first owns the outputs.
struct KSplit {
  int part, parts, bar;
  float* red;
};

// One product of a step: gates g0 .. g0+NG-1 (NG = 1, 2 or 4) of the
// block's UNITS units for the RL rows of a warp. NG > 1: half-warp h takes
// gates g0 + h*NG/2 .. +NG/2-1, all units; NG = 1: half-warp h takes the
// units `unit(h, c)` below, whose sums land on the lanes that own them in
// the NG > 1 products too. After the reduce-scatter a lane keeps kM sums
// of each of its gates, and owns kOwn (row, unit)s: owned(h, kl, o).
template <int NG, int UNITS, int RL>
struct Prod {
  static constexpr int kM = RL * UNITS / kHalf;
  static constexpr int kOwn = kM / 2;
  static constexpr int kCols = NG == 1 ? UNITS / 2 : NG / 2 * UNITS;
  static constexpr int kC4 = kCols / 4;
  static_assert(kOwn >= 1 && kCols % 4 == 0, "no such product");

  // gate (from g0) and unit of column c of half-warp h
  __device__ static void column(int h, int c, int& gate, int& unit) {
    if (NG == 1) {
      gate = 0;
      unit = kM * (c / kOwn) + h * kOwn + c % kOwn;
    } else {
      gate = h * (NG / 2) + c / UNITS;
      unit = c % UNITS;
    }
  }
  // row (of the warp's RL) and unit (of the block's) of lane (h, kl)'s
  // o-th (row, unit)
  __device__ static void owned(int h, int kl, int o, int& row, int& unit) {
    const int e = kl * kM + h * kOwn + o;
    row = e / UNITS;
    unit = e % UNITS;
  }
  // float4s of U in shared memory
  __host__ __device__ static int slots(int H) {
    return col_steps(H) * 4 * kC4 * 32;
  }

  // U's columns of the product for the block's units j0 .. (U [H, NGT*H],
  // gate g at columns g*H ..) as f32 float4s of four columns of a half:
  // us[((it*4 + kk)*kC4 + c4)*32 + 16h + kl] holds the columns 4c4 .. +3
  // of half h at k = 64 it + 4 kl + kk, zero past H. A warp's 32 lanes
  // read 32 consecutive float4s.
  template <typename DT>
  __device__ static void stage(const DT* u, int NGT, int g0, int H, int j0,
                              float4* us) {
    const int64_t G = static_cast<int64_t>(NGT) * H;
    for (int idx = threadIdx.x; idx < slots(H); idx += blockDim.x) {
      const int lane = idx % 32, c4 = (idx / 32) % kC4;
      const int kk = (idx / (32 * kC4)) % 4, it = idx / (32 * kC4 * 4);
      const int k = 64 * it + 4 * (lane % kHalf) + kk;
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int gate, unit;
        column(lane / kHalf, 4 * c4 + q, gate, unit);
        const int j = j0 + unit;
        w[q] = k < H && j < H ? to_f32(u[k * G + (g0 + gate) * H + j])
                              : 0.f;
      }
      us[idx] = make_float4(w[0], w[1], w[2], w[3]);
    }
  }

  // The owner's sums: out[g][o] is the sum over k of row[k] * U[k,
  // (g0+g)*H + unit] for the lane's o-th (row, unit). Row r of the warp's
  // RL rows of an f32 exchange is at rows + r*H and read only where
  // live[r]; a warp whose rows are all dead returns zeros without reading.
  // Every lane of the warp calls it. The loads of kRing of the warp's
  // column steps are in flight at once: a ring of registers, each
  // refilled with the step kRing ahead once its own is multiplied, so the
  // product waits for L2 about once every kRing of its steps (the bodies
  // for one block an SM, at 255 registers a thread, hold twice the ring).
  template <int kRing>
  __device__ static void dot(float (&out)[NG][kOwn], const float* rows,
                             const bool (&live)[RL], const float4* us,
                             int H, const KSplit& ks) {
    const int lane = threadIdx.x % 32, h = lane / kHalf, kl = lane % kHalf;
    // the warp's column steps: it = part + parts * i for i < nit
    const int nit = (col_steps(H) - ks.part + ks.parts - 1) / ks.parts;
    bool any = false;
#pragma unroll
    for (int r = 0; r < RL; ++r) any |= live[r];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int o = 0; o < kOwn; ++o) out[g][o] = 0.f;
    if (!any) return;                   // the warp's rows: uniform
    // column step `it` of the rows, zeros past H and for dead rows
    auto fetch = [&](float4(&d)[RL], int i) {
      const int it = ks.part + ks.parts * i, k = 64 * it + 4 * kl;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        d[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live[r] && i < nit && k < H) d[r] = load4(rows + r * H + k);
      }
    };
    float acc[kC4][RL][4];
#pragma unroll
    for (int c = 0; c < kC4; ++c)
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[c][r][q] = 0.f;
    float4 d[kRing][RL];
#pragma unroll
    for (int s = 0; s < kRing; ++s) fetch(d[s], s);
    for (int i0 = 0; i0 < nit; i0 += kRing) {
#pragma unroll
      for (int s = 0; s < kRing; ++s) {
        const int i = i0 + s, it = ks.part + ks.parts * i;
        if (i >= nit) break;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int c = 0; c < kC4; ++c) {
            const float4 w = us[((it * 4 + kk) * kC4 + c) * 32 + lane];
#pragma unroll
            for (int r = 0; r < RL; ++r) {
              const float x = comp(d[s][r], kk);
              acc[c][r][0] = fmaf(x, w.x, acc[c][r][0]);
              acc[c][r][1] = fmaf(x, w.y, acc[c][r][1]);
              acc[c][r][2] = fmaf(x, w.z, acc[c][r][2]);
              acc[c][r][3] = fmaf(x, w.w, acc[c][r][3]);
            }
          }
        }
        fetch(d[s], i + kRing);
      }
    }
    if constexpr (NG == 1) {
      // v[r * UNITS/2 + c]: the half's columns; the reduce-scatter leaves
      // lane kl the sums of kl*kOwn .. +kOwn-1, its owned (row, unit)s
      float v[RL * UNITS / 2];
#pragma unroll
      for (int r = 0; r < RL; ++r)
#pragma unroll
        for (int c = 0; c < UNITS / 2; ++c)
          v[r * UNITS / 2 + c] = acc[c / 4][r][c % 4];
      reduce_scatter<kHalf / 2>(v, lane);
#pragma unroll
      for (int o = 0; o < kOwn; ++o) out[0][o] = v[o];
    } else {
#pragma unroll
      for (int gl = 0; gl < NG / 2; ++gl) {
        // v[r * UNITS + u] of the half's gl-th gate; lane kl keeps kl*kM
        // .. +kM-1, owns the h-th half of them and trades the other half
        // for the other half-warp's gates of its own
        float v[RL * UNITS];
#pragma unroll
        for (int r = 0; r < RL; ++r)
#pragma unroll
          for (int u = 0; u < UNITS; ++u)
            v[r * UNITS + u] = acc[(gl * UNITS + u) / 4][r][u % 4];
        reduce_scatter<kHalf / 2>(v, lane);
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          const float mine = h ? v[kOwn + o] : v[o];
          const float send = h ? v[o] : v[kOwn + o];
          const float got = __shfl_xor_sync(0xffffffffu, send, kHalf);
          out[gl][o] = h ? got : mine;                 // gate gl
          out[NG / 2 + gl][o] = h ? mine : got;        // gate NG/2 + gl
        }
      }
    }
    if (ks.parts == 2) {                // the pair's sums, first + second
      float* slot = ks.red + lane;
      if (ks.part == 1)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int o = 0; o < kOwn; ++o) slot[(g * kOwn + o) * 32] = out[g][o];
      asm volatile("bar.sync %0, 64;" ::"r"(ks.bar) : "memory");
      if (ks.part == 0)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int o = 0; o < kOwn; ++o) out[g][o] += slot[(g * kOwn + o) * 32];
    }
  }
};

// The longest length of lens[0 .. B) clamped to [0, T], in every lane of
// the calling warp (each warp reads all of them: no shared memory, no
// block barrier).
__device__ __forceinline__ int longest(const int* lens, int B, int T) {
  int m = 0;
  for (int i = threadIdx.x % 32; i < B; i += 32)
    m = max(m, min(max(lens[i], 0), T));
  return __reduce_max_sync(0xffffffffu, m);
}

}  // namespace recur
}  // namespace paddle_tpu_torch
