// The row walk every single-token decode read shares, for Hopper (sm_90a).
//
// Kernels #4-#7 of the TPU package (paddle_tpu/ops/pallas_kernels.py
// _decode_attn_kernel, _decode_attn_q_kernel, _paged_attn_kernel,
// _paged_attn_q_kernel) compute one function: one query token per sample
// reads rows j <= pos[b] of its K/V cache with an f32 softmax and writes an
// f32 output [B, H, D]. They differ only in how a row is found (a strided
// dense cache or a block table over a page pool) and stored (f32, bf16, or
// int8 with one f32 scale per (row, head)). Here that difference is a row
// loader, and the walk below is the one body all four kernels run.
//
// What bounds them on the H100: bytes. Each live row is read once and used
// for one dot product and one axpy (2 operations per element), far below
// the ~20 operations per byte where the f32 units would take over.
//
// Design: a 128-thread block walks live rows with an online softmax in
// f32. A row is handled by a group of 8 lanes, each holding 8 of the D =
// 64 elements (one 16-byte load for bf16, two for f32, one 8-byte load for
// int8), so a warp reads 4 rows at once and a dot product is 3 shuffles.
// The 16 row groups of the block each keep (m, l, acc) and are merged
// through shared memory at the end. Rows past the live count are never
// read. #6 and #7 run one block per (h, b) over all live rows (row_walk);
// #4 and #5 may split a read into chunks of rows, one block each
// (walk_rows gives a chunk's partial, decode.cu merges them).
#pragma once

#include "common.cuh"

namespace paddle_tpu_torch {
namespace decode {

constexpr int kThreads = 128;
// The kernels' __launch_bounds__(kThreads, kMinBlocks): without the
// occupancy hint ptxas held the f32 paged kernel to 40 registers and
// spilled inside the loop (on an H100, 20.6 against 15.0 us for B=8, H=12
// and 256 rows).
constexpr int kMinBlocks = 8;
constexpr int kLanesPerRow = 8;
constexpr int kGroups = kThreads / kLanesPerRow;   // rows in flight a block
constexpr int kGroupsPerWarp = 32 / kLanesPerRow;
constexpr int kD = 64;                             // the head width
constexpr int kE = kD / kLanesPerRow;              // elements a lane holds

// Eight int8 codes from an 8-byte-aligned address in one 8-byte load,
// dequantized as float(code) * s: the plain version's order (dequantize,
// then the dot product), so greedy tokens follow the plain route's.
__device__ __forceinline__ void load8_q(const int8_t* p, float s,
                                        float out[kE]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const uint32_t w = i < 4 ? raw.x : raw.y;
    // byte i % 4 of w, sign-extended by the arithmetic shift
    const int code = static_cast<int>(w << (24 - 8 * (i % 4))) >> 24;
    out[i] = static_cast<float>(code) * s;
  }
}

// Row loaders: ``rows(j, kr, vr)`` fills this lane's 8 elements of row j
// of K and V as f32. Each is built per block, already at (b, h, lane).

// A dense cache [B, L, H, D] read through its strides (a [:, :L] view of
// the [B, max_len, H, D] cache; k and v share strides).
template <typename T>
struct DenseRows {
  const T* k;           // at (b, 0, h, lane * 8)
  const T* v;
  int64_t row_stride;   // elements from row j to row j + 1
  __device__ __forceinline__ void operator()(int j, float kr[kE],
                                             float vr[kE]) const {
    load8(k + j * row_stride, kr);
    load8(v + j * row_stride, vr);
  }
};

// An int8 dense cache with f32 scales [B, L, H] (k/v and their scales
// share strides).
struct DenseRowsQ {
  const int8_t* k;      // at (b, 0, h, lane * 8)
  const int8_t* v;
  const float* ks;      // at (b, 0, h)
  const float* vs;
  int64_t row_stride;
  int64_t scale_row_stride;
  __device__ __forceinline__ void operator()(int j, float kr[kE],
                                             float vr[kE]) const {
    const int64_t sj = j * scale_row_stride;
    load8_q(k + j * row_stride, ks[sj], kr);
    load8_q(v + j * row_stride, vs[sj], vr);
  }
};

// Pools [P, bs, H, D] read through the sample's block table: row j lies
// in page tbl[j / bs], row j % bs. The (row, head) index is computed as
// the TPU kernel's index map gives it, with D a compile-time constant.
template <typename T>
struct PagedRows {
  const T* k_pool;
  const T* v_pool;
  const int* tbl;       // the sample's table row [NB]
  int bs, H, h;
  int lane;             // the first of the lane's 8 elements
  __device__ __forceinline__ void operator()(int j, float kr[kE],
                                             float vr[kE]) const {
    const int64_t s =
        (static_cast<int64_t>(tbl[j / bs]) * bs + j % bs) * H + h;
    load8(k_pool + s * kD + lane, kr);
    load8(v_pool + s * kD + lane, vr);
  }
};

// int8 pools with f32 scale pools [P, bs, H], indexed by (row, head).
struct PagedRowsQ {
  const int8_t* k_pool;
  const int8_t* v_pool;
  const float* ks_pool;
  const float* vs_pool;
  const int* tbl;
  int bs, H, h;
  int lane;
  __device__ __forceinline__ void operator()(int j, float kr[kE],
                                             float vr[kE]) const {
    const int64_t s =
        (static_cast<int64_t>(tbl[j / bs]) * bs + j % bs) * H + h;
    load8_q(k_pool + s * kD + lane, ks_pool[s], kr);
    load8_q(v_pool + s * kD + lane, vs_pool[s], vr);
  }
};

// A block's partial softmax sums over its rows: the running max m, the
// sum l of exp(s - m) and, for output element tid (threads tid < kD), the
// unnormalized sum acc of exp(s - m) * v. No row: m = kNeg, l = 0, acc = 0.
struct Partial {
  float m, l, acc;
};

// The walk over rows j_lo .. j_hi - 1 (the caller clamps j_hi to the live
// rows the cache has): ``qb`` is this lane's 8 query elements. Returns
// the block's partial (threads tid < kD hold it).
template <typename TQ, typename Rows>
__device__ __forceinline__ Partial walk_rows(const TQ* __restrict__ qb,
                                             float scale, int j_lo,
                                             int j_hi, const Rows& rows) {
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][kD];

  const int tid = threadIdx.x;
  const int g = tid / kLanesPerRow, li = tid % kLanesPerRow;

  float qv[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) qv[e] = to_f32(qb[e]) * scale;

  float m = kNeg, l = 0.f, acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;

  // the loop bound is uniform across the warp (its 4 groups start at
  // j0 = j_lo + 4*warp), so every lane reaches the shuffles; group g reads
  // rows j = j_lo + g, j_lo + g + 16, ...
  for (int j0 = j_lo + (tid / 32) * kGroupsPerWarp; j0 < j_hi;
       j0 += kGroups) {
    const int j = j0 + g % kGroupsPerWarp;
    const bool live = j < j_hi;
    float kr[kE], vr[kE];
    float s = 0.f;
    if (live) {
      rows(j, kr, vr);
#pragma unroll
      for (int e = 0; e < kE; ++e) s = fmaf(qv[e], kr[e], s);
    }
#pragma unroll
    for (int w = kLanesPerRow / 2; w > 0; w >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, w);
    if (live) {
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(p, vr[e], acc[e] * corr);
      m = m_new;
    }
  }

  // merge the row groups: a group that saw no live row has m = kNeg and
  // l = 0, so its weight exp(m - M) is exactly 0 (when every group saw
  // none, M = kNeg and the weights are 1 on l = 0, acc = 0)
  if (li == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) sm_acc[g][li * kE + e] = acc[e];
  __syncthreads();
  Partial out{kNeg, 0.f, 0.f};
  if (tid < kD) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) out.m = fmaxf(out.m, sm_m[i]);
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const float w = expf(sm_m[i] - out.m);
      out.l = fmaf(sm_l[i], w, out.l);
      out.acc = fmaf(sm_acc[i][tid], w, out.acc);
    }
  }
  return out;
}

// The whole read of one block: rows 0 .. n_live - 1 (the caller clamps
// n_live to the rows the cache has), ``ob`` the block's D outputs.
template <typename TQ, typename Rows>
__device__ __forceinline__ void row_walk(const TQ* __restrict__ qb,
                                         float scale, int n_live,
                                         const Rows& rows,
                                         float* __restrict__ ob) {
  const Partial p = walk_rows(qb, scale, 0, n_live, rows);
  if (threadIdx.x < kD) ob[threadIdx.x] = p.acc / p.l;
}

}  // namespace decode
}  // namespace paddle_tpu_torch
