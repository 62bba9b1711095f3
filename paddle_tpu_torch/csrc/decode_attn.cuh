// The split body every single-token decode read runs, for Hopper (sm_90a).
//
// Kernels #4-#7 of the TPU package (paddle_tpu/ops/pallas_kernels.py
// _decode_attn_kernel, _decode_attn_q_kernel, _paged_attn_kernel,
// _paged_attn_q_kernel) compute one function: one query token per sample
// reads rows j <= pos[b] of its K/V cache with an f32 softmax and writes an
// f32 output [B, H, D]. They differ only in how a row is found (a strided
// dense cache or a block table over a page pool) and stored (f32, bf16, or
// int8 with one f32 scale per (row, head)). Here that difference is a row
// loader, and the kernel below is the one body all four reads launch
// (decode.cu: the dense caches, paged_decode.cu: the paged ones).
//
// What bounds them on the H100: bytes. Each live row is read once and used
// for one dot product and one axpy (2 operations per element), far below
// the ~20 operations per byte where the f32 units would take over.
//
// Design: a 128-thread block walks rows with an online softmax in f32. A
// row is handled by a group of 8 lanes; the row's D elements are D / 8
// chunks of 8 (one 16-byte load for bf16, two for f32, one 8-byte load for
// int8), and lane li holds chunks li, li + 8, ... (kPer of them at most:
// one for D <= 64, two for D <= 128), so a warp reads 4 rows at once and
// a dot product is 3 shuffles. The head width D is a run-time number (any
// multiple of 8 up to 128), read natively: a lane's chunks past the row
// hold zeros and are never loaded, and no cache is padded or copied.
// The 16 row groups of the block each keep (m, l, acc) and are merged
// through shared memory at the end. Rows past the live count are never
// read. A read walks its live rows one dependent row group step after
// another, so one block per (h, b) takes time in step with the rows while
// its bytes do not fill the card (at B = 8, H = 12: 96 blocks on 132 SMs).
// So a read splits into chunks of rows, one block each, on the grid
// (H, B, splits), and the last block of an (h, b) merges the chunks'
// partials (decode_split_kernel).
#pragma once

#include "common.cuh"

namespace paddle_tpu_torch {
namespace decode {

constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;
constexpr int kGroups = kThreads / kLanesPerRow;   // rows in flight a block
constexpr int kGroupsPerWarp = 32 / kLanesPerRow;
constexpr int kMaxD = 128;                         // the widest head built

// The kernels' __launch_bounds__(kThreads, min_blocks<kPer>()): without
// the occupancy hint ptxas held the f32 paged kernel to 40 registers and
// spilled inside the loop (on an H100, 20.6 against 15.0 us for B=8, H=12
// and 256 rows). A lane of a D <= 128 read holds twice the elements, so it
// asks for half the blocks (128 registers a thread).
template <int kPer>
constexpr int min_blocks() { return kPer == 1 ? 8 : 4; }

// A lane's view of a row: its chunks li, li + 8, ... of the row's D / 8;
// ``n`` of them (<= kPer) lie inside the row.
struct Lane {
  int li;   // the lane's index in its row group
  int n;    // its chunks inside the row
  __device__ __forceinline__ Lane(int li_, int D)
      : li(li_), n(li_ < D / 8 ? (D / 8 - li_ + 7) / 8 : 0) {}
  // the element offset of the lane's chunk i
  __device__ __forceinline__ int at(int i) const { return 8 * li + 64 * i; }
};

// Eight int8 codes from an 8-byte-aligned address in one 8-byte load,
// dequantized as float(code) * s: the plain version's order (dequantize,
// then the dot product), so greedy tokens follow the plain route's.
__device__ __forceinline__ void load8_q(const int8_t* p, float s,
                                        float out[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = i < 4 ? raw.x : raw.y;
    // byte i % 4 of w, sign-extended by the arithmetic shift
    const int code = static_cast<int>(w << (24 - 8 * (i % 4))) >> 24;
    out[i] = static_cast<float>(code) * s;
  }
}

// The lane's chunks of one row at ``p`` (the row's element 0) as f32;
// chunks past the row are zeros and are not read.
template <int kPer, typename T>
__device__ __forceinline__ void load_row(const T* p, const Lane& ln,
                                         float out[8 * kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i < ln.n) {
      load8(p + ln.at(i), out + 8 * i);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) out[8 * i + e] = 0.f;
    }
  }
}

template <int kPer>
__device__ __forceinline__ void load_row_q(const int8_t* p, float s,
                                           const Lane& ln,
                                           float out[8 * kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i < ln.n) {
      load8_q(p + ln.at(i), s, out + 8 * i);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) out[8 * i + e] = 0.f;
    }
  }
}

// Row loaders: ``rows(j, kr, vr)`` fills this lane's elements of row j of
// K and V as f32. Each is built per block, already at (b, h, lane).

// A dense cache [B, L, H, D] read through its strides (a [:, :L] view of
// the [B, max_len, H, D] cache; k and v share strides).
template <int kPer, typename T>
struct DenseRows {
  const T* k;           // at (b, 0, h, 0)
  const T* v;
  int64_t row_stride;   // elements from row j to row j + 1
  Lane ln;
  __device__ __forceinline__ void operator()(int j, float kr[8 * kPer],
                                             float vr[8 * kPer]) const {
    load_row<kPer>(k + j * row_stride, ln, kr);
    load_row<kPer>(v + j * row_stride, ln, vr);
  }
};

// An int8 dense cache with f32 scales [B, L, H] (k/v and their scales
// share strides).
template <int kPer>
struct DenseRowsQ {
  const int8_t* k;      // at (b, 0, h, 0)
  const int8_t* v;
  const float* ks;      // at (b, 0, h)
  const float* vs;
  int64_t row_stride;
  int64_t scale_row_stride;
  Lane ln;
  __device__ __forceinline__ void operator()(int j, float kr[8 * kPer],
                                             float vr[8 * kPer]) const {
    const int64_t sj = j * scale_row_stride;
    load_row_q<kPer>(k + j * row_stride, ks[sj], ln, kr);
    load_row_q<kPer>(v + j * row_stride, vs[sj], ln, vr);
  }
};

// Pools [P, bs, H, D] read through the sample's block table: row j lies
// in page tbl[j / bs], row j % bs, so its (row, head) index is
// (tbl[j / bs] * bs + j % bs) * H + h, the TPU kernel's index map.
// TableRows gives that index.
//
// kCarry = false looks the table up for every row, as the earlier
// one-block body did: each row's address then waits on an L1 load of its
// entry. kCarry = true keeps it off the row's critical path. A row group
// walks its rows in rising order, kGroups apart, so it carries its page's
// base (tbl[p] - p) * bs * H + h in a register across the page's rows
// (row j's index is then base + j * H, as in a dense cache) and looks the
// table up once a page. When it enters a page it also loads the entry of
// the page its first row past this one falls in, which is in flight until
// the group gets there.
template <bool kCarry>
struct TableRows {
  const int* tbl;       // the sample's table row [NB]
  int bs, NB, H, h;
  int hi = 0;           // the first row past the carried page
  int64_t base = 0;     // the carried page's base
  int next_p = -1;      // the page whose entry next_e holds
  int next_e = 0;

  __device__ __forceinline__ int64_t index(int j) {
    if (!kCarry) {
      const int p = j / bs;
      return (static_cast<int64_t>(tbl[p]) * bs + (j - p * bs)) * H + h;
    }
    if (j >= hi) {
      const int p = j / bs;
      const int e = p == next_p ? next_e : tbl[p];
      base = (static_cast<int64_t>(e) - p) * bs * H + h;
      hi = (p + 1) * bs;
      // the group's first row at or past hi
      next_p = (j + (hi - j + kGroups - 1) / kGroups * kGroups) / bs;
      if (next_p < NB) next_e = tbl[next_p];
    }
    return base + static_cast<int64_t>(j) * H;
  }
};

template <int kPer, typename T, bool kCarry>
struct PagedRows {
  const T* k_pool;
  const T* v_pool;
  TableRows<kCarry> at;
  int D;
  Lane ln;
  __device__ __forceinline__ void operator()(int j, float kr[8 * kPer],
                                             float vr[8 * kPer]) {
    const int64_t s = at.index(j);
    load_row<kPer>(k_pool + s * D, ln, kr);
    load_row<kPer>(v_pool + s * D, ln, vr);
  }
};

// int8 pools with f32 scale pools [P, bs, H], indexed by (row, head).
template <int kPer, bool kCarry>
struct PagedRowsQ {
  const int8_t* k_pool;
  const int8_t* v_pool;
  const float* ks_pool;
  const float* vs_pool;
  TableRows<kCarry> at;
  int D;
  Lane ln;
  __device__ __forceinline__ void operator()(int j, float kr[8 * kPer],
                                             float vr[8 * kPer]) {
    const int64_t s = at.index(j);
    load_row_q<kPer>(k_pool + s * D, ks_pool[s], ln, kr);
    load_row_q<kPer>(v_pool + s * D, vs_pool[s], ln, vr);
  }
};

// A block's partial softmax sums over its rows: the running max m, the
// sum l of exp(s - m) and, for output element tid (threads tid < D), the
// unnormalized sum acc of exp(s - m) * v. No row: m = kNeg, l = 0, acc = 0.
struct Partial {
  float m, l, acc;
};

// The walk over rows j_lo .. j_hi - 1 (the caller clamps j_hi to the live
// rows the cache has): ``qb`` is the (b, h) query row, ``rows`` this
// lane's loader (a copy: a paged loader carries its page). Returns the
// block's partial (threads tid < D hold it). Every loader gives the same
// f32 values for the same row contents, and the arithmetic does not
// depend on the loader, so a paged read equals the dense read of its
// gathered pages bit for bit at the same chunks.
template <int kPer, typename TQ, typename Rows>
__device__ __forceinline__ Partial walk_rows(const TQ* __restrict__ qb,
                                             int D, float scale, int j_lo,
                                             int j_hi, Rows rows) {
  constexpr int kE = 8 * kPer;                // elements a lane holds
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][64 * kPer];

  const int tid = threadIdx.x;
  const int g = tid / kLanesPerRow;
  const Lane ln(tid % kLanesPerRow, D);

  float qv[kE];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qv[8 * i + e] = i < ln.n ? to_f32(qb[ln.at(i) + e]) * scale : 0.f;

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
      l = fmaf(l, corr, p);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(p, vr[e], acc[e] * corr);
      m = m_new;
    }
  }

  // merge the row groups: a group that saw no live row has m = kNeg and
  // l = 0, so its weight exp(m - M) is exactly 0 (when every group saw
  // none, M = kNeg and the weights are 1 on l = 0, acc = 0)
  if (ln.li == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (i < ln.n)
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_acc[g][ln.at(i) + e] = acc[8 * i + e];
  __syncthreads();
  Partial out{kNeg, 0.f, 0.f};
  if (tid < D) {
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

// The one kernel of #4-#7: block (h, b, s) walks chunk s, rows
// [s*chunk, (s+1)*chunk) of the live ones [0, min(pos[b] + 1, L)) (a chunk
// wholly past them walks nothing and gives m = kNeg, l = 0, acc = 0), and
// writes its partial to part[(b*H + h)*splits + s] = (m, l, acc[D]) in
// f32. The last block of a (b, h) to finish -- found by an atomic ticket,
// which it resets for the next launch -- merges the partials in chunk
// order, so the result is deterministic (no atomics in any sum) and one
// read stays one launch. With one split (part and tickets unused) the
// block owns its whole read and writes o itself. ``Cache`` gives each
// (b, h) its row loader: rows<kPer>(b, h, lane); L is the rows it has.
template <int kPer, typename TQ, typename Cache>
__global__ void __launch_bounds__(kThreads, min_blocks<kPer>())
decode_split_kernel(const TQ* __restrict__ q, const Cache cache,
                    const int* __restrict__ pos, float* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int H, int D, int L, int chunk, int64_t q_sb,
                    int64_t q_sh, float scale) {
  const int kPart = D + 2;
  __shared__ bool last;
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int bh = b * H + h;
  const int j_lo = s * chunk;
  const int j_hi = min(j_lo + chunk, min(pos[b] + 1, L));
  Partial pt{kNeg, 0.f, 0.f};
  if (j_lo < j_hi) {        // else the chunk is past the live rows
    const Lane ln(tid % kLanesPerRow, D);
    pt = walk_rows<kPer>(q + b * q_sb + h * q_sh, D, scale, j_lo, j_hi,
                         cache.template rows<kPer>(b, h, ln));
  }
  if (splits == 1) {        // the whole read (row 0 is live, so l > 0)
    if (tid < D) o[static_cast<int64_t>(bh) * D + tid] = pt.acc / pt.l;
    return;
  }
  float* mine = part + (static_cast<int64_t>(bh) * splits + s) * kPart;
  if (tid < D) mine[2 + tid] = pt.acc;
  if (tid == 0) {
    mine[0] = pt.m;
    mine[1] = pt.l;
  }
  // publish the partial, then take a ticket: the block that draws the
  // last one sees every other partial
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&tickets[bh], 1) == splits - 1;
    if (last) tickets[bh] = 0;      // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < D) {
    // chunk 0 holds row 0, which is always live, so M is a real score
    // and an empty chunk's weight exp(kNeg - M) is exactly 0
    const float* all = part + static_cast<int64_t>(bh) * splits * kPart;
    float M = kNeg;
    for (int i = 0; i < splits; ++i) M = fmaxf(M, __ldcg(all + i * kPart));
    float l = 0.f, acc = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float* pi = all + i * kPart;
      const float w = expf(__ldcg(pi) - M);
      l = fmaf(__ldcg(pi + 1), w, l);
      acc = fmaf(__ldcg(pi + 2 + tid), w, acc);
    }
    o[static_cast<int64_t>(bh) * D + tid] = acc / l;
  }
}

// One read on the (H, B, splits) grid, the body for D's chunks a lane;
// returns the launch's cudaError_t.
template <typename TQ, typename Cache>
int launch(const void* q, const Cache& cache, const int* pos, float* o,
           float* part, int* tickets, int B, int H, int D, int L, int splits,
           int chunk, int64_t q_sb, int64_t q_sh, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B, splits);
  if (D <= 64)
    decode_split_kernel<1, TQ, Cache><<<grid, kThreads, 0, stream>>>(
        static_cast<const TQ*>(q), cache, pos, o, part, tickets, H, D, L,
        chunk, q_sb, q_sh, scale);
  else
    decode_split_kernel<2, TQ, Cache><<<grid, kThreads, 0, stream>>>(
        static_cast<const TQ*>(q), cache, pos, o, part, tickets, H, D, L,
        chunk, q_sb, q_sh, scale);
  return (int)cudaGetLastError();
}

// The arguments every entry takes: false when D is a multiple of 8 in
// [8, kMaxD], ``splits`` chunks of ``chunk`` rows tile [0, L) with the
// last one not empty, and a split read has its scratch.
inline bool bad_split(int D, int64_t L, int splits, int chunk,
                      const float* part, const int* tickets) {
  return D < 8 || D > kMaxD || D % 8 != 0 || L < 1 || L > INT32_MAX ||
         splits < 1 || chunk < 1 ||
         (splits > 1 && (part == nullptr || tickets == nullptr)) ||
         static_cast<int64_t>(splits - 1) * chunk >= L ||
         static_cast<int64_t>(splits) * chunk < L;
}

}  // namespace decode
}  // namespace paddle_tpu_torch
