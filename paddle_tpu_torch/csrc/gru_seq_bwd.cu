// Backward of the masked GRU sequence for Hopper (sm_90a).
//
// Replaces the TPU kernel _gru_seq_bwd_kernel (paddle_tpu/ops/
// pallas_kernels.py, called by gru_sequence_fused_bwd): the reverse-time
// recurrence from the forward's residuals (xw with the bias added, the
// masked outputs) and the output cotangents. With h_{t-1} the saved out[t-1]
// (h0 at t = 0, in the I/O dtype as saved), it recomputes z, r, r*h_{t-1}
// and c of every step, then from t = T-1 down to 0 forms
//   dgz = (dh' (c - h_{t-1})) z (1-z),  dgc = (dh' z)(1 - c^2),
//   drh = dgc @ u_c^T,                  dgr = (drh h_{t-1}) r (1-r),
//   dh_{t-1} = (1-m) dh_t + dh' (1-z) + drh r + dgz @ u_z^T + dgr @ u_r^T,
// with dh' = m dh_t and m the step's mask, and writes dxw = [dgz|dgr|dgc].
// dU = sum_t [h_{t-1}^T dgz | h_{t-1}^T dgr | (r h_{t-1})^T dgc] in f32.
// Returns dxw and dh0 in the I/O dtype and dU [H, 3H] in f32; dx, dW and
// db (= the sum of dxw) are products outside (ops/rnn.py).
//
// What bounds it on the H100: three product groups of 2*B*H*3H operations
// each (the gate recompute, the dh products, dU), of which only the dh
// products are serial: the recompute reads only saved outputs, and dU only
// the cotangents. Within the serial part the chain dgc (all units) -> drh
// -> dgr (all units) -> dh_{t-1} crosses the grid twice a step, so the
// recurrence is bound by two grid barriers a step and by the L2 reads of
// the cotangent rows that each block needs from all the others.
//
// Design: one cooperative launch, block (x, y) owning kOwnUnits hidden
// units for kRows batch rows in the recurrence; the parallel phases are
// products over the live (b, t) rows only, dealt out to all blocks as 64 x
// 64 output tiles:
//  0. the live rows: each block takes the rows' prefix sums of the lengths
//     into shared memory; the grid compacts the live (b, t) rows -- a step
//     at or past a sample's length adds exactly nothing to any output --
//     into rowmap (row i -> b*T + t) and hp_seq (h_{t-1} of row i, I/O
//     dtype). One grid barrier.
//  1. the gate recompute as products on the tensor cores (mma.sync m16n8k8,
//     tf32x3.cuh: three TF32 passes where both operands are f32, two where
//     one is bf16, one where both are: bf16 values are exact in TF32):
//     [z|r] = sigma(xw_zr + HP @ [u_z|u_r]) with r*h_{t-1} in f32 to
//     rh_seq; a grid barrier; c = tanh(xw_c + RH @ u_c). z, r, c go to the
//     f32 scratch `gates` [rows, 3H]. A and B tiles of 64-deep stages by
//     cp.async, the next stage in flight during each stage's products,
//     each stage into fresh accumulators added in f32 (tf32x3.cuh,
//     "Accumulation"). Each A row is read 3H/64 times, not H/4 times as
//     when every block streamed every row.
//  2. the reverse recurrence, two grid barriers a step. An owner lane
//     (row, unit) forms its dgz, dgc, then dgr, and writes them to dxw and,
//     in f32, over the gates it read (only it reads those entries): the
//     scratch becomes the cotangent sequence. The products with U^T need
//     the cotangents of all H units of the block's rows: warp w takes 4
//     rows, each half-warp 2 of them, and reads their cotangents straight
//     from L2 into registers, all of a row's at once (each value is used
//     once in the block, so staging it through shared memory would only
//     add traffic): lane l the columns 64i + 4l .. +3, multiplied on the
//     CUDA cores with the block's 8 rows of U held interleaved in shared
//     memory (2 rows x 8 units x 4 columns a lane per 8 16-byte loads; the
//     z and r products' loads in flight together). A
//     reduce-scatter over the half-warp (15 shuffles) leaves lane l with
//     the sum of (row l / 8, unit l % 8), that lane's own (row, unit). Only
//     rows live at the step are read; a row past its length keeps dh (its
//     cotangents are 0). Eight units a block, not four, halve what the grid
//     reads from L2 a step.
//  3. dU = [HP^T dgz | HP^T dgr | RH^T dgc] over the live rows, as phase
//     1's tiles with A read transposed; one owner per output tile and a
//     fixed order of sums, no atomics.
// Every output element has one owner and every sum a fixed order, so the
// result is deterministic.
#include <type_traits>

#include "lstm.cuh"
#include "recur.cuh"
#include "tf32x3.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace lstm;
using recur::comp;

constexpr int kWarps = kThreads / 32;    // 8
constexpr int kOwnUnits = 8;             // hidden units a block owns
constexpr int kRowsW = kRows / kWarps;   // 4 rows a warp in the recurrence
// the output tiles of phases 1 and 3 and the depth of a stage
constexpr int kTM = 64, kTN = 64, kTK = 64;
// one stage in shared memory: the A tile ([64][kTK + 4] or [kTK][68] f32
// at most) and the B tile ([kTK][72] f32 at most)
constexpr int kTileA =
    (kTM * (kTK + 4) > kTK * 68 ? kTM * (kTK + 4) : kTK * 68) * 4;
constexpr int kTileB = kTK * 72 * 4;
constexpr int kStage = kTileA + kTileB;
// stages in the ring: the next stage's copies fly while one is multiplied
// (three or four stages, 32- or 128-deep stages and 128 x 64 tiles
// measured no faster on the H100)
constexpr int kStages = 2;
// the recurrence's products: a lane reads its 2 rows' cotangents in
// chunks of kChunk 64-column steps, all in flight at once
constexpr int kChunk = 8;

// Tile pitches, in elements, each keeping its loader free of bank
// conflicts and rows 16-byte aligned: kRowK for [64][kTK] tiles read along
// their rows (phase 1's A, by ldmatrix or load_a_rows), kNat for [32][64]
// tiles read down their columns in the natural k order (phase 1's B,
// load_b_rows: rows t lie 8t banks apart), kPerm for [32][64] tiles read
// down their columns with tf32x3.cuh's permuted k order (phase 3's A and
// B, load_a_km and load_b_kn: rows 2t lie 8t banks apart). The two orders
// must not meet in one product.
template <typename T>
struct Pitch;
template <>
struct Pitch<float> {
  static constexpr int kRowK = kTK + 4, kNat = 72, kPerm = 68;
};
template <>
struct Pitch<__nv_bfloat16> {
  static constexpr int kRowK = kTK + 8, kNat = 80, kPerm = 72;
};

// B = X[k0 .. +7][n0 .. +7] of an X[k][n] tile in the natural k order
// (b0 at k = t, b1 at k = t + 4), to meet load_a_rows' A
template <typename T>
__device__ __forceinline__ void load_b_rows(tf32x3::FragB& f, const T* tile,
                                            int k0, int n0, int lane,
                                            int ld) {
  const T* p = tile + (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  tf32x3::split_b(f, to_f32(p[0]), to_f32(p[4 * ld]));
}

// A matrix in global memory: element (r, c) at p[r * ld + c], for
// r < rows and c < cols
template <typename T>
struct Mat {
  const T* p;
  int64_t ld;
  int rows, cols;
};

__host__ __device__ inline size_t head_bytes(int B) {
  return (static_cast<size_t>(B + 2) * sizeof(int) + 15) / 16 * 16;
}

// U's rows of the block's units for the recurrence: 3 gates x nit column
// steps of 64 x 4 x 2 x 16 float4 (see phase 2)
__host__ __device__ inline size_t u_bytes(int H) {
  return static_cast<size_t>(3) * ((H + 63) / 64) * 128 * sizeof(float4);
}

__host__ __device__ inline size_t bwd_smem_bytes(int B, int H) {
  const size_t stages = kStages * static_cast<size_t>(kStage);
  const size_t ub = u_bytes(H);
  return head_bytes(B) + (stages > ub ? stages : ub);
}

// a live row's xw row and h_{t-1} row, for phase 1's epilogues
template <typename DT>
struct LiveRow {
  const DT* xw;
  const DT* hp;
};

// Rows r0 .. r0+R-1, columns c0 .. c0+C-1 of m into dst[R][pitch] by
// cp.async, zeros past m's edges. 16-byte copies, or 8-byte ones for bf16
// rows of 4k + 4 elements (``narrow``); m's column counts are multiples of
// a copy's elements.
template <int R, int C, typename T>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const Mat<T>& m,
                                          int r0, int c0, bool narrow) {
  const bool n8 = narrow && sizeof(T) == 2;
  const int e = (n8 ? 8 : 16) / static_cast<int>(sizeof(T));
  // copies a row: a power of two, so a shift and a mask split idx
  const int sh = 31 - __clz(C / e);
  for (int idx = threadIdx.x; idx < R << sh; idx += kThreads) {
    const int r = idx >> sh, c = (idx & ((1 << sh) - 1)) * e;
    const bool in = r0 + r < m.rows && c0 + c < m.cols;
    const T* src = in ? m.p + (r0 + r) * m.ld + c0 + c : m.p;
    if (n8)
      tf32x3::cp_async8(dst + r * pitch + c, src, in);
    else
      tf32x3::cp_async16(dst + r * pitch + c, src, in);
  }
}

// C = A . B on the tensor cores, C [M][N] in 64 x 64 tiles dealt out to
// the grid's blocks in turn, K in stages of kTK (a ring of kStages). A is
// [M][K] (kAT false: rows of h_{t-1} or r*h_{t-1}) or given as its
// transpose [K][M] (kAT true: the dU products), B is [K][N]. Warp w takes
// the tile's rows 16 (w % 4) .. +15 and columns 32 (w / 4) .. +31. Each
// stage sums into fresh accumulators added in f32 (tf32x3.cuh,
// "Accumulation"). epi(row(m), m, n, v) receives every element with m < M,
// n < N; row(m) is taken once a row, before its elements.
template <bool kAT, bool kAExact, bool kBExact, typename TA, typename TB,
          typename Row, typename Epi>
__device__ __forceinline__ void gemm(const Mat<TA>& a, const Mat<TB>& b,
                                     int M, int N, int K, bool narrow,
                                     uint8_t* region, Row row, Epi epi) {
  using namespace tf32x3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g4 = lane >> 2, t4 = lane & 3;
  constexpr int pa = kAT ? Pitch<TA>::kPerm : Pitch<TA>::kRowK;
  constexpr int pb = kAT ? Pitch<TB>::kPerm : Pitch<TB>::kNat;
  auto ta = [&](int s) {
    return reinterpret_cast<TA*>(region + (s % kStages) * kStage);
  };
  auto tb = [&](int s) {
    return reinterpret_cast<TB*>(region + (s % kStages) * kStage + kTileA);
  };
  const int tiles_n = (N + kTN - 1) / kTN;
  const int tiles = (M + kTM - 1) / kTM * tiles_n;
  const int n_st = (K + kTK - 1) / kTK;
  for (int tile = blockIdx.y * gridDim.x + blockIdx.x; tile < tiles;
       tile += gridDim.x * gridDim.y) {
    const int m0 = tile / tiles_n * kTM, n0 = tile % tiles_n * kTN;
    // stage s's copies as one group (an empty one past the last stage,
    // so that every wait below counts the same groups)
    auto issue = [&](int s) {
      if (s < n_st) {
        const int k0 = s * kTK;
        if constexpr (kAT)
          load_tile<kTK, kTM>(ta(s), pa, a, k0, m0, narrow);
        else
          load_tile<kTM, kTK>(ta(s), pa, a, m0, k0, narrow);
        load_tile<kTK, kTN>(tb(s), pb, b, k0, n0, narrow);
      }
      cp_async_commit();
    };
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    __syncthreads();                   // the last tile's readers are done
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int s = 0; s < n_st; ++s) {
      cp_async_wait<kStages - 2>();    // stage s has landed
      // ... for every thread, and every warp is done with stage s - 1,
      // whose buffer the next issue refills
      __syncthreads();
      issue(s + kStages - 1);
      const TA* at = ta(s);
      const TB* bt = tb(s);
      float sacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kTK / 8; ++ks) {
        // both operands in one k order: permuted (phase 3) or natural
        FragA fa;
        if constexpr (kAT)
          load_a_km(fa, at, 8 * ks, 16 * wm, lane, pa);
        else
          load_a_rows(fa, at, 16 * wm, 8 * ks, lane, pa);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          FragB fb;
          if constexpr (kAT)
            load_b_kn(fb, bt, 8 * ks, 32 * wn + 8 * n, lane, pb);
          else
            load_b_rows(fb, bt, 8 * ks, 32 * wn + 8 * n, lane, pb);
          mma_passes<kAExact, kBExact>(sacc[n], fa, fb);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += sacc[n][e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 16 * wm + g4 + 8 * i;
      if (m >= M) continue;
      const auto ctx = row(m);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + 32 * wn + 8 * n + 2 * t4 + c;
          if (col < N) epi(ctx, m, col, acc[n][2 * i + c]);
        }
    }
  }
}

// the owner's sums of the recurrence's products, one a gate
template <int NG>
struct Sums {
  float v[NG];
};

// One block an SM, 8 units x 32 rows a block (64 x 2 = 128 blocks at B =
// 64, H = 512): 255 registers a thread keep the products free of spills
// (held to 128 for two blocks an SM they spilled, and the kernel ran 5%
// and 8% slower in f32 and bf16 on the H100)
template <typename DT>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_bwd_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
                   const DT* __restrict__ u, const DT* __restrict__ h0,
                   const DT* __restrict__ out, const DT* __restrict__ g_out,
                   const DT* __restrict__ g_ht, DT* __restrict__ dxw,
                   DT* __restrict__ dh0, float* __restrict__ du,
                   float* __restrict__ gates, float* __restrict__ rh_seq,
                   DT* __restrict__ hp_seq, int* __restrict__ rowmap, int B,
                   int T, int H) {
  // bf16 h and U are exact in TF32 (tf32x3.cuh mma_passes)
  constexpr bool kExact = sizeof(DT) == 2;
  extern __shared__ float4 smem_f4[];
  int* pre = reinterpret_cast<int*>(smem_f4);   // [B + 1], then the max
  uint8_t* region = reinterpret_cast<uint8_t*>(smem_f4) + head_bytes(B);
  const int64_t G = 3 * static_cast<int64_t>(H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool narrow = H % 8 != 0;
  cg::grid_group grid = cg::this_grid();

  // ---- 0. the live rows ---------------------------------------------------
  // pre[b] = live rows of the samples before b (lengths clamped to
  // [0, T]), pre[B] = all of them, pre[B + 1] = the longest length
  if (warp == 0) {
    int carry = 0, longest = 0;
    for (int base = 0; base < B; base += 32) {
      const int v = base + lane < B ? min(max(lens[base + lane], 0), T) : 0;
      int x = v, y = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
        y = max(y, __shfl_xor_sync(0xffffffffu, y, off));
      }
      if (base + lane < B) pre[base + lane] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
      longest = max(longest, y);
    }
    if (lane == 0) {
      pre[B] = carry;
      pre[B + 1] = longest;
    }
  }
  __syncthreads();
  const int n_live = pre[B], t_max = pre[B + 1];
  {
    // row i belongs to the last sample b with pre[b] <= i (samples of
    // length 0 share their successor's pre), step t = i - pre[b]; a warp a
    // row, lanes over its 16- (8-) byte pieces
    const int nw = gridDim.x * gridDim.y * kWarps;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * kWarps + warp;
         i < n_live; i += nw) {
      int lo = 0, hi = B;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= i)
          lo = mid;
        else
          hi = mid;
      }
      const int t = i - pre[lo];
      const int64_t bt = static_cast<int64_t>(lo) * T + t;
      if (lane == 0) rowmap[i] = static_cast<int>(bt);
      const DT* src = t > 0 ? out + (bt - 1) * H
                            : h0 + static_cast<int64_t>(lo) * H;
      DT* dst = hp_seq + static_cast<int64_t>(i) * H;
      if (sizeof(DT) == 4 || !narrow) {
        constexpr int E = 16 / sizeof(DT);
        for (int c = E * lane; c < H; c += 32 * E)
          *reinterpret_cast<uint4*>(dst + c) =
              *reinterpret_cast<const uint4*>(src + c);
      } else {
        for (int c = 4 * lane; c < H; c += 128)
          *reinterpret_cast<uint2*>(dst + c) =
              *reinterpret_cast<const uint2*>(src + c);
      }
    }
  }
  grid.sync();

  // ---- 1. z, r, r*h_{t-1} and c of every live row -------------------------
  const Mat<DT> hp{hp_seq, H, n_live, H};
  const Mat<float> rh{rh_seq, H, n_live, H};
  // the epilogues' row: xw's row and h_{t-1}'s (plain loads: rowmap was
  // written before the last grid barrier and never read here before it)
  auto live_row = [&](int i) {
    const int64_t bt = rowmap[i], t = bt % T;
    return LiveRow<DT>{xw + bt * G,
                       t > 0 ? out + (bt - 1) * H : h0 + (bt / T) * H};
  };
  gemm<false, kExact, kExact>(
      hp, Mat<DT>{u, G, H, 2 * H}, n_live, 2 * H, H, narrow, region,
      live_row, [&](const LiveRow<DT>& r, int i, int n, float v) {
        const float s = sigmoid(to_f32(r.xw[n]) + v);
        gates[i * G + n] = s;
        if (n >= H)
          rh_seq[static_cast<int64_t>(i) * H + n - H] =
              s * to_f32(r.hp[n - H]);
      });
  grid.sync();                         // r*h_{t-1} of every unit is written
  gemm<false, false, kExact>(
      rh, Mat<DT>{u + 2 * H, G, H, H}, n_live, H, H, narrow, region,
      live_row, [&](const LiveRow<DT>& r, int i, int n, float v) {
        gates[i * G + 2 * H + n] = tanhf(to_f32(r.xw[2 * H + n]) + v);
      });
  grid.sync();                         // every gate is written

  // ---- 2. the reverse recurrence -------------------------------------------
  const int j0 = blockIdx.x * kOwnUnits, b0 = blockIdx.y * kRows;
  const int nit = (H + 63) / 64;
  // us[(((g*nit + it)*4 + kk)*2 + h)*16 + l] = U[j0 + 4h + 0..3, g*H + k]
  // for k = 64 it + 4 l + kk: a half-warp's 16-byte loads of its columns
  // are consecutive (free of bank conflicts), the two halves' the same
  float4* us = reinterpret_cast<float4*>(region);
  for (int idx = tid; idx < 3 * nit * 128; idx += kThreads) {
    const int l = idx & 15, h = (idx >> 4) & 1, kk = (idx >> 5) & 3;
    const int rest = idx >> 7, it = rest % nit, g = rest / nit;
    const int k = 64 * it + 4 * l + kk;
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 4 * h + q;
      w[q] = j < H && k < H ? to_f32(u[j * G + g * H + k]) : 0.f;
    }
    us[idx] = make_float4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  // the warp's 4 rows' lengths; half-warp h takes rows 2h and 2h + 1, of
  // which this lane keeps the first live row index
  const int half = lane >> 4, kl = lane & 15;
  int wlen[kRowsW], rib[2], rlen[2];
#pragma unroll
  for (int q = 0; q < kRowsW; ++q) {
    const int bb = b0 + kRowsW * warp + q;
    wlen[q] = bb < B ? pre[bb + 1] - pre[bb] : 0;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int bb = b0 + kRowsW * warp + 2 * half + q;
    rib[q] = bb < B ? pre[bb] : 0;
    rlen[q] = bb < B ? pre[bb + 1] - pre[bb] : 0;
  }
  // this lane owns (row l / 8 of the warp, unit l % 8 of the block): the
  // index that the reduce-scatter leaves it
  const int ro = lane >> 3;
  const int b = b0 + kRowsW * warp + ro, unit = j0 + (lane & 7);
  const bool own = b < B && unit < H;
  const int len = own ? pre[b + 1] - pre[b] : 0;
  const int ib = own ? pre[b] : 0;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;

  // sums over all H units k of cot[row, g*H + k] * U[unit, g*H + k] for
  // the gates g = g0 .. g0 + NG - 1 (their loads all in flight at once)
  // and the warp's rows live at t, as the owner's values (0 for a dead
  // row): lane (h, l) the columns 64 it + 4 l .. +3 of rows 2h, 2h + 1
  // against the block's 8 units, 16 sums a gate, reduced over the
  // half-warp
  auto dot = [&](auto ng, int g0, int t) {
    constexpr int NG = decltype(ng)::value;
    Sums<NG> out;
#pragma unroll
    for (int g = 0; g < NG; ++g) out.v[g] = 0.f;
    bool any = false;
#pragma unroll
    for (int q = 0; q < kRowsW; ++q) any |= t < wlen[q];
    if (!any) return out;              // uniform across the warp
    const bool rl[2] = {t < rlen[0], t < rlen[1]};
    float acc[NG][16];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[g][e] = 0.f;
    for (int it0 = 0; it0 < nit; it0 += kChunk) {
      float4 d[NG][kChunk][2];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          const int k = 64 * (it0 + s) + 4 * kl;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            d[g][s][q] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (it0 + s < nit && k < H && rl[q])
              d[g][s][q] = __ldcg(reinterpret_cast<const float4*>(
                  gates + (rib[q] + t) * G + (g0 + g) * H + k));
          }
        }
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int s = 0; s < kChunk; ++s) {
          if (it0 + s >= nit) continue;
          const float4* ws = us + ((g0 + g) * nit + it0 + s) * 128 + kl;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w0 = ws[kk * 32], w1 = ws[kk * 32 + 16];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float x = comp(d[g][s][q], kk);
              const float w[8] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[g][8 * q + e] = fmaf(x, w[e], acc[g][8 * q + e]);
            }
          }
        }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      // over the half-warp: lane l keeps index l % 16
      recur::reduce_scatter<8>(acc[g], lane);
      out.v[g] = acc[g][0];
    }
    return out;
  };

  float dh = own ? to_f32(g_ht[bh]) : 0.f;
  // the owner's inputs of step t, loaded a step ahead (h_{t-1} and g_out
  // kept in the I/O dtype until used)
  float z = 0.f, r = 0.f, c = 0.f;
  DT hp_x = DT(0.f), go_x = DT(0.f);
  auto fetch = [&](int t) {
    if (t < 0 || t >= len) return;
    const float* gr = gates + (ib + t) * G + unit;
    z = __ldcg(gr);
    r = __ldcg(gr + H);
    c = __ldcg(gr + 2 * H);
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    hp_x = t > 0 ? out[(bt - 1) * H + unit] : h0[bh];
    go_x = g_out[bt * H + unit];
  };
  fetch(t_max - 1);
  for (int t = t_max - 1; t >= 0; --t) {
    const bool live = t < len;          // false for lanes that own nothing
    float* gr = gates + (ib + t) * G + unit;
    DT* dx = dxw + (static_cast<int64_t>(b) * T + t) * G + unit;
    const float zt = z, rt = r, ct = c;
    const float hpv = to_f32(hp_x);
    float dh_t = 0.f, dhp = 0.f;
    if (live) {                         // m = 1
      dh_t = dh + to_f32(go_x);
      dhp = dh_t;
      const float dgz = (dhp * (ct - hpv)) * zt * (1.f - zt);
      const float dgc = (dhp * zt) * (1.f - ct * ct);
      gr[0] = dgz;
      gr[2 * H] = dgc;
      store_f32(dgz, dx);
      store_f32(dgc, dx + 2 * H);
    }
    fetch(t - 1);
    grid.sync();                        // every dgz and dgc of step t
    const float drh = dot(std::integral_constant<int, 1>(), 2, t).v[0];
    if (live) {
      const float dgr = (drh * hpv) * rt * (1.f - rt);
      gr[H] = dgr;
      store_f32(dgr, dx + H);
    }
    grid.sync();                        // every dgr of step t
    const Sums<2> azr = dot(std::integral_constant<int, 2>(), 0, t);
    const float az = azr.v[0], ar = azr.v[1];
    // a dead row keeps dh: its cotangents, and so its terms, are 0
    if (live) dh = ((dhp * (1.f - zt)) + drh * rt) + az + ar;
  }
  if (own) {
    store_f32(dh, dh0 + bh);
    for (int t = len; t < T; ++t) {
      DT* dx = dxw + (static_cast<int64_t>(b) * T + t) * G + unit;
      store_f32(0.f, dx);
      store_f32(0.f, dx + H);
      store_f32(0.f, dx + 2 * H);
    }
  }
  grid.sync();                          // every cotangent is written

  // ---- 3. dU over the live rows --------------------------------------------
  auto no_row = [](int) { return 0; };
  gemm<true, kExact, false>(
      hp, Mat<float>{gates, G, n_live, 2 * H}, H, 2 * H, n_live, narrow,
      region, no_row, [&](int, int j, int q, float v) { du[j * G + q] = v; });
  gemm<true, false, false>(
      rh, Mat<float>{gates + 2 * H, G, n_live, H}, H, H, n_live, narrow,
      region, no_row,
      [&](int, int j, int q, float v) { du[j * G + 2 * H + q] = v; });
}

template <typename DT>
int launch(const void* xw, const int* lens, const void* u, const void* h0,
           const void* out, const void* g_out, const void* g_ht, void* dxw,
           void* dh0, float* du, float* gates, float* rh_seq, void* hp_seq,
           int* rowmap, int B, int T, int H, cudaStream_t stream) {
  void* args[] = {&xw,  &lens, &u,      &h0,     &out,    &g_out,
                  &g_ht, &dxw, &dh0,    &du,     &gates,  &rh_seq,
                  &hp_seq, &rowmap, &B, &T,      &H};
  return launch_cooperative(gru_seq_bwd_kernel<DT>, B, H,
                            bwd_smem_bytes(B, H), args, stream, kOwnUnits);
}

}  // namespace
}  // namespace paddle_tpu_torch

// The forward's arguments (xw with the bias added, lens, u, h0; see
// gru_seq.cu), out [B, T, H] saved by paddle_gru_seq, the cotangents g_out
// [B, T, H] and g_ht [B, H]; outputs dxw [B, T, 3H] and dh0 [B, H] in the
// I/O dtype and du [H, 3H] f32. Scratch for B*T rows (the live ones are
// used): gates [B*T, 3H] f32 (the gates, then the gate cotangents), rh_seq
// [B*T, H] f32, hp_seq [B*T, H] in the I/O dtype and rowmap [B*T] int32.
// Returns the launch's cudaError_t, or 720 when the grid does not fit in
// one wave or a block's shared memory exceeds the limit.
extern "C" int paddle_gru_seq_bwd(const void* xw, const int* lens,
                                  const void* u, const void* h0,
                                  const void* out, const void* g_out,
                                  const void* g_ht, void* dxw, void* dh0,
                                  float* du, float* gates, float* rh_seq,
                                  void* hp_seq, int* rowmap, int B, int T,
                                  int H, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (H % lstm::kUnits != 0 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(xw, lens, u, h0, out, g_out, g_ht, dxw, dh0, du,
                         gates, rh_seq, hp_seq, rowmap, B, T, H, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(xw, lens, u, h0, out, g_out, g_ht, dxw, dh0,
                                 du, gates, rh_seq, hp_seq, rowmap, B, T, H,
                                 st);
  return (int)cudaErrorInvalidValue;
}
