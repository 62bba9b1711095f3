// Backward of the masked LSTM sequence for Hopper (sm_90a).
//
// Replaces the TPU kernel _lstm_seq_bwd_kernel (paddle_tpu/ops/
// pallas_kernels.py, called by lstm_sequence_fused_bwd): the reverse-time
// recurrence from the forward's residuals (xw, the masked outputs and the
// post-mask cell sequence) and the output cotangents. At each step t, from
// T-1 down to 0, it recomputes the gates from xw_t + h_{t-1} @ U + b, with
// h_{t-1} the saved out[t-1] (h0 at t = 0), forms the gate cotangents
// dgates [B, 4H] (written to dxw in the I/O dtype), adds h_{t-1}^T dgates
// to dU and carries dh_{t-1} = (1-m) dh_t + dgates @ U^T and
// dc_{t-1} = (1-m) dc + dc_t f back, m the step's mask. Returns dxw, dh0,
// dc0 and dU [H, 4H] in f32. dx, dW and db are products outside (ops/rnn.py).
//
// What bounds it on the H100: three products of 2*B*H*4H operations a
// step (the gate recompute, dU, dh_{t-1}), but only the dh product is
// serial: the recompute reads only saved outputs, and dU only the step's
// cotangents. The serial part is bound by its grid barrier and by the
// latency of the exchange through L2 that each step needs.
//
// Design: the forward's cooperative grid (lstm.cuh), block (x, y) owning
// kUnits hidden units -- 16 gate columns -- for kRows batch rows, one
// launch in three phases:
//  1. gate recompute, parallel over t: the block's [kRows*T, H] x [H, 16]
//     product on the tensor cores (mma.sync with three TF32 passes,
//     tf32x3.cuh: f32 accuracy, as the JAX kernel's f32 products; one
//     pass for bf16 operands, which TF32 holds exactly), the h_{t-1} rows
//     of ns steps a stage by cp.async, two stages in flight, against U's
//     16 columns kept transposed in shared memory; the activated i, f, g,
//     o go to an f32 scratch sequence [T, B, 4H] that only their owner
//     lane reads back (a block barrier, no grid barrier, ends the phase).
//  2. the reverse recurrence, one grid barrier and one product a step:
//     the owner lanes (lstm.cuh Lane) form dgates from the saved gates,
//     c_seq and their dh and dc registers (the JAX kernel's op order) and
//     write them to dxw and, in f32, over the gates they were formed from
//     (the same owner lane read those four entries, and nothing else
//     reads them again): the scratch becomes the cotangent sequence
//     [T, B, 4H]. The block forms its 16 columns' share of dgates @ U^T
//     for its rows and every unit ([kRows x 16] . [16 x H], tensor cores)
//     and writes it to a partials buffer; after the barrier each block
//     sums its 4 units' partials over the H/4 blocks of its batch tile in
//     a fixed order.
//     A block so reads 32 KB a step where staging its rows' dgates (all
//     4H columns) read 128 KB, and the partial is written once.
//  3. dU, parallel over (t, b): dU[:, block's columns] = sum h_{t-1}^T
//     dgates over the block's rows and all steps, on the tensor cores from
//     the f32 cotangent sequence, in registers, each pipeline stage into
//     fresh accumulators added up in f32 (tf32x3.cuh, "Accumulation"). With
//     several batch tiles each tile's sum goes to a partial buffer and,
//     after one more grid barrier, the first tile's blocks add the partials
//     in a fixed order.
// A step at or past a row's length adds nothing (its mask is 0): such
// rows are not staged, exchanged or summed, and steps past the block's
// longest row are skipped. Every output element has one owner and no
// atomics are used, so the result is deterministic. Shared memory holds,
// in turn, phase 1's U^T and stages, phase 2's U columns and dgates, and
// phase 3's stages.
#include "lstm.cuh"
#include "tf32x3.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace lstm;

constexpr int kCols = 4 * kUnits;      // gate columns a block owns: 16
constexpr int kWarps = kThreads / 32;  // 8
// pitch of a [rows][16 columns] f32 tile (staged dgates, U's columns)
constexpr int kLdDg = kCols + 4;
// the shared memory the plan may take: of the 227 KB a block may have
// where the grid is one block an SM, and half the SM's where it needs two
// (the kernel's launch bounds hold it to 128 registers a thread, which
// leave room for two blocks). ops/rnn_kernels.py _lstm_bwd_smem and
// _BWD_BLOCK repeat these budgets and make_plan's layout to plan routes;
// tests/test_torch_gpu.py test_bwd_planner_meets_the_kernels_limit_on_card
// holds the two sides together.
constexpr int kBudget = 200 * 1024, kBudgetTwo = 110 * 1024;
// the block's rows' lengths, at the start of shared memory
constexpr size_t kHeadBytes = kRows * sizeof(int);
// phase 1: the K-split partial sums (at most 3 parts x 2 m-tiles, or
// 1 x 4, of 32 lanes x 8 floats)
constexpr size_t kPartBytes = 8192;
// phase 3: m-tiles (16 hidden units) a warp accumulates in one pass
constexpr int kMPerWarp = 4;

// The layout of one H, I/O dtype (element size ``es``) and budget, the
// same on the host (launch) and in the kernel; sizes in bytes past the
// lengths.
struct Plan {
  int hp;       // H rounded up to a multiple of 16 (zero-padded columns)
  int ldh;      // pitch of U^T's rows, f32: hp + 4 (= 4 mod 8)
  int ldx;      // pitch of a staged h row in the I/O dtype: 16-byte rows
  int ns;       // steps a stage of phases 1 and 3 (two stages in flight)
  int kw;       // phase 1: warps sharing an m-tile's reduction
  size_t stage; // bytes of one stage of staged h rows
  size_t bytes; // the kernel's dynamic shared memory
};

__host__ __device__ inline Plan make_plan(int H, int es, size_t budget) {
  Plan p;
  p.hp = (H + 15) / 16 * 16;
  p.ldh = p.hp + 4;
  p.ldx = p.hp + (es == 4 ? 4 : 8);
  const size_t ut = static_cast<size_t>(kCols) * p.ldh * 4;
  size_t p1 = 0, p3 = 0;
  for (p.ns = 4; p.ns >= 1; p.ns /= 2) {
    const size_t rows = static_cast<size_t>(kRows) * p.ns;
    p.stage = rows * p.ldx * es;
    p1 = ut + 2 * p.stage + kPartBytes;
    p3 = 2 * (p.stage + rows * kLdDg * 4);
    if (p.ns == 1 || (p1 <= budget && p3 <= budget)) break;
  }
  // the 8 warps over 2 ns m-tiles, each m-tile's reduction split in kw
  // parts of a multiple of 16
  p.kw = kThreads / 32 / (2 * p.ns);
  while (p.kw > 1 && (p.hp / 16) % p.kw) p.kw /= 2;
  // phase 2: U's block columns [hp][kLdDg] and the step's dgates
  const size_t p2 = static_cast<size_t>(p.hp + kRows) * kLdDg * 4;
  size_t m = p1 > p2 ? p1 : p2;
  p.bytes = kHeadBytes + (m > p3 ? m : p3);
  return p;
}

// h_{t-1} rows of the block's tile for steps t0 .. t0 + nst - 1 (the saved
// output at t > 0, h0 at t = 0) into dst[s * kRows + r][0 .. H) in the
// I/O dtype, by cp.async: warp w copies rows w, w + 8, ..., its lanes 16
// bytes apart (8 where a bf16 row is no multiple of 16 bytes). Rows past
// B, and rows whose step is at or past the sample's length (the mask
// zeroes all they feed), are neither read nor written.
template <typename DT>
__device__ __forceinline__ void stage_h_async(const DT* out, const DT* h0,
                                              int t0, int nst, int b0, int B,
                                              int T, int H,
                                              const int* lens_s, DT* dst,
                                              int ld, int warp, int lane) {
  for (int R = warp; R < nst * kRows; R += kThreads / 32) {
    const int s = R / kRows, r = R % kRows;
    const int t = t0 + s, b = b0 + r;
    if (b >= B || t >= lens_s[r]) continue;
    const DT* src = t > 0 ? out + (static_cast<int64_t>(b) * T + t - 1) * H
                          : h0 + static_cast<int64_t>(b) * H;
    DT* d = dst + R * ld;
    if (sizeof(DT) == 4 || H % 8 == 0) {  // 16 bytes a copy
      constexpr int E = 16 / sizeof(DT);
      for (int c = E * lane; c < H; c += 32 * E)
        tf32x3::cp_async16(d + c, src + c, true);
    } else {                              // bf16 rows of 4k + 4 elements
      for (int c = 4 * lane; c < H; c += 128)
        tf32x3::cp_async8(d + c, src + c);
    }
  }
}

// zero columns H .. hp of ``rows`` rows of a staged tile
template <typename DT>
__device__ __forceinline__ void zero_pad(DT* tile, int rows, int H, int hp,
                                         int ld) {
  const int w = hp - H;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads)
    store_f32(0.f, tile + (idx / w) * ld + H + idx % w);
}

template <typename DT>
__global__ void __launch_bounds__(kThreads, 2)
lstm_seq_bwd_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
                    const DT* __restrict__ u, const DT* __restrict__ bias,
                    const DT* __restrict__ h0, const DT* __restrict__ c0,
                    const DT* __restrict__ out, const DT* __restrict__ c_seq,
                    const DT* __restrict__ g_out, const DT* __restrict__ g_ht,
                    const DT* __restrict__ g_ct, DT* __restrict__ dxw,
                    DT* __restrict__ dh0, DT* __restrict__ dc0,
                    float* __restrict__ du, float* __restrict__ gates,
                    float* __restrict__ dh_part, float* __restrict__ du_part,
                    int B, int T, int H,
                    float forget_bias, int budget) {
  using namespace tf32x3;
  // bf16 h and U are exact in TF32 (see mma_passes)
  constexpr bool kExact = sizeof(DT) == 2;
  extern __shared__ float4 smem_f4[];
  const Plan p = make_plan(H, sizeof(DT), budget);
  int* lens_s = reinterpret_cast<int*>(smem_f4);            // [kRows]
  uint8_t* region = reinterpret_cast<uint8_t*>(smem_f4) + kHeadBytes;
  float* smem = reinterpret_cast<float*>(region);
  const int64_t G = 4 * static_cast<int64_t>(H);
  const int64_t BG = B * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const Lane l;
  const int j0 = blockIdx.x * kUnits, b0 = blockIdx.y * kRows;
  const int r = l.row(), b = b0 + r, unit = j0 + l.u;
  const bool live = l.owner() && b < B;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;
  // gate column q of the block (q = gate * kUnits + unit) in [0, 4H)
  auto gcol = [&](int q) { return (q / kUnits) * H + j0 + q % kUnits; };
  cg::grid_group grid = cg::this_grid();

  // the rows' lengths (0 past B), and the block's last live step + 1:
  // steps at or past it are dead for every row of the block
  if (tid < kRows) lens_s[tid] = b0 + tid < B ? min(lens[b0 + tid], T) : 0;
  __syncthreads();
  int t_end = 0;
  for (int i = 0; i < kRows; ++i) t_end = max(t_end, lens_s[i]);

  // ---- phase 1: the gates of every live step ------------------------------
  {
    float* ut = smem;                                   // [kCols][ldh]: U^T
    // two stages of h rows [ns * kRows][ldx] in the I/O dtype, then the
    // K-split partial sums [kw - 1][2 ns m-tiles][32 lanes][8]
    uint8_t* hs0 = region + kCols * p.ldh * 4;
    auto hs = [&](int k) { return reinterpret_cast<DT*>(hs0 + k * p.stage); };
    float* part = reinterpret_cast<float*>(hs0 + 2 * p.stage);
    for (int idx = tid; idx < kCols * p.hp; idx += kThreads) {
      const int q = idx / p.hp, k = idx % p.hp;
      ut[q * p.ldh + k] = k < H ? to_f32(u[k * G + gcol(q)]) : 0.f;
    }
    zero_pad(hs(0), p.ns * kRows, H, p.hp, p.ldx);
    zero_pad(hs(1), p.ns * kRows, H, p.hp, p.ldx);
    // warp w takes m-tile w % mtiles (16 staged rows, both n-tiles of the
    // 16 columns) over the kp-th of kw parts of the reduction; part 0's
    // warps add the other parts' sums in order and activate the gates
    const int mtiles = 2 * p.ns, kw = p.kw;
    const int mt = warp % mtiles, kp = warp / mtiles;
    const int klen = p.hp / kw, kbeg = kp * klen;
    // the bias of this thread's accumulator columns (n-tile n: columns
    // 8n + 2t4 and 8n + 2t4 + 1, of one gate)
    float bcol[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        bcol[n][c] = to_f32(bias[gcol(8 * n + 2 * t4 + c)]);
    // stages of ns steps, the next one in flight during this one's product
    const int n_st = (t_end + p.ns - 1) / p.ns;
    auto issue = [&](int si) {
      const int t0 = si * p.ns, nst = min(p.ns, t_end - t0);
      stage_h_async(out, h0, t0, nst, b0, B, T, H, lens_s, hs(si & 1),
                    p.ldx, warp, lane);
      cp_async_commit();
    };
    if (n_st > 0) issue(0);
    for (int si = 0; si < n_st; ++si) {
      const int t0 = si * p.ns;
      // this thread's epilogue rows (g4, g4 + 8 of its m-tile) and their
      // xw, loaded now so that the loads overlap the product
      int rt[2], rb[2];
      DT xv[2][2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * mt + g4 + 8 * i;
        rt[i] = t0 + row / kRows;
        rb[i] = b0 + row % kRows;
        const bool ok = kp == 0 && warp < mtiles * kw && rt[i] < t_end &&
                        rb[i] < B;
        const int64_t bt = static_cast<int64_t>(rb[i]) * T + rt[i];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            xv[i][n][c] = ok ? xw[bt * G + gcol(8 * n + 2 * t4) + c]
                             : DT(0.f);
      }
      if (si + 1 < n_st) issue(si + 1);
      if (si + 1 < n_st)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      const DT* hb = hs(si & 1);
      float acc[2][2][4];              // [k-step parity][n-tile]
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h2][n][e] = 0.f;
      if (warp < mtiles * kw) {
#pragma unroll 2
        for (int k0 = kbeg; k0 < kbeg + klen; k0 += 16) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            FragA fa;
            FragB f0, f1;
            load_a_rows(fa, hb, 16 * mt, k0 + 8 * h2, lane, p.ldx);
            load_b_nk2(f0, f1, ut, 0, k0 + 8 * h2, lane, p.ldh);
            mma_passes<kExact, kExact>(acc[h2][0], fa, f0);
            mma_passes<kExact, kExact>(acc[h2][1], fa, f1);
          }
        }
      }
      float sum[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[n][e] = acc[0][n][e] + acc[1][n][e];
      if (kw > 1) {
        if (kp > 0 && warp < mtiles * kw) {
          float* mp = part + (((kp - 1) * mtiles + mt) * 32 + lane) * 8;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) mp[4 * n + e] = sum[n][e];
        }
        __syncthreads();
        if (kp == 0)
          for (int q = 1; q < kw; ++q) {
            const float* mp = part + (((q - 1) * mtiles + mt) * 32 + lane) * 8;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[n][e] += mp[4 * n + e];
          }
      }
      if (kp == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (rt[i] >= t_end || rb[i] >= B) continue;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int q = 8 * n + 2 * t4;
            const int64_t col = gcol(q);   // q, q + 1: units u, u + 1
            const int gate = q / kUnits;
            float a[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              // the op order of lstm.cuh activate: (xw + h_{t-1} @ U) + b,
              // then + forget_bias for f
              float x = (to_f32(xv[i][n][c]) + sum[n][2 * i + c]) +
                        bcol[n][c];
              if (gate == 1) x += forget_bias;
              a[c] = gate == 2 ? tanhf(x) : sigmoid(x);
            }
            *reinterpret_cast<float2*>(
                gates + (static_cast<int64_t>(rt[i]) * B + rb[i]) * G +
                col) = make_float2(a[0], a[1]);
          }
        }
      }
      __syncthreads();                 // every warp is done with this stage
    }
  }

  // ---- phase 2: the reverse recurrence ------------------------------------
  // uq[j][q] = U[j, gcol(q)]: U's 16 block columns, row j for unit j
  float* uq = smem;                               // [hp][kLdDg]
  float* dgl = uq + p.hp * kLdDg;                 // [kRows][kLdDg]
  __syncthreads();   // phase 1's readers are done; its gate writes visible
  for (int idx = tid; idx < p.hp * kCols; idx += kThreads) {
    const int j = idx / kCols, q = idx % kCols;
    uq[j * kLdDg + q] = j < H ? to_f32(u[j * G + gcol(q)]) : 0.f;
  }
  float dh = 0.f, dc = 0.f;
  int len = 0;
  if (live) {
    dh = to_f32(g_ht[bh]);
    dc = to_f32(g_ct[bh]);
    len = lens[b];
  }
  // the owner's inputs of step t, loaded a step ahead (c_prev and g_out
  // kept in the I/O dtype until used, so that the loads stay in flight
  // across the barrier); a dead step's gates were never computed and enter
  // only through products with m = 0, so they are taken as 0
  float gi = 0.f, gf = 0.f, gg = 0.f, go_ = 0.f;
  DT c_prev_x = DT(0.f), gout_x = DT(0.f);
  auto fetch = [&](int t) {
    if (!live || t < 0) return;
    gi = gf = gg = go_ = 0.f;
    if (t < len) {
      const float* gr = gates + (static_cast<int64_t>(t) * B + b) * G + unit;
      gi = gr[0];
      gf = gr[H];
      gg = gr[2 * H];
      go_ = gr[3 * H];
    }
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    c_prev_x = t > 0 ? c_seq[bt * H - H + unit] : c0[bh];
    gout_x = g_out[bt * H + unit];
  };
  fetch(T - 1);
  // the partials: block x' writes dhp[t & 1][x'][b][j] for its rows and
  // every unit j; block x sums its units' 4 columns over all x'. Thread
  // (rr = tid / 8, pp = tid % 8) sums row rr over the pp-th eighth of x'.
  const int X = gridDim.x, xper = (X + 7) / 8;
  const int rr = tid >> 3, pp = tid & 7;
  const int64_t BH = static_cast<int64_t>(B) * H;
  for (int t = T - 1; t >= 0; --t) {
    // step t's gates, read by fetch(t), become its cotangents
    float* dg_t = gates + static_cast<int64_t>(t) * BG;
    float dh_keep = 0.f;
    if (l.owner()) {
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const float i = gi, f = gf, g = gg, o = go_;
        const float c_prev = to_f32(c_prev_x);
        const float c_cur = f * c_prev + i * g;
        const float tc = tanhf(c_cur);
        const float m = t < len ? 1.f : 0.f;
        const float dh_t = dh + m * to_f32(gout_x);
        const float dhp = m * dh_t;
        const float dct = m * dc + dhp * o * (1.f - tc * tc);
        const float do_ = dhp * tc;
        dg[0] = (dct * g) * i * (1.f - i);
        dg[1] = (dct * c_prev) * f * (1.f - f);
        dg[2] = (dct * i) * (1.f - g * g);
        dg[3] = do_ * o * (1.f - o);
        const int64_t bt = static_cast<int64_t>(b) * T + t;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          store_f32(dg[k], dxw + bt * G + k * H + unit);
          dg_t[static_cast<int64_t>(b) * G + k * H + unit] = dg[k];
        }
        dh_keep = (1.f - m) * dh_t;
        dc = (1.f - m) * dc + dct * f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) dgl[r * kLdDg + k * kUnits + l.u] = dg[k];
    }
    fetch(t - 1);
    float* dhp_t = dh_part + static_cast<int64_t>(t & 1) * X * BH;
    __syncthreads();                   // the step's dgates are in dgl
    // the block's partial of dh_{t-1} = dgates_t @ U^T over its 16
    // columns, for its live rows and every unit: [kRows x 16] . [16 x H]
    // on the tensor cores; warp w takes the n-tiles (units) 16w, 16w + 128
    // and so on, both m-tiles (rows)
    if (t < t_end) {
      FragA fa[2][2];                  // [m-tile][k step]
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          load_a(fa[m][ks], dgl, 16 * m, 8 * ks, lane, kLdDg);
      float* prow = dhp_t + blockIdx.x * BH + static_cast<int64_t>(b0) * H;
      for (int n0 = 16 * warp; n0 < p.hp; n0 += 16 * kWarps) {
        float acc[2][2][4] = {};       // [m-tile][n-tile]
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          FragB f0, f1;
          load_b_nk2(f0, f1, uq, n0, 8 * ks, lane, kLdDg);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_passes<false, kExact>(acc[m][0], fa[m][ks], f0);
            mma_passes<false, kExact>(acc[m][1], fa[m][ks], f1);
          }
        }
        // rows dead at t have no partial (their readers skip them)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 16 * m + g4 + 8 * i;
            if (t >= lens_s[row]) continue;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int j = n0 + 8 * n + 2 * t4;
              if (j < H)
                *reinterpret_cast<float2*>(prow + row * H + j) =
                    make_float2(acc[m][n][2 * i], acc[m][n][2 * i + 1]);
            }
          }
      }
    }
    // every block's partials of step t are written after this
    grid.sync();

    // dh_{t-1} of this block's units: the X partials summed in a fixed
    // order (each thread an eighth of them in order, then a butterfly over
    // the 8 threads of the row), 16-byte loads of the 4 units past L1
    float mine = 0.f;
    if (t < t_end) {
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < lens_s[rr]) {
        const float* src = dhp_t + static_cast<int64_t>(b0 + rr) * H + j0;
        const int x1 = min(X, (pp + 1) * xper);
        // eight loads in flight at a time, then their sum in order
        for (int xb = pp * xper; xb < x1; xb += 8) {
          float4 v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = xb + k < x1 ? __ldcg(reinterpret_cast<const float4*>(
                                     src + (xb + k) * BH))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            s4.x += v[k].x;
            s4.y += v[k].y;
            s4.z += v[k].z;
            s4.w += v[k].w;
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        s4.x += __shfl_xor_sync(0xffffffffu, s4.x, off);
        s4.y += __shfl_xor_sync(0xffffffffu, s4.y, off);
        s4.z += __shfl_xor_sync(0xffffffffu, s4.z, off);
        s4.w += __shfl_xor_sync(0xffffffffu, s4.w, off);
      }
      // warp w holds rows 4w .. 4w + 3 at lanes 8i .. 8i + 7; the owner of
      // (row 4w + i, unit u), lane 8u + i, takes component u of lane 8i
      const int from = 8 * (lane & 3);
      const float vx = __shfl_sync(0xffffffffu, s4.x, from);
      const float vy = __shfl_sync(0xffffffffu, s4.y, from);
      const float vz = __shfl_sync(0xffffffffu, s4.z, from);
      const float vw = __shfl_sync(0xffffffffu, s4.w, from);
      const int uu = lane >> 3;
      mine = uu == 0 ? vx : uu == 1 ? vy : uu == 2 ? vz : vw;
    }
    dh = dh_keep + mine;
  }
  if (live) {
    store_f32(dh, dh0 + bh);
    store_f32(dc, dc0 + bh);
  }

  // ---- phase 3: dU of the block's columns over all rows and steps --------
  const int tiles = gridDim.y;
  float* dst = tiles == 1 ? du : du_part + blockIdx.y * H * G;
  {
    // two stages, each h rows [ns * kRows][ldx] (I/O dtype) then the
    // block's 16 dgates columns [ns * kRows][kLdDg] (f32)
    const int nrows = p.ns * kRows;
    const size_t stage_bytes = p.stage + nrows * kLdDg * 4;
    auto hs = [&](int k) {
      return reinterpret_cast<DT*>(region + k * stage_bytes);
    };
    auto dgs = [&](int k) {
      return reinterpret_cast<float*>(region + k * stage_bytes + p.stage);
    };
    __syncthreads();                   // phase 2's readers of the region
    // a dead row adds exactly 0: its dgates are zero-filled, and its h row
    // holds zeros or an earlier stage's finite row, so both h buffers
    // start as zeros
    for (int idx = tid; idx < 2 * nrows * p.ldx; idx += kThreads)
      store_f32(0.f, hs(idx / (nrows * p.ldx)) + idx % (nrows * p.ldx));
    // steps t0 .. t0 + nst - 1 into stage k: dgates as 4 runs of 4
    // columns a row (dead rows zero-filled, not read), the live h rows
    auto issue = [&](int t0, int k) {
      const int nst = min(p.ns, t_end - t0);
      for (int idx = tid; idx < nst * kRows * kUnits; idx += kThreads) {
        const int row = idx / kUnits, gq = idx % kUnits;
        const int t = t0 + row / kRows, ri = row % kRows;
        const bool in = t < lens_s[ri];
        cp_async16(dgs(k) + row * kLdDg + gq * kUnits,
                   in ? gates + (static_cast<int64_t>(t) * B + b0 + ri) * G +
                            gq * H + j0
                      : gates,
                   in);
      }
      stage_h_async(out, h0, t0, nst, b0, B, T, H, lens_s, hs(k), p.ldx,
                    warp, lane);
      cp_async_commit();
    };
    // dU[m, q] = sum over the staged rows k of h[k][m] dg[k][q] on the
    // tensor cores (A = h^T by load_a_km, B = dgates by load_b_kn); warp w
    // takes the m-tiles (16 hidden units) w, w + 8, ... in passes of
    // kMPerWarp; each stage sums into fresh accumulators, added to the
    // running sums in f32 (tf32x3.cuh, "Accumulation")
    const int mtiles = p.hp / 16;
    const int n_st = (t_end + p.ns - 1) / p.ns;
    for (int mp = 0; mp < mtiles; mp += kWarps * kMPerWarp) {
      float acc[kMPerWarp][2][4];
#pragma unroll
      for (int j = 0; j < kMPerWarp; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
      __syncthreads();                 // the zeroed buffers, or the last pass
      if (n_st > 0) issue(0, 0);
      for (int si = 0; si < n_st; ++si) {
        const int t0 = si * p.ns;
        if (si + 1 < n_st) {
          issue(t0 + p.ns, (si + 1) & 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const DT* hb = hs(si & 1);
        const float* db = dgs(si & 1);
        const int nk = min(p.ns, t_end - t0) * kRows;
        float sacc[kMPerWarp][2][4];
#pragma unroll
        for (int j = 0; j < kMPerWarp; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[j][n][e] = 0.f;
        for (int k0 = 0; k0 < nk; k0 += 8) {
          FragB f0, f1;
          load_b_kn(f0, db, k0, 0, lane, kLdDg);
          load_b_kn(f1, db, k0, 8, lane, kLdDg);
#pragma unroll
          for (int j = 0; j < kMPerWarp; ++j) {
            const int mt = mp + warp + kWarps * j;
            if (mt < mtiles) {
              FragA fa;
              load_a_km(fa, hb, k0, 16 * mt, lane, p.ldx);
              mma_passes<kExact, false>(sacc[j][0], fa, f0);
              mma_passes<kExact, false>(sacc[j][1], fa, f1);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kMPerWarp; ++j)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][n][e] += sacc[j][n][e];
        __syncthreads();               // every warp is done with this stage
      }
#pragma unroll
      for (int j = 0; j < kMPerWarp; ++j) {
        const int mt = mp + warp + kWarps * j;
        if (mt >= mtiles) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 16 * mt + g4 + 8 * i;
          if (k >= H) continue;
#pragma unroll
          for (int n = 0; n < 2; ++n)
            *reinterpret_cast<float2*>(dst + k * G + gcol(8 * n + 2 * t4)) =
                make_float2(acc[j][n][2 * i], acc[j][n][2 * i + 1]);
        }
      }
    }
  }
  if (tiles == 1) return;
  grid.sync();
  if (blockIdx.y != 0) return;
  for (int idx = tid; idx < H * kCols; idx += kThreads) {
    const int k = idx / kCols, q = idx % kCols;
    const int64_t off = k * G + gcol(q);
    float sum = 0.f;
    for (int y = 0; y < tiles; ++y) sum += __ldcg(du_part + y * H * G + off);
    du[off] = sum;
  }
}

template <typename DT>
int launch(const void* xw, const int* lens, const void* u, const void* b,
           const void* h0, const void* c0, const void* out,
           const void* c_seq, const void* g_out, const void* g_ht,
           const void* g_ct, void* dxw, void* dh0, void* dc0, float* du,
           float* gates, float* dh_part, float* du_part, int B, int T, int H,
           float forget_bias, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long blocks =
      static_cast<long>(H / kUnits) * ((B + kRows - 1) / kRows);
  int budget = blocks > sms ? kBudgetTwo : kBudget;
  const Plan p = make_plan(H, sizeof(DT), budget);
  void* args[] = {&xw,      &lens,  &u,     &b,    &h0,   &c0,
                  &out,     &c_seq, &g_out, &g_ht, &g_ct, &dxw,
                  &dh0,     &dc0,   &du,    &gates, &dh_part,
                  &du_part, &B,     &T,     &H,    &forget_bias, &budget};
  return launch_cooperative(lstm_seq_bwd_kernel<DT>, B, H, p.bytes, args,
                            stream);
}

}  // namespace
}  // namespace paddle_tpu_torch

// The forward's arguments (xw, lens, u, b, h0, c0; see lstm_seq.cu) plus
// out and c_seq [B, T, H] saved by paddle_lstm_seq_train, the cotangents
// g_out [B, T, H] and g_ht/g_ct [B, H]; outputs dxw [B, T, 4H], dh0/dc0
// [B, H] in the I/O dtype and du [H, 4H] f32. Scratch, all f32: gates
// [T, B, 4H] (the gates, then the gate cotangents), dh_part
// [2, H / 4, B, H], and du_part
// [ceil(B / 32), H, 4H] (may be null when B <= 32). Returns the launch's
// cudaError_t, or 720 when the grid does not fit in one wave or a block's
// shared memory exceeds the limit.
extern "C" int paddle_lstm_seq_bwd(
    const void* xw, const int* lens, const void* u, const void* b,
    const void* h0, const void* c0, const void* out, const void* c_seq,
    const void* g_out, const void* g_ht, const void* g_ct, void* dxw,
    void* dh0, void* dc0, float* du, float* gates, float* dh_part,
    float* du_part, int B, int T, int H, float forget_bias, int dtype,
    void* stream) {
  using namespace paddle_tpu_torch;
  if (H % lstm::kUnits != 0 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(xw, lens, u, b, h0, c0, out, c_seq, g_out, g_ht, g_ct,
                         dxw, dh0, dc0, du, gates, dh_part, du_part, B, T, H,
                         forget_bias, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(xw, lens, u, b, h0, c0, out, c_seq, g_out,
                                 g_ht, g_ct, dxw, dh0, dc0, du, gates,
                                 dh_part, du_part, B, T, H, forget_bias, st);
  return (int)cudaErrorInvalidValue;
}
