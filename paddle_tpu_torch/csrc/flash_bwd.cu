// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv.
//
// Replaces the TPU kernels _fa_bwd_dq_kernel (#2) and _fa_bwd_dkv_kernel
// (#3) of paddle_tpu/ops/pallas_kernels.py, both called by _fa_bwd_call.
// From the forward's f32 row logsumexp they recompute each probability
// tile P = exp(scale*Q.K^T - lse) instead of reading it, so no [T, S]
// matrix reaches device memory in either direction:
//   dq:    dS = P * (dO.V^T - delta),  dQ = scale * dS.K
//   dk/dv: dV = P^T.dO,                dK = dS^T.(scale*Q)
// with delta = rowsum(dO * O) per q row, the causal and per-sample kv_lens
// masks of the forward, and exactly zero dk and dv for masked keys.
//
// What bounds them on the H100: per live (q, k) pair the dq kernel runs
// three D-long products (S, dP, dQ: 6*D operations) and the dk/dv kernel
// four (S, dP, dV, dK: 8*D), against O((T + S) * D) elements moved per
// (b, h): at the models' shapes (T, S >= 64, D = 64) both are bound by
// operations. Every body runs its products on the tensor cores: in bf16
// by wgmma (989 TF/s), rounding P and dS to bf16 (below); in f32 by
// mma.sync at f32 accuracy, each product as three TF32 products of the
// operands' big and small parts (tf32x3.cuh: a relative error under
// 5 * 2^-22 a product, against 2^-24 for an f32 FMA and 2^-11 for one
// TF32 pass), so their least time is three times their operations over
// the 495 TF/s TF32 peak.
//
// Design of the f32 bodies. Four warps a block, each warp 16 rows of the
// block's 64-row tile; every operand tile is f32 in shared memory (rows
// padded to 68 floats), filled by 16-byte cp.async copies (zero-filled
// past T or S) in groups that form a two-stage ring. Fragments come by
// ldmatrix where the reduction runs along a row and by scalar loads with
// a permuted reduction index where it runs down the rows, so P and dS
// feed the next product straight from the accumulators (tf32x3.cuh).
//  * dq (#2): one block per (64-row q tile, b*h). Q and dO stay resident;
//    K and V stream in stages of 64 keys up to the forward's bound
//    (_k_block_hi: the causal diagonal, kv_len), and a warp skips a stage
//    wholly past its rows' diagonal. Per stage a warp computes S = Q.K^T
//    and dP = dO.V^T for its 16 rows, P = exp(scale*S - lse) and dS =
//    P o (dP - delta) on the accumulators (masked to exactly 0 on edge
//    stages only), then dQ += dS.K; it writes dQ * scale. With no delta
//    from the caller it computes delta = rowsum(dO * O) in its prologue
//    from global memory and writes it out for the dk/dv kernel, which the
//    wrapper launches after it on the same stream.
//  * dk/dv (#3): one block per (64-key tile, b*h). K and V stay resident;
//    Q, dO and their rows' lse and delta stream in stages of 32 q rows
//    from the causal lower bound (the stage holding the tile's first
//    key's diagonal) to the end. Per stage a warp computes S^T = K.Q^T
//    and dP^T = V.dO^T for its 16 keys, P^T and dS^T (padded q rows
//    masked too: their lse is not real), then dV += P^T.dO and dK +=
//    dS^T.Q. A tile wholly at or past kv_len skips the walk and writes
//    zeros, and masked keys get exactly zero dk and dv.
// Every output element has one owner and no atomics are used, so the
// result is deterministic. The stage sizes were timed at the LM shape:
// 64 keys for dq (two blocks an SM, by shared memory) beat 32 (three),
// 32 q rows for dk/dv (three blocks an SM) beat 64 and 16, and eight
// warps a block lost to four in both.
//
// Design of the bf16 dq body. One warpgroup (128 threads) per (64-row q
// tile, b*h); Q and dO arrive once by TMA, K and V tiles stream through a
// two-stage ring completed on mbarriers (a third stage was measured slower
// on the H100). A thread's two q rows are fixed for the block,
// so their lse and delta sit in registers (delta, when the caller gives
// none, is
// rowsum(dO * O) in f32 over 16-byte global loads, a quad of lanes a row,
// written out for the dk/dv kernel). Per k tile, up to the same bound as
// the f32 body: S = Q.K^T and dP = dO.V^T (wgmma, both operands
// K-major), P = exp(scale*S - lse) and dS = P o (dP - delta) on the
// accumulator fragments, masked to exactly 0 on edge tiles only (the
// causal diagonal, kv_len, rows past T), then dQ += dS.K with dS rounded
// to bf16 in registers as the A operand and K read MN-major, as dk/dv's
// dV += P^T.dO. The stage is refilled once every warp is done with it.
// dQ is scaled once and stored as bf16 pairs; its one stated deviation
// from the plain version is the bf16 rounding of dS.
//
// Design of the bf16 dk/dv body. One warpgroup (128 threads) per
// (64-key tile, b*h); K and V arrive once by TMA. Q and dO tiles
// [64 x 64] stream through a two-stage ring completed on mbarriers, with
// the tile's 64 lse and delta values (a head's rows sit H*4 bytes apart,
// under TMA's 16-byte box minimum, so plain loads, issued before the
// products and stored behind the stage's barrier). Per q tile: S^T = K.Q^T
// and dP^T = V.dO^T (wgmma, A and B K-major from shared memory, keys as
// the rows), P^T = exp(scale*S^T - lse) masked to exactly 0 and dS^T =
// P^T o (dP^T - delta) on the accumulator fragments, then dV += P^T.dO
// and dK += dS^T.Q with P^T and dS^T rounded to bf16 in registers as the
// A operands and dO, Q read MN-major (the transpose bit). dK is scaled
// once at the end. It keeps the f32 body's causal lower bound, its
// early exit for a tile at or past kv_len, exact zeros for masked keys
// and one owner per output element, so the result stays deterministic.
// Its one stated deviation from the plain version is the bf16 rounding
// of P^T and dS^T before the second products.
//
// Head widths. Every body is a template on D, built for D = 64 and
// D = 128 (the wrapper zero-pads any other multiple of 8 up to 128 to the
// next of them). At D = 128 a bf16 tile is two 64-column TMA boxes, the
// D-long products S, dP (and S^T, dP^T) take 8 k steps of 16, and each
// [64 x D] accumulator (dQ; dK and dV) is two m64n64 halves, each its own
// wgmma chain: shared memory is 96 KB for #2 (Q, dO, two K/V stages) and
// for #3 (K, V, two Q/dO stages). The f32 bodies stage fewer rows at
// D = 128 (dq: 32 keys, 135 KB; dk/dv: 16 q rows, 102 KB; rows of 132
// floats) and sum the second products a column tile at a time, each over
// every row of the stage into a fresh 4-register accumulator: the same
// sums as at D = 64, without a second [16 x 128] accumulator a warp (two,
// for dK and dV) live beside the running one.
//
// Causal masks are top-left aligned (key j is live for query i when
// j <= i), as JAX's tril(ones(T, S)): at S != T the k bound of #2 and the
// q lower bound of #3 (the q tiles that end before a k tile's first key)
// hold as they are.
//
// q, k and v are read in place through their strides (views of the fused
// qkv projection; innermost stride 1, a 16-byte aligned base and strides
// of 16-byte multiples: TMA in bf16, cp.async in f32). o, dO, lse, delta
// and the outputs are contiguous: the wrapper makes o and dO contiguous,
// which copies nothing for autograd's cotangent of the forward's
// contiguous output.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace paddle_tpu_torch {
namespace {

constexpr int kB = 64;        // q rows per q tile and keys per k tile

// ---------------------------------------------------------------------------
// bf16 dk/dv (#3): products on the tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup: 64 keys
constexpr int kStages = 2;        // Q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvSmem {                  // every tile 1024-byte aligned
  __nv_bfloat16 k[64 * D];
  __nv_bfloat16 v[64 * D];
  __nv_bfloat16 q[kStages][64 * D];
  __nv_bfloat16 dout[kStages][64 * D];
  float lse[kStages][64];         // log2(e) * lse of the tile's q rows
  float delta[kStages][64];
  uint64_t kv_bar;
  uint64_t full[kStages];
};

// the 64-column half c of a [64 x D] bf16 tile
__device__ __forceinline__ const void* half_of(const __nv_bfloat16* tile,
                                               int c) {
  return reinterpret_cast<const uint8_t*>(tile) + c * sm90::kTileBytes;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ kv_lens,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int T_len, int S,
                           int H, float scale, int causal) {
  using namespace sm90;
  constexpr int kH = D / 64;                     // 64-column halves
  constexpr uint32_t kTile = kH * kTileBytes;    // one [64 x D] tile
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kB;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const int64_t lrow = static_cast<int64_t>(b) * T_len * H + h;  // lse/delta
  const float scale_log2 = scale * kLog2e;
  const int row0 = acc_row(tid, 0);   // this thread's keys k0 + row0 (+8)

  float dk_acc[kH][32], dv_acc[kH][32];   // by 64-column halves
#pragma unroll
  for (int c = 0; c < kH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  if (k0 < kv_len) {  // else every key of the tile is masked: zeros
    // causal: q tiles that end before this tile's first key see none of
    // its keys (the TPU kernel's lo)
    const int lo = causal ? k0 / kB : 0;
    const int n = (T_len + kB - 1) / kB - lo;
    // this thread's share of a tile's lse (threads 0-63) or delta (64-127)
    const float* rows = tid < 64 ? lse : delta;
    const float mul = tid < 64 ? kLog2e : 1.f;
    float* dst = (tid < 64 ? sm.lse[0] : sm.delta[0]) + (tid & 63);

    if (tid == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&domap);
      mbar_init(&sm.kv_bar, 1);
      for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(&sm.kv_bar, 2 * kTile);
      tma_load_tile<kH>(sm.k, &kmap, &sm.kv_bar, h, k0, b);
      tma_load_tile<kH>(sm.v, &vmap, &sm.kv_bar, h, k0, b);
      for (int s = 0; s < kStages && s < n; ++s) {
        mbar_expect_tx(&sm.full[s], 2 * kTile);
        tma_load_tile<kH>(sm.q[s], &qmap, &sm.full[s], h, (lo + s) * kB, b);
        tma_load_tile<kH>(sm.dout[s], &domap, &sm.full[s], h, (lo + s) * kB,
                          b);
      }
    }
    for (int s = 0; s < kStages && s < n; ++s) {
      const int t = (lo + s) * kB + (tid & 63);
      dst[s * kB] = t < T_len
                        ? rows[lrow + static_cast<int64_t>(t) * H] * mul
                        : 0.f;
    }
    __syncthreads();
    mbar_wait(&sm.kv_bar, 0);

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    for (int it = 0; it < n; ++it) {
      const int st = it % kStages;
      const int q0 = (lo + it) * kB;
      // the lse/delta of the tile this stage takes next, loaded early so
      // that its latency hides under the products
      const bool refill = it + kStages < n;
      float next = 0.f;
      if (refill) {
        const int t = q0 + kStages * kB + (tid & 63);
        if (t < T_len) next = rows[lrow + static_cast<int64_t>(t) * H] * mul;
      }
      mbar_wait(&sm.full[st], (it / kStages) & 1);

      // S^T = K . Q^T and dP^T = V . dO^T: keys are the rows
      wgmma_fence();
      gemm_abt<kH>(sc, sm.k, sm.q[st]);
      gemm_abt<kH>(dp, sm.v, sm.dout[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // P^T = exp(scale*S^T - lse), masked to exactly 0; dS^T = P^T o
      // (dP^T - delta). Padded q rows (t >= T) are masked too: their lse
      // is not real.
      const bool edge = q0 + kB > T_len || k0 + kB > kv_len ||
                        (causal && k0 + kB - 1 > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = acc_col(tid, i);
        bool ok = true;
        if (edge) {
          const int kp = k0 + row0 + 8 * ((i >> 1) & 1);
          const int qp = q0 + col;
          ok = kp < kv_len && qp < T_len && (!causal || qp >= kp);
        }
        const float p = ok ? exp2f(sc[i] * scale_log2 - sm.lse[st][col])
                           : 0.f;
        sc[i] = p;
        dp[i] = p * (dp[i] - sm.delta[st][col]);
      }

      // dV += P^T . dO and dK += dS^T . Q: P^T and dS^T rounded to bf16 in
      // registers as the A operands, dO and Q [q][d] read MN-major, one
      // wgmma chain a 64-column half
      uint32_t pf[16], df[16];
      acc_to_frag(sc, pf);
      acc_to_frag(dp, df);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kH; ++c) {
        gemm_pb(dv_acc[c], pf, half_of(sm.dout[st], c));
        gemm_pb(dk_acc[c], df, half_of(sm.q[st], c));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kH; ++c) {
        fence_acc(dv_acc[c]);
        fence_acc(dk_acc[c]);
      }

      // every warp is done with stage st: refill it with tile it + kStages
      __syncthreads();
      if (refill) {
        dst[st * kB] = next;
        if (tid == 0) {
          const int qn = q0 + kStages * kB;
          mbar_expect_tx(&sm.full[st], 2 * kTile);
          tma_load_tile<kH>(sm.q[st], &qmap, &sm.full[st], h, qn, b);
          tma_load_tile<kH>(sm.dout[st], &domap, &sm.full[st], h, qn, b);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = k0 + row0 + 8 * r;
    if (s >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        const int col = 64 * c + acc_col(tid, i);
        *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
            __floats2bfloat162_rn(dk_acc[c][i] * scale,
                                  dk_acc[c][i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
            __floats2bfloat162_rn(dv_acc[c][i], dv_acc[c][i + 1]);
      }
  }
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* kv_lens, void* dk, void* dv, int B, int T_len,
                    int S, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, float scale, int causal,
                    cudaStream_t stream) {
  const int64_t row_st = static_cast<int64_t>(H) * D;   // dout contiguous
  CUtensorMap qm, km, vm, dom;
  if (!sm90::make_tile_map(&qm, q, B, T_len, H, D, q_sb, q_st, q_sh) ||
      !sm90::make_tile_map(&km, k, B, S, H, D, k_sb, k_ss, k_sh) ||
      !sm90::make_tile_map(&vm, v, B, S, H, D, v_sb, v_ss, v_sh) ||
      !sm90::make_tile_map(&dom, dout, B, T_len, H, D, T_len * row_st,
                           row_st, D))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(DkvSmem<D>) + 1024;   // + align1024
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kB - 1) / kB, B * H);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, dom, lse, delta, kv_lens, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T_len, S, H, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dq (#2): products on the tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kDqStages = 2;      // the K/V ring's depth

template <int D>
struct DqSmem {                   // every tile 1024-byte aligned
  __nv_bfloat16 q[64 * D];
  __nv_bfloat16 dout[64 * D];
  __nv_bfloat16 k[kDqStages][64 * D];
  __nv_bfloat16 v[kDqStages][64 * D];
  uint64_t qdo_bar;
  uint64_t full[kDqStages];
};

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta,
                          const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ dq, int T_len, int S,
                          int H, float scale, int causal,
                          int compute_delta) {
  using namespace sm90;
  constexpr int kH = D / 64;                     // 64-column halves
  constexpr uint32_t kTile = kH * kTileBytes;    // one [64 x D] tile
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kB;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const float scale_log2 = scale * kLog2e;
  const int row0 = acc_row(tid, 0);   // this thread's q rows q0 + row0 (+8)
  // o, dO and dq are contiguous [B, T, H, D]; lse and delta [B, T, H]
  const int64_t row_st = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * T_len * H + h) * D;

  // the forward's k-tile bound: tiles wholly past the causal diagonal or
  // past kv_len have P == 0 exactly and add nothing to dq
  int hi = (S + kB - 1) / kB;
  if (causal) hi = min(hi, (q0 + kB + kB - 1) / kB);
  hi = min(hi, (kv_len + kB - 1) / kB);

  if (tid == 0) {
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    mbar_init(&sm.qdo_bar, 1);
    for (int s = 0; s < kDqStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && hi > 0) {
    mbar_expect_tx(&sm.qdo_bar, 2 * kTile);
    tma_load_tile<kH>(sm.q, &qmap, &sm.qdo_bar, h, q0, b);
    tma_load_tile<kH>(sm.dout, &domap, &sm.qdo_bar, h, q0, b);
    for (int s = 0; s < kDqStages && s < hi; ++s) {
      mbar_expect_tx(&sm.full[s], 2 * kTile);
      tma_load_tile<kH>(sm.k[s], &kmap, &sm.full[s], h, s * kB, b);
      tma_load_tile<kH>(sm.v[s], &vmap, &sm.full[s], h, s * kB, b);
    }
  }

  // lse (in log2 units) and delta of this thread's two rows, while the
  // tiles load; a row past T gets 0 for both (its dq is never written).
  // delta = rowsum(dO * O) comes from global memory, not from the
  // swizzled dO tile: the row's quad of lanes reads D / 4 elements each.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + 8 * r;
    const bool in = t < T_len;
    const int64_t ri = (static_cast<int64_t>(b) * T_len + t) * H + h;
    lse2[r] = in ? lse[ri] * kLog2e : 0.f;
    if (compute_delta) {
      float part = 0.f;
      if (in) {
        const int64_t at = base + t * row_st + (D / 4) * (tid & 3);
        const uint4* op = reinterpret_cast<const uint4*>(o + at);
        const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int u = 0; u < D / 32; ++u) {
          const uint4 ov = op[u], dv = dp[u];
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            part = fmaf(df.x, of.x, part);
            part = fmaf(df.y, of.y, part);
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dl[r] = part;
      if ((tid & 3) == 0 && in) delta[ri] = part;
    } else {
      dl[r] = in ? delta[ri] : 0.f;
    }
  }

  float acc[kH][32];                  // dQ by 64-column halves
#pragma unroll
  for (int c = 0; c < kH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  if (hi > 0) {
    mbar_wait(&sm.qdo_bar, 0);
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    for (int kt = 0; kt < hi; ++kt) {
      const int st = kt % kDqStages;
      const int k0 = kt * kB;
      mbar_wait(&sm.full[st], (kt / kDqStages) & 1);

      // S = Q . K^T and dP = dO . V^T: q rows are the rows
      wgmma_fence();
      gemm_abt<kH>(sc, sm.q, sm.k[st]);
      gemm_abt<kH>(dp, sm.dout, sm.v[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // P = exp(scale*S - lse), masked to exactly 0 on edge tiles; dS =
      // P o (dP - delta)
      const bool edge = q0 + kB > T_len || k0 + kB > kv_len ||
                        (causal && k0 + kB - 1 > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        bool ok = true;
        if (edge) {
          const int qp = q0 + row0 + 8 * r;
          const int kp = k0 + acc_col(tid, i);
          ok = kp < kv_len && qp < T_len && (!causal || qp >= kp);
        }
        const float p = ok ? exp2f(sc[i] * scale_log2 - lse2[r]) : 0.f;
        dp[i] = p * (dp[i] - dl[r]);
      }

      // dQ += dS . K: dS rounded to bf16 in registers as the A operand,
      // K [keys][d] read MN-major, one wgmma chain a 64-column half
      uint32_t df[16];
      acc_to_frag(dp, df);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kH; ++c) gemm_pb(acc[c], df, half_of(sm.k[st], c));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kH; ++c) fence_acc(acc[c]);

      // every warp is done with stage st: refill it with tile kt + kDqStages
      __syncthreads();
      if (tid == 0 && kt + kDqStages < hi) {
        const int kn = k0 + kDqStages * kB;
        mbar_expect_tx(&sm.full[st], 2 * kTile);
        tma_load_tile<kH>(sm.k[st], &kmap, &sm.full[st], h, kn, b);
        tma_load_tile<kH>(sm.v[st], &vmap, &sm.full[st], h, kn, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + 8 * r;
    if (t >= T_len) continue;
    __nv_bfloat16* row = dq + base + t * row_st;
#pragma unroll
    for (int c = 0; c < kH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * c + acc_col(tid, i)) =
            __floats2bfloat162_rn(acc[c][i] * scale, acc[c][i + 1] * scale);
      }
  }
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, const int* kv_lens, void* dq, int B,
                   int T_len, int S, int H, int64_t q_sb, int64_t q_st,
                   int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                   int causal, int compute_delta, cudaStream_t stream) {
  const int64_t row_st = static_cast<int64_t>(H) * D;   // dout contiguous
  CUtensorMap qm, km, vm, dom;
  if (!sm90::make_tile_map(&qm, q, B, T_len, H, D, q_sb, q_st, q_sh) ||
      !sm90::make_tile_map(&km, k, B, S, H, D, k_sb, k_ss, k_sh) ||
      !sm90::make_tile_map(&vm, v, B, S, H, D, v_sb, v_ss, v_sh) ||
      !sm90::make_tile_map(&dom, dout, B, T_len, H, D, T_len * row_st,
                           row_st, D))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(DqSmem<D>) + 1024;   // + align1024
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kB - 1) / kB, B * H);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, dom, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, kv_lens,
      static_cast<__nv_bfloat16*>(dq), T_len, S, H, scale, causal,
      compute_delta);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 dq (#2) and dk/dv (#3): three-pass TF32 products on the tensor cores
// (mma.sync m16n8k8, tf32x3.cuh), tiles fed by cp.async
// ---------------------------------------------------------------------------

// dq: four warps of 16 q rows each; 64 keys a K/V stage at D = 64, 32 at
// D = 128
constexpr int kDqWarps = 4;
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kDqTile = 16 * kDqWarps;       // q rows a block

template <int D>
struct DqF32 {
  static constexpr int kLd = tf32x3::ld_for(D);     // row pitch, floats
  static constexpr int kRows = D == 64 ? 64 : 32;   // keys a K/V stage
  static constexpr int kTiles = kRows / 8;          // n-tiles of S, dP
  static constexpr int kCols = D / 8;               // n-tiles of dQ
  struct Smem {
    float q[kDqTile * kLd];
    float dout[kDqTile * kLd];
    float k[2][kRows * kLd];
    float v[2][kRows * kLd];
  };
};

template <int D>
__global__ void __launch_bounds__(kDqThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta,
                         const int* __restrict__ kv_lens,
                         float* __restrict__ dq, int T_len, int S, int H,
                         int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         float scale, int causal, int compute_delta) {
  using namespace tf32x3;
  using P = DqF32<D>;
  constexpr int kLd = P::kLd, kDqRows = P::kRows, kDqTiles = P::kTiles;
  constexpr int kCols = P::kCols;
  extern __shared__ float4 smem_f4[];
  typename P::Smem& sm = *reinterpret_cast<typename P::Smem*>(smem_f4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kDqTile;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb_ = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  // o, dO and dq are contiguous [B, T, H, D]; lse and delta [B, T, H]
  const int64_t row_st = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * T_len * H + h) * D;
  const int r0 = 16 * warp;            // the warp's rows of the tile
  const int qa = q0 + r0 + (lane >> 2);  // this thread's rows qa, qa + 8

  // the forward's k bound, in keys: past the causal diagonal or past
  // kv_len P == 0 exactly and adds nothing to dq
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + kDqTile);
  const int n_kt = (k_end + kDqRows - 1) / kDqRows;

  // groups: Q and dO, then the first two K/V stages
  if (n_kt > 0) {
    load_tile_async<kDqTile, kDqThreads, D>(sm.q, qb, q_st, q0, T_len, tid);
    load_tile_async<kDqTile, kDqThreads, D>(sm.dout, dout + base, row_st, q0,
                                            T_len, tid);
    cp_async_commit();
    for (int s = 0; s < 2; ++s) {
      if (s < n_kt) {
        load_tile_async<kDqRows, kDqThreads, D>(sm.k[s], kb_, k_ss,
                                                s * kDqRows, S, tid);
        load_tile_async<kDqRows, kDqThreads, D>(sm.v[s], vb, v_ss,
                                                s * kDqRows, S, tid);
      }
      cp_async_commit();
    }
  }

  // lse and delta of this thread's two rows, while the tiles load; a row
  // past T gets 0 for both (its dq is never written). delta = rowsum(dO *
  // O) from global memory, the row's quad of lanes D / 4 elements each.
  float lse_r[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qa + 8 * i;
    const bool in = tq < T_len;
    const int64_t ri = (static_cast<int64_t>(b) * T_len + tq) * H + h;
    lse_r[i] = in ? lse[ri] : 0.f;
    if (compute_delta) {
      float part = 0.f;
      if (in) {
        const int64_t at = base + tq * row_st + (D / 4) * t4;
        const float4* op = reinterpret_cast<const float4*>(o + at);
        const float4* dp = reinterpret_cast<const float4*>(dout + at);
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          const float4 ov = op[u], dv = dp[u];
          part = fmaf(dv.x, ov.x, part);
          part = fmaf(dv.y, ov.y, part);
          part = fmaf(dv.z, ov.z, part);
          part = fmaf(dv.w, ov.w, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dl[i] = part;
      if (t4 == 0 && in) delta[ri] = part;
    } else {
      dl[i] = in ? delta[ri] : 0.f;
    }
  }

  float acc[kCols][4];                 // dQ: the warp's 16 rows x D
#pragma unroll
  for (int n = 0; n < kCols; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const int k0 = kt * kDqRows;
    cp_async_wait<1>();                // this thread's copies of stage kt
    __syncthreads();                   // everyone's
    // the warp's rows see none of the stage's keys past the diagonal
    if (!causal || k0 <= q0 + r0 + 15) {
      // S = Q . K^T and dP = dO . V^T: [16 rows x kDqRows keys]
      float sc[kDqTiles][4], dp[kDqTiles][4];
#pragma unroll
      for (int j = 0; j < kDqTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        FragA fq, fdo;
        load_a(fq, sm.q, r0, 8 * ks, lane, kLd);
        load_a(fdo, sm.dout, r0, 8 * ks, lane, kLd);
#pragma unroll
        for (int np = 0; np < kDqTiles / 2; ++np) {
          FragB fk0, fk1, fv0, fv1;
          load_b_nk2(fk0, fk1, sm.k[st], 16 * np, 8 * ks, lane, kLd);
          load_b_nk2(fv0, fv1, sm.v[st], 16 * np, 8 * ks, lane, kLd);
          mma3(sc[2 * np], fq, fk0);
          mma3(sc[2 * np + 1], fq, fk1);
          mma3(dp[2 * np], fdo, fv0);
          mma3(dp[2 * np + 1], fdo, fv1);
        }
      }

      // P = exp(scale*S - lse), masked to exactly 0 on edge stages
      // (kv_len, the causal diagonal); dS = P o (dP - delta)
      const bool edge = k0 + kDqRows > kv_len ||
                        (causal && k0 + kDqRows - 1 > q0 + r0);
#pragma unroll
      for (int j = 0; j < kDqTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          bool ok = true;
          if (edge) {
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            ok = kp < kv_len && (!causal || qa + 8 * i >= kp);
          }
          const float p =
              ok ? exp2_approx(fmaf(sc[j][e], scale, -lse_r[i]) * kLog2e)
                 : 0.f;
          dp[j][e] = p * (dp[j][e] - dl[i]);
        }

      // dQ += dS . K over the stage's keys: dS from the accumulators,
      // K [keys][d] read down its rows
      // (the stage's sum in a fresh accumulator, added to dQ in f32:
      // tf32x3.cuh, "Accumulation")
      if constexpr (D == 64) {
        float q_st[kCols][4];
#pragma unroll
        for (int n = 0; n < kCols; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) q_st[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < kDqTiles; ++j) {
          FragA fds;
          acc_to_a(fds, dp[j]);
#pragma unroll
          for (int n = 0; n < kCols; ++n) {
            FragB fk;
            load_b_kn(fk, sm.k[st], 8 * j, 8 * n, lane, kLd);
            mma3(q_st[n], fds, fk);
          }
        }
#pragma unroll
        for (int n = 0; n < kCols; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += q_st[n][e];
      } else {
        // a column tile at a time (flash_fwd.cu: the same sums)
        FragA fds[kDqTiles];
#pragma unroll
        for (int j = 0; j < kDqTiles; ++j) acc_to_a(fds[j], dp[j]);
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          float q_st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kDqTiles; ++j) {
            FragB fk;
            load_b_kn(fk, sm.k[st], 8 * j, 8 * n, lane, kLd);
            mma3(q_st, fds[j], fk);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += q_st[e];
        }
      }
    }
    __syncthreads();                   // every warp is done with stage st
    if (kt + 2 < n_kt) {
      const int kn = k0 + 2 * kDqRows;
      load_tile_async<kDqRows, kDqThreads, D>(sm.k[st], kb_, k_ss, kn, S,
                                              tid);
      load_tile_async<kDqRows, kDqThreads, D>(sm.v[st], vb, v_ss, kn, S,
                                              tid);
    }
    cp_async_commit();                 // (empty past the end: the count stays)
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qa + 8 * i;
    if (tq >= T_len) continue;
    float* row = dq + base + tq * row_st + 2 * t4;
#pragma unroll
    for (int n = 0; n < kCols; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// dk/dv: four warps of 16 keys each; 32 q rows a Q/dO stage at D = 64, 16
// at D = 128
constexpr int kDkvWarps = 4;
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr int kDkvTile = 16 * kDkvWarps;     // keys a block

template <int D>
struct DkvF32 {
  static constexpr int kLd = tf32x3::ld_for(D);     // row pitch, floats
  static constexpr int kRows = D == 64 ? 32 : 16;   // q rows a stage
  static constexpr int kTiles = kRows / 8;          // n-tiles of S^T, dP^T
  static constexpr int kCols = D / 8;               // n-tiles of dK, dV
  struct Smem {
    float k[kDkvTile * kLd];
    float v[kDkvTile * kLd];
    float q[2][kRows * kLd];
    float dout[2][kRows * kLd];
    float lse[2][kRows];
    float delta[2][kRows];
  };
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ kv_lens,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int T_len, int S, int H,
                          int64_t q_sb, int64_t q_st, int64_t q_sh,
                          int64_t k_sb, int64_t k_ss, int64_t k_sh,
                          int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          float scale, int causal) {
  using namespace tf32x3;
  using P = DkvF32<D>;
  constexpr int kLd = P::kLd, kDkvRows = P::kRows, kDkvTiles = P::kTiles;
  constexpr int kCols = P::kCols;
  extern __shared__ float4 smem_f4[];
  typename P::Smem& sm = *reinterpret_cast<typename P::Smem*>(smem_f4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kDkvTile;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb_ = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int64_t row_st = static_cast<int64_t>(H) * D;
  const float* dob = dout + (static_cast<int64_t>(b) * T_len * H + h) * D;
  const int64_t lrow = static_cast<int64_t>(b) * T_len * H + h;  // lse/delta
  const int r0 = 16 * warp;              // the warp's keys of the tile
  const int ka = k0 + r0 + (lane >> 2);  // this thread's keys ka, ka + 8

  float dk_acc[kCols][4], dv_acc[kCols][4];   // the warp's 16 keys x D
#pragma unroll
  for (int n = 0; n < kCols; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (k0 < kv_len) {  // else every key of the tile is masked: zeros
    // causal: q chunks that end before this tile's first key see none of
    // its keys (the TPU kernel's lo)
    const int lo = causal ? k0 / kDkvRows : 0;
    const int n = (T_len + kDkvRows - 1) / kDkvRows - lo;
    // one stage: the chunk's Q and dO rows, and its lse and delta
    auto load_stage = [&](int s, int chunk) {
      const int qn = chunk * kDkvRows;
      load_tile_async<kDkvRows, kDkvThreads, D>(sm.q[s], qb, q_st, qn, T_len,
                                                tid);
      load_tile_async<kDkvRows, kDkvThreads, D>(sm.dout[s], dob, row_st, qn,
                                                T_len, tid);
      if (tid < 2 * kDkvRows) {
        const int r = tid % kDkvRows;
        const bool in = qn + r < T_len;
        const float* src = (tid < kDkvRows ? lse : delta) + lrow +
                           (in ? static_cast<int64_t>(qn + r) * H : 0);
        cp_async4((tid < kDkvRows ? sm.lse[s] : sm.delta[s]) + r, src, in);
      }
    };
    load_tile_async<kDkvTile, kDkvThreads, D>(sm.k, kb_, k_ss, k0, S, tid);
    load_tile_async<kDkvTile, kDkvThreads, D>(sm.v, vb, v_ss, k0, S, tid);
    cp_async_commit();
    for (int s = 0; s < 2; ++s) {
      if (s < n) load_stage(s, lo + s);
      cp_async_commit();
    }

    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      const int q0 = (lo + it) * kDkvRows;
      cp_async_wait<1>();              // this thread's copies of chunk it
      __syncthreads();                 // everyone's
      // the warp's keys: none live (past kv_len), or (causal) all past
      // the chunk's last query
      if (k0 + r0 < kv_len && (!causal || q0 + kDkvRows - 1 >= k0 + r0)) {
        // S^T = K . Q^T and dP^T = V . dO^T: [16 keys x kDkvRows queries]
        float sc[kDkvTiles][4], dp[kDkvTiles][4];
#pragma unroll
        for (int j = 0; j < kDkvTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          FragA fk, fv;
          load_a(fk, sm.k, r0, 8 * ks, lane, kLd);
          load_a(fv, sm.v, r0, 8 * ks, lane, kLd);
#pragma unroll
          for (int np = 0; np < kDkvTiles / 2; ++np) {
            FragB fq0, fq1, fo0, fo1;
            load_b_nk2(fq0, fq1, sm.q[st], 16 * np, 8 * ks, lane, kLd);
            load_b_nk2(fo0, fo1, sm.dout[st], 16 * np, 8 * ks, lane, kLd);
            mma3(sc[2 * np], fk, fq0);
            mma3(sc[2 * np + 1], fk, fq1);
            mma3(dp[2 * np], fv, fo0);
            mma3(dp[2 * np + 1], fv, fo1);
          }
        }

        // P^T = exp(scale*S^T - lse), masked to exactly 0 on edge chunks;
        // dS^T = P^T o (dP^T - delta). Padded q rows (t >= T) are masked
        // too: their lse is not real.
        const bool edge = k0 + r0 + 16 > kv_len || q0 + kDkvRows > T_len ||
                          (causal && k0 + r0 + 15 > q0);
#pragma unroll
        for (int j = 0; j < kDkvTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t4 + (e & 1);   // query in chunk
            bool ok = true;
            if (edge) {
              const int kp = ka + 8 * (e >> 1), qp = q0 + col;
              ok = kp < kv_len && qp < T_len && (!causal || qp >= kp);
            }
            const float p = ok ? exp2_approx(fmaf(sc[j][e], scale,
                                                  -sm.lse[st][col]) * kLog2e)
                               : 0.f;
            sc[j][e] = p;
            dp[j][e] = p * (dp[j][e] - sm.delta[st][col]);
          }

        // dV += P^T . dO and dK += dS^T . Q over the chunk's queries:
        // P^T, dS^T from the accumulators, dO and Q read down their rows
        // (the chunk's sums in fresh accumulators, added to dV and dK in
        // f32: tf32x3.cuh, "Accumulation")
        if constexpr (D == 64) {
          float v_st[kCols][4], k_st[kCols][4];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) v_st[c][e] = k_st[c][e] = 0.f;
#pragma unroll
          for (int j = 0; j < kDkvTiles; ++j) {
            FragA fp, fds;
            acc_to_a(fp, sc[j]);
            acc_to_a(fds, dp[j]);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              FragB fo, fq;
              load_b_kn(fo, sm.dout[st], 8 * j, 8 * c, lane, kLd);
              load_b_kn(fq, sm.q[st], 8 * j, 8 * c, lane, kLd);
              mma3(v_st[c], fp, fo);
              mma3(k_st[c], fds, fq);
            }
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[c][e] += v_st[c][e];
              dk_acc[c][e] += k_st[c][e];
            }
        } else {
          // a column tile at a time (flash_fwd.cu: the same sums; here it
          // keeps two [16 x 128] fresh accumulators out of the registers)
          FragA fp[kDkvTiles], fds[kDkvTiles];
#pragma unroll
          for (int j = 0; j < kDkvTiles; ++j) {
            acc_to_a(fp[j], sc[j]);
            acc_to_a(fds[j], dp[j]);
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float v_st[4] = {0.f, 0.f, 0.f, 0.f};
            float k_st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j = 0; j < kDkvTiles; ++j) {
              FragB fo, fq;
              load_b_kn(fo, sm.dout[st], 8 * j, 8 * c, lane, kLd);
              load_b_kn(fq, sm.q[st], 8 * j, 8 * c, lane, kLd);
              mma3(v_st, fp[j], fo);
              mma3(k_st, fds[j], fq);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[c][e] += v_st[e];
              dk_acc[c][e] += k_st[e];
            }
          }
        }
      }
      __syncthreads();                 // every warp is done with stage st
      if (it + 2 < n) load_stage(st, lo + it + 2);
      cp_async_commit();               // (empty past the end: the count stays)
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = ka + 8 * i;
    if (s >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * H + h) * D
                        + 2 * t4;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      *reinterpret_cast<float2*>(dk + row + 8 * c) = make_float2(
          dk_acc[c][2 * i] * scale, dk_acc[c][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv + row + 8 * c) =
          make_float2(dv_acc[c][2 * i], dv_acc[c][2 * i + 1]);
    }
  }
}

template <int D>
int launch_dq_tf32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, const int* kv_lens, void* dq, int B,
                   int T_len, int S, int H, int64_t q_sb, int64_t q_st,
                   int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                   int causal, int compute_delta, cudaStream_t stream) {
  constexpr size_t smem = sizeof(typename DqF32<D>::Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kDqTile - 1) / kDqTile, B * H);
  flash_bwd_dq_tf32_kernel<D><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, delta, kv_lens,
      static_cast<float*>(dq), T_len, S, H, q_sb, q_st, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, scale, causal, compute_delta);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* kv_lens, void* dk, void* dv, int B, int T_len,
                    int S, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, float scale, int causal,
                    cudaStream_t stream) {
  constexpr size_t smem = sizeof(typename DkvF32<D>::Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kDkvTile - 1) / kDkvTile, B * H);
  flash_bwd_dkv_tf32_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, kv_lens, static_cast<float*>(dk), static_cast<float*>(dv), T_len,
      S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
      causal);
  return (int)cudaGetLastError();
}

// the two launches at head width D, by dtype
template <int D>
int dq_at(const void* q, const void* k, const void* v, const void* o,
          const void* dout, const float* lse, float* delta,
          const int* kv_lens, void* dq, int B, int T, int S, int H,
          int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
          int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
          int64_t v_sh, float scale, int causal, int compute_delta,
          int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return launch_dq_tf32<D>(q, k, v, o, dout, lse, delta, kv_lens, dq, B, T,
                             S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb,
                             v_ss, v_sh, scale, causal, compute_delta, st);
  if (dtype == kBF16)
    return launch_dq_bf16<D>(q, k, v, o, dout, lse, delta, kv_lens, dq, B, T,
                             S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb,
                             v_ss, v_sh, scale, causal, compute_delta, st);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int dkv_at(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kv_lens,
           void* dk, void* dv, int B, int T, int S, int H, int64_t q_sb,
           int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss,
           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
           float scale, int causal, int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return launch_dkv_tf32<D>(q, k, v, dout, lse, delta, kv_lens, dk, dv, B,
                              T, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                              v_sb, v_ss, v_sh, scale, causal, st);
  if (dtype == kBF16)
    return launch_dkv_bf16<D>(q, k, v, dout, lse, delta, kv_lens, dk, dv, B,
                              T, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                              v_sb, v_ss, v_sh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_tpu_torch

// q [B, T, H, D] and k/v [B, S, H, D] (D = 64 or 128) with element
// strides (innermost stride 1); o, dout and dq contiguous [B, T, H, D] in
// q's dtype; lse and delta contiguous [B, T, H] f32 (delta is written when
// compute_delta is 1, read otherwise); kv_lens [B] int32 in [1, S] or
// null. Returns the launch's cudaError_t (0 on success).
extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, const int* kv_lens,
    void* dq, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int compute_delta, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dq_at<64>(q, k, v, o, dout, lse, delta, kv_lens, dq, B, T, S, H,
                     q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                     scale, causal, compute_delta, dtype, st);
  if (D == 128)
    return dq_at<128>(q, k, v, o, dout, lse, delta, kv_lens, dq, B, T, S, H,
                      q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                      scale, causal, compute_delta, dtype, st);
  return (int)cudaErrorInvalidValue;
}

// The same q, k, v, dout, lse, delta (read) and kv_lens; dk and dv
// contiguous [B, S, H, D] in k's dtype. Launch after
// paddle_flash_attention_bwd_dq on the same stream when that one computes
// delta. Returns the launch's cudaError_t (0 on success).
extern "C" int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* kv_lens, void* dk,
    void* dv, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dkv_at<64>(q, k, v, dout, lse, delta, kv_lens, dk, dv, B, T, S, H,
                      q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                      scale, causal, dtype, st);
  if (D == 128)
    return dkv_at<128>(q, k, v, dout, lse, delta, kv_lens, dk, dv, B, T, S,
                       H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                       v_sh, scale, causal, dtype, st);
  return (int)cudaErrorInvalidValue;
}
