// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel _fa_fwd_kernel (paddle_tpu/ops/pallas_kernels.py,
// called by _fa_fwd_call): blockwise online-softmax attention with causal
// and per-sample kv_lens masks, o in q's dtype and lse [B, T, H] in f32.
//
// What bounds it on the H100: at the models' shapes (T, S >= 64, d_head
// 64) attention does ~4*T*S*D operations per (b, h) against 4*T*D
// elements moved, so it is bound by operations. Both bodies run their
// products on the tensor cores; two bodies, chosen by dtype at the entry
// point:
//
// f32: three-pass TF32 mma.sync (m16n8k8), each product three TF32
// products of the operands' big and small parts (tf32x3.cuh: a relative
// error under 5 * 2^-22 a product, against 2^-24 for an f32 FMA and
// 2^-11 for one TF32 pass, which the f32 tolerance does not allow), so
// its least time is three times its operations over the 495 TF/s TF32
// peak. Four warps a block, each 16 rows of the block's 64-row q tile
// (the f32 dq body's layout, flash_bwd.cu). The Q tile arrives once and
// K/V tiles of 64 keys stream through a two-stage ring, all by 16-byte
// cp.async into 68-float rows (zero-filled past T or S), so tile kt+1
// loads during tile kt's products. S = Q.K^T takes both operands by
// ldmatrix (the reduction over d runs along Q's and K's rows); the masks
// and the online softmax run on the accumulator fragments, where a row
// lies in a quad of 4 lanes (2 shuffles for its max; the sum is reduced
// once at the end), p = exp2((scale*s - m) * log2(e)); P feeds O +=
// P.V straight from the accumulators as the A operand (the reduction
// index permuted, no shared-memory round trip) against V [key][d] read
// down its rows. A warp skips a stage wholly past its rows' diagonal.
//
// bf16: both products on the tensor cores. One warpgroup (128
// threads) per (64-row q tile, b*h): 64 rows is wgmma's M, and the NMT's
// T = 64 fills one tile exactly. The Q tile arrives once by TMA; K and V
// tiles [64 keys x 64] stream through a two-stage ring in shared memory,
// each stage completed on an mbarrier, so tile kt+1 loads during tile
// kt's products (and several blocks share an SM). S = Q.K^T is four
// m64n64k16 wgmmas with Q and K from shared memory (K-major, the 128-byte
// swizzle TMA writes); the masks and the online softmax run on the f32
// accumulator fragments, where a row lies in a quad of 4 lanes (2
// shuffles for its max; the sum is reduced once at the end). P is
// rounded to bf16 in registers and fed as the A operand of O += P.V, with
// V [key][d] read MN-major through the descriptor's transpose bit: no
// transpose in shared memory. The one stated deviation from the plain
// version: P is rounded to bf16 before that product (l sums the f32 P).
//
// Head widths. Both bodies are templates on D and are built for D = 64
// and D = 128; D = 256 runs the bodies of flash_wide.cu (the wrapper
// zero-pads any other width up to 256 to the next of the three). At D = 128 the bf16 tiles are two 64-column TMA
// boxes each, Q.K^T takes 8 k steps of 16, and O is two m64n64
// accumulators (one a 64-column half, 64 f32 registers a thread in all),
// each P.V half its own wgmma; shared memory is Q plus two K/V stages,
// 80 KB. The f32 body at D = 128 stages 32 keys (Q plus two stages,
// 101 KB, in rows of 132 floats) and sums P.V a column tile at a time
// (every key of the stage into a fresh 4-register accumulator, then into
// O), which keeps the same sums with no second [16 x 128] accumulator.
//
// Causal masks are top-left aligned (key j is live for query i when
// j <= i), as JAX's tril(ones(T, S)) and the TPU kernel's q_pos >= k_pos:
// at S != T the k bounds and the diagonal tests below hold as they are.
//
// In both bodies K tiles past the causal diagonal or past kv_len are
// never loaded (_k_block_hi), and q, k and v are read in place through
// their strides (no head transpose in device memory); the innermost
// stride must be 1, the base 16-byte aligned and the strides multiples
// of 16 bytes (TMA in bf16, cp.async in f32; the wrapper checks).
#include "common.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace paddle_tpu_torch {
namespace {

constexpr int kBQ = 64;   // q rows per block (bf16 body)
constexpr int kBK = 64;   // keys per k tile (bf16 body)
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32: three-pass TF32 products on the tensor cores (mma.sync m16n8k8,
// tf32x3.cuh), tiles fed by cp.async
// ---------------------------------------------------------------------------

// four warps of 16 q rows each; 64 keys a K/V stage at D = 64 (measured
// against 32 keys and eight warps: tools/flash_f32_variants.py), 32 at
// D = 128
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdTile = 16 * kFwdWarps;     // q rows a block

template <int D>
struct FwdF32 {
  static constexpr int kLd = tf32x3::ld_for(D);    // row pitch, floats
  static constexpr int kKeys = D == 64 ? 64 : 32;  // keys a K/V stage
  static constexpr int kTiles = kKeys / 8;         // n-tiles of a stage's S
  static constexpr int kCols = D / 8;              // n-tiles of O
  struct Smem {
    float q[kFwdTile * kLd];
    float k[2][kKeys * kLd];
    float v[2][kKeys * kLd];
  };
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ kv_lens,
                      float* __restrict__ o, float* __restrict__ lse,
                      int T_len, int S, int H,
                      int64_t q_sb, int64_t q_st, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,
                      int64_t v_sb, int64_t v_ss, int64_t v_sh,
                      float scale, int causal) {
  using namespace tf32x3;
  using P = FwdF32<D>;
  constexpr int kLd = P::kLd, kKeys = P::kKeys, kTiles = P::kTiles;
  constexpr int kCols = P::kCols;
  extern __shared__ float4 smem_f4[];
  typename P::Smem& sm = *reinterpret_cast<typename P::Smem*>(smem_f4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kFwdTile;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb_ = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int r0 = 16 * warp;              // the warp's rows of the tile
  const int qa = q0 + r0 + (lane >> 2);  // this thread's rows qa, qa + 8

  // the k bound (_k_block_hi), in keys: tiles wholly past the causal
  // diagonal or past kv_len hold p == 0 exactly and are never loaded
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q0 + kFwdTile);
  const int n_kt = (k_end + kKeys - 1) / kKeys;   // >= 1: kv_len >= 1

  // groups: Q with the first K/V stage, then the second stage
  load_tile_async<kFwdTile, kFwdThreads, D>(sm.q, qb, q_st, q0, T_len, tid);
  for (int s = 0; s < 2; ++s) {
    if (s < n_kt) {
      load_tile_async<kKeys, kFwdThreads, D>(sm.k[s], kb_, k_ss, s * kKeys,
                                             S, tid);
      load_tile_async<kKeys, kFwdThreads, D>(sm.v[s], vb, v_ss, s * kKeys,
                                             S, tid);
    }
    cp_async_commit();
  }

  // this thread's rows: m the running max of scale*s, l the partial sum
  // over the thread's columns (the quad's four partials are summed at the
  // end). p = 2^((scale*s - m) * log2(e)): the difference is taken before
  // the one inexact factor, as the backward's recompute takes it, so the
  // rounding of log2(e) scales no more than that difference.
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[kCols][4];                   // O: the warp's 16 rows x D
#pragma unroll
  for (int n = 0; n < kCols; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const int k0 = kt * kKeys;
    cp_async_wait<1>();                  // this thread's copies of stage kt
    __syncthreads();                     // everyone's
    // the warp's rows see none of the stage's keys past the diagonal
    // (stage 0 always has key 0 live for every row, so m is real after it)
    if (!causal || k0 <= q0 + r0 + 15) {
      // S = Q . K^T: [16 rows x kKeys keys]
      float sc[kTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        FragA fq;
        load_a(fq, sm.q, r0, 8 * ks, lane, kLd);
#pragma unroll
        for (int np = 0; np < kTiles / 2; ++np) {
          FragB fk0, fk1;
          load_b_nk2(fk0, fk1, sm.k[st], 16 * np, 8 * ks, lane, kLd);
          mma3(sc[2 * np], fq, fk0);
          mma3(sc[2 * np + 1], fq, fk1);
        }
      }

      // masks only on edge stages (kv_len, the causal diagonal); then the
      // online softmax on the fragments: a row lies in a quad of lanes,
      // so its max takes two shuffles
      const bool edge = k0 + kKeys > kv_len ||
                        (causal && k0 + kKeys - 1 > q0 + r0);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = sc[j][e] * scale;
          if (edge) {
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool ok = kp < kv_len && (!causal || qa + 8 * i >= kp);
            x = ok ? x : kNeg;
          }
          sc[j][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2_approx((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = exp2_approx((sc[j][e] - m[i]) * kLog2e);
          sc[j][e] = p;
          l[i] += p;
        }
#pragma unroll
      for (int n = 0; n < kCols; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

      // O += P . V over the stage's keys: P from the accumulators, V
      // [keys][d] read down its rows
      // (the stage's sum in a fresh accumulator, added to O in f32:
      // tf32x3.cuh, "Accumulation")
      if constexpr (D == 64) {
        float o_st[kCols][4];
#pragma unroll
        for (int n = 0; n < kCols; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o_st[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          FragA fp;
          acc_to_a(fp, sc[j]);
#pragma unroll
          for (int n = 0; n < kCols; ++n) {
            FragB fv;
            load_b_kn(fv, sm.v[st], 8 * j, 8 * n, lane, kLd);
            mma3(o_st[n], fp, fv);
          }
        }
#pragma unroll
        for (int n = 0; n < kCols; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += o_st[n][e];
      } else {
        // column tile by column tile, each over every key of the stage
        // in the same order: the same sums, with one 4-register fresh
        // accumulator live in place of [16 x D]
        FragA fp[kTiles];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) acc_to_a(fp[j], sc[j]);
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          float o_st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            FragB fv;
            load_b_kn(fv, sm.v[st], 8 * j, 8 * n, lane, kLd);
            mma3(o_st, fp[j], fv);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += o_st[e];
        }
      }
    }
    __syncthreads();                     // every warp is done with stage st
    if (kt + 2 < n_kt) {
      const int kn = k0 + 2 * kKeys;
      load_tile_async<kKeys, kFwdThreads, D>(sm.k[st], kb_, k_ss, kn, S,
                                             tid);
      load_tile_async<kKeys, kFwdThreads, D>(sm.v[st], vb, v_ss, kn, S,
                                             tid);
    }
    cp_async_commit();                 // (empty past the end: the count stays)
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // o and lse are contiguous [B, T, H, D] and [B, T, H]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qa + 8 * i;
    if (tq >= T_len) continue;
    // a row with no live key has l == 0 (the l_safe guard of the TPU kernel)
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const int64_t row = (static_cast<int64_t>(b) * T_len + tq) * H + h;
    float* orow = o + row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kCols; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * i] / ls, acc[n][2 * i + 1] / ls);
    if (t4 == 0) lse[row] = m[i] + logf(ls);
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v,
                const int* kv_lens, void* o, float* lse, int B, int T_len,
                int S, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh, float scale, int causal,
                cudaStream_t stream) {
  constexpr size_t smem = sizeof(typename FwdF32<D>::Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kFwdTile - 1) / kFwdTile, B * H);
  flash_fwd_tf32_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_lens, static_cast<float*>(o), lse,
      T_len, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: products on the tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup: 64 q rows
constexpr int kStages = 2;        // K/V ring depth

template <int D>
struct FwdSmem {                  // every tile 1024-byte aligned
  static constexpr int kHalves = D / 64;
  __nv_bfloat16 q[64 * D];
  __nv_bfloat16 k[kStages][64 * D];
  __nv_bfloat16 v[kStages][64 * D];
  uint64_t q_bar;
  uint64_t full[kStages];
};
template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 1024;   // + align1024
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const int* __restrict__ kv_lens,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int T_len, int S, int H, float scale_log2,
                       int causal) {
  using namespace sm90;
  constexpr int kH = FwdSmem<D>::kHalves;
  constexpr uint32_t kTile = kH * kTileBytes;    // one [64 x D] tile
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  // the forward's k-tile bound (_k_block_hi)
  int hi = (S + kBK - 1) / kBK;
  if (causal) hi = min(hi, (q0 + kBQ + kBK - 1) / kBK);
  hi = min(hi, (kv_len + kBK - 1) / kBK);

  if (tid == 0) {
    tma_prefetch_map(&qmap);
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    mbar_init(&sm.q_bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.q_bar, kTile);
    tma_load_tile<kH>(sm.q, &qmap, &sm.q_bar, h, q0, b);
    for (int s = 0; s < kStages && s < hi; ++s) {
      mbar_expect_tx(&sm.full[s], 2 * kTile);
      tma_load_tile<kH>(sm.k[s], &kmap, &sm.full[s], h, s * kBK, b);
      tma_load_tile<kH>(sm.v[s], &vmap, &sm.full[s], h, s * kBK, b);
    }
  }

  // this thread's rows (q0 + row0, q0 + row0 + 8) in the log2 domain: m
  // is the running max of scale*log2(e)*s, l the partial sum over the
  // thread's 16 columns (the quad's four partials are summed at the end)
  const int row0 = acc_row(tid, 0);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[kH][32], sc[32];             // O by 64-column halves
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kH; ++c) acc[c][i] = 0.f;
  }
  mbar_wait(&sm.q_bar, 0);

  for (int kt = 0; kt < hi; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&sm.full[st], (kt / kStages) & 1);
    const int k0 = kt * kBK;

    // S = Q . K^T on the tensor cores
    wgmma_fence();
    gemm_abt<kH>(sc, sm.q, sm.k[st]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // masks only where the tile crosses kv_len or the causal diagonal
    const bool edge = k0 + kBK > kv_len || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int qp = q0 + row0 + 8 * ((i >> 1) & 1);
        const int kp = k0 + acc_col(tid, i);
        const bool ok = kp < kv_len && (!causal || qp >= kp);
        x = ok ? x : kNeg;
      }
      sc[i] = x;
    }
    // online softmax: a row's max over its quad (2 shuffles); tile 0
    // always holds a live key (key 0) for every row, so m is real after it
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == r) mx = fmaxf(mx, sc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(sc[i] - m[r]);
      sc[i] = p;
      l[r] += p;
#pragma unroll
      for (int c = 0; c < kH; ++c) acc[c][i] *= corr[r];
    }

    // O += P . V: P rounded to bf16 in registers as the A operand, V
    // [key][d] read MN-major from shared memory, one wgmma chain a half
    uint32_t pf[16];
    acc_to_frag(sc, pf);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kH; ++c)
      gemm_pb(acc[c], pf, reinterpret_cast<const uint8_t*>(sm.v[st])
                              + c * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kH; ++c) fence_acc(acc[c]);

    // every warp is done with stage st: refill it with tile kt + kStages
    __syncthreads();
    if (tid == 0 && kt + kStages < hi) {
      const int kn = (kt + kStages) * kBK;
      mbar_expect_tx(&sm.full[st], 2 * kTile);
      tma_load_tile<kH>(sm.k[st], &kmap, &sm.full[st], h, kn, b);
      tma_load_tile<kH>(sm.v[st], &vmap, &sm.full[st], h, kn, b);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + 8 * r;
    if (t >= T_len) continue;
    // a row with no live key has l == 0 (the l_safe guard of the TPU kernel)
    const float ls = l[r] == 0.f ? 1.f : l[r];
    const int64_t row = (static_cast<int64_t>(b) * T_len + t) * H + h;
    __nv_bfloat16* orow = o + row * D;
#pragma unroll
    for (int c = 0; c < kH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c
                                           + acc_col(tid, i)) =
            __floats2bfloat162_rn(acc[c][i] / ls, acc[c][i + 1] / ls);
      }
    if (tid % 4 == 0) lse[row] = (m[r] + log2f(ls)) / kLog2e;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* kv_lens, void* o, float* lse, int B, int T_len,
                int S, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh, float scale, int causal,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!sm90::make_tile_map(&qm, q, B, T_len, H, D, q_sb, q_st, q_sh) ||
      !sm90::make_tile_map(&km, k, B, S, H, D, k_sb, k_ss, k_sh) ||
      !sm90::make_tile_map(&vm, v, B, S, H, D, v_sb, v_ss, v_sh))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, kv_lens, static_cast<__nv_bfloat16*>(o), lse, T_len, S, H,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* kv_lens,
           void* o, float* lse, int B, int T, int S, int H, int64_t q_sb,
           int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss,
           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
           float scale, int causal, int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return launch_tf32<D>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st,
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                          causal, st);
  if (dtype == kBF16)
    return launch_bf16<D>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st,
                          q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_tpu_torch

// q [B, T, H, D] and k/v [B, S, H, D] (D = 64, 128 or 256; flash_wide.cu
// at 256) with element
// strides (innermost stride 1); kv_lens [B] int32 in [1, S] or null;
// o [B, T, H, D] contiguous in q's dtype; lse [B, T, H] contiguous f32. Returns the
// launch's cudaError_t (0 on success).
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* kv_lens, void* o,
    float* lse, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st, q_sh,
                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                      dtype, st);
  if (D == 128)
    return launch<128>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st,
                       q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                       causal, dtype, st);
  if (D == wide::kD)
    return wide::fwd(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st, q_sh,
                     k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, dtype,
                     st);
  return (int)cudaErrorInvalidValue;
}
