// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel _fa_fwd_kernel (paddle_tpu/ops/pallas_kernels.py,
// called by _fa_fwd_call): blockwise online-softmax attention with causal
// and per-sample kv_lens masks, o in q's dtype and lse [B, T, H] in f32.
//
// What bounds it on the H100: at the serving shapes (T = S <= 512,
// d_head 64) attention does ~2*T*S*D multiply-adds per (b, h) against
// 4*T*D elements moved, so it is bound by operations in f32; in bf16 the
// tensor cores (989 TF/s) move the bound to the bytes at these shapes.
// Two bodies, chosen by dtype at the entry point:
//
// f32: the products as f32 FMAs on the CUDA cores (67 TF/s peak);
// TF32 stays off, so the tensor cores cannot take them without changing
// the numbers. One 256-thread block per (64-row q tile, b*h). Q, K and V
// tiles are staged through shared memory as f32 (rows padded to D+1
// floats so column reads hit distinct banks); the score tile and the
// online-softmax state (m, l, acc) stay in registers, so the [T, S]
// matrix never reaches device memory. Each thread owns a 4x4 sub-tile:
// rows r*4..r*4+3 and columns c, c+16, c+32, c+48, so a row's 16 owners
// are 16 neighbouring lanes and row reductions are 4 shuffles.
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
// In both bodies K tiles past the causal diagonal or past kv_len are
// never loaded (_k_block_hi), and q, k and v are read in place through
// their strides (no head transpose in device memory); the innermost
// stride must be 1, and for bf16 (TMA) the base must be 16-byte aligned
// and the strides multiples of 16 bytes (the wrapper checks).
#include "common.cuh"
#include "hopper.cuh"

namespace paddle_tpu_torch {
namespace {

constexpr int kBQ = 64;   // q rows per block
constexpr int kBK = 64;   // keys per k tile
constexpr int kThreads = 256;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lens,
                 T* __restrict__ o, float* __restrict__ lse,
                 int T_len, int S, int H,
                 int64_t q_sb, int64_t q_st, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, int causal) {
  static_assert(D == 64, "the 4x4 thread sub-tile covers 64 columns");
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][LD], pre-scaled
  float* Ks = Qs + kBQ * LD;     // [kBK][LD]
  float* Vs = Ks + kBK * LD;     // [kBK][LD]
  float* Ps = Vs + kBK * LD;     // [kBQ][LP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;

  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb_ = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    const int t = q0 + row;
    const float x = t < T_len ? to_f32(qb[t * q_st + d]) : 0.f;
    Qs[row * LD + d] = x * scale;
  }

  // upper k-tile bound: tiles wholly past the causal diagonal or past
  // kv_len contribute p == 0 exactly, so they are never loaded
  int hi = (S + kBK - 1) / kBK;
  if (causal) hi = min(hi, (q0 + kBQ + kBK - 1) / kBK);
  hi = min(hi, (kv_len + kBK - 1) / kBK);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P.V is done with Ks/Vs/Ps
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int row = idx / D, d = idx % D;
      const int s = k0 + row;
      const bool in = s < S;
      Ks[row * LD + d] = in ? to_f32(kb_[s * k_ss + d]) : 0.f;
      Vs[row * LD + d] = in ? to_f32(vb[s * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(c + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c + 16 * j;
        const bool ok = kp < kv_len && (!causal || qp >= kp);
        sc[i][j] = ok ? sc[i][j] : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(r * 4 + i) * LP + c + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * LD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + r * 4 + i;
    if (t >= T_len) continue;
    // a row with no live key has l == 0 (the l_safe guard of the TPU kernel)
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const int64_t row = (static_cast<int64_t>(b) * T_len + t) * H + h;
    T* orow = o + row * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) store_f32(acc[i][j] / ls, orow + c + 16 * j);
    if (c == 0) lse[row] = m[i] + logf(ls);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_lens,
           void* o, float* lse, int B, int T_len, int S, int H,
           int64_t q_sb, int64_t q_st, int64_t q_sh,
           int64_t k_sb, int64_t k_ss, int64_t k_sh,
           int64_t v_sb, int64_t v_ss, int64_t v_sh,
           float scale, int causal, cudaStream_t stream) {
  constexpr int D = 64;
  constexpr size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_lens, static_cast<T*>(o), lse, T_len, S,
      H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: products on the tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup: 64 q rows
constexpr int kStages = 2;        // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

struct FwdSmem {                  // every tile 1024-byte aligned
  __nv_bfloat16 q[64 * 64];
  __nv_bfloat16 k[kStages][64 * 64];
  __nv_bfloat16 v[kStages][64 * 64];
  uint64_t q_bar;
  uint64_t full[kStages];
};
constexpr size_t kFwdSmemBytes = sizeof(FwdSmem) + 1024;  // + align1024

__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const int* __restrict__ kv_lens,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int T_len, int S, int H, float scale_log2,
                       int causal) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align1024(smem_raw));
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
    mbar_expect_tx(&sm.q_bar, kTileBytes);
    tma_load_tile(sm.q, &qmap, &sm.q_bar, h, q0, b);
    for (int s = 0; s < kStages && s < hi; ++s) {
      mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
      tma_load_tile(sm.k[s], &kmap, &sm.full[s], h, s * kBK, b);
      tma_load_tile(sm.v[s], &vmap, &sm.full[s], h, s * kBK, b);
    }
  }

  // this thread's rows (q0 + row0, q0 + row0 + 8) in the log2 domain: m
  // is the running max of scale*log2(e)*s, l the partial sum over the
  // thread's 16 columns (the quad's four partials are summed at the end)
  const int row0 = acc_row(tid, 0);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.f;
  mbar_wait(&sm.q_bar, 0);

  for (int kt = 0; kt < hi; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&sm.full[st], (kt / kStages) & 1);
    const int k0 = kt * kBK;

    // S = Q . K^T on the tensor cores
    wgmma_fence();
    gemm_abt(sc, sm.q, sm.k[st]);
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
      acc[i] *= corr[r];
    }

    // O += P . V: P rounded to bf16 in registers as the A operand, V
    // [key][d] read MN-major from shared memory
    uint32_t pf[16];
    acc_to_frag(sc, pf);
    wgmma_fence();
    gemm_pb(acc, pf, sm.v[st]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    // every warp is done with stage st: refill it with tile kt + kStages
    __syncthreads();
    if (tid == 0 && kt + kStages < hi) {
      const int kn = (kt + kStages) * kBK;
      mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
      tma_load_tile(sm.k[st], &kmap, &sm.full[st], h, kn, b);
      tma_load_tile(sm.v[st], &vmap, &sm.full[st], h, kn, b);
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
    __nv_bfloat16* orow = o + row * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + acc_col(tid, i)) =
          __floats2bfloat162_rn(acc[i] / ls, acc[i + 1] / ls);
    }
    if (tid % 4 == 0) lse[row] = (m[r] + log2f(ls)) / kLog2e;
  }
}

int launch_bf16(const void* q, const void* k, const void* v,
                const int* kv_lens, void* o, float* lse, int B, int T_len,
                int S, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh, float scale, int causal,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!sm90::make_tile_map(&qm, q, B, T_len, H, q_sb, q_st, q_sh) ||
      !sm90::make_tile_map(&km, k, B, S, H, k_sb, k_ss, k_sh) ||
      !sm90::make_tile_map(&vm, v, B, S, H, v_sb, v_ss, v_sh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  flash_fwd_wgmma_kernel<<<grid, kWgThreads, kFwdSmemBytes, stream>>>(
      qm, km, vm, kv_lens, static_cast<__nv_bfloat16*>(o), lse, T_len, S, H,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paddle_tpu_torch

// q [B, T, H, D] and k/v [B, S, H, D] with element strides (innermost
// stride 1); kv_lens [B] int32 in [1, S] or null; o [B, T, H, D]
// contiguous in q's dtype; lse [B, T, H] contiguous f32. Returns the
// launch's cudaError_t (0 on success).
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* kv_lens, void* o,
    float* lse, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (D != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st,
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                         causal, st);
  if (dtype == kBF16)
    return launch_bf16(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st,
                       q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                       causal, st);
  return (int)cudaErrorInvalidValue;
}
