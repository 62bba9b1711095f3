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
// operations. In f32 both run the products as f32 FMAs on the CUDA
// cores (67 TF/s peak), as flash_fwd.cu's f32 body does; in bf16 both
// run them on the tensor cores (wgmma, 989 TF/s), below.
//
// Design of the CUDA-core bodies. 256-thread blocks over 64 x 64
// tiles; each thread owns a 4 x 4 sub-tile (rows r*4..r*4+3, columns c,
// c+16, c+32, c+48 with r = tid/16, c = tid%16), so a row's 16 owners
// are 16 neighbouring lanes. Operand
// tiles are staged in shared memory as f32, rows padded to 65 floats so
// that column reads hit distinct banks. The TPU kernels' 512/1024 blocks
// and whole-K/V-in-VMEM layout set nothing here.
//  * dq (#2): one block per (64-row q tile, b*h). Q (pre-scaled), dO, lse
//    and delta of its rows stay resident. It walks the k tiles up to the
//    forward's bound (_k_block_hi: the causal diagonal, kv_len),
//    recomputes S and dP in registers, writes dS to shared memory and
//    accumulates dQ += dS.K in registers; it writes dQ * scale. With no
//    delta from the caller it computes delta in its prologue (rowsum of
//    dO * O over its rows, from the staged dO) and writes it out for the
//    dk/dv kernel, which the wrapper launches after it on the same
//    stream: no separate reduction pass.
//  * dk/dv (#3): one block per (64-key tile, b*h). K and V stay resident.
//    It walks the q tiles from the causal lower bound (the tile holding
//    its first key's diagonal) to the end, computes S^T and dP^T, keeps
//    P^T and dS^T in shared memory, and accumulates dV += P^T.dO and
//    dK += dS^T.Q in registers. A tile wholly at or past kv_len skips the
//    loop and writes zeros. Every output element has one owner and no
//    atomics are used, so the result is deterministic.
//
// Design of the bf16 dq body. One warpgroup (128 threads) per (64-row q
// tile, b*h); Q and dO arrive once by TMA, K and V tiles stream through a
// two-stage ring completed on mbarriers (a third stage was measured slower
// on the H100). A thread's two q rows are fixed for the block,
// so their lse and delta sit in registers (delta, when the caller gives
// none, is
// rowsum(dO * O) in f32 over 16-byte global loads, a quad of lanes a row,
// written out for the dk/dv kernel). Per k tile, up to the same bound as
// the CUDA-core body: S = Q.K^T and dP = dO.V^T (wgmma, both operands
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
// once at the end. It keeps the CUDA-core body's causal lower bound, its
// early exit for a tile at or past kv_len, exact zeros for masked keys
// and one owner per output element, so the result stays deterministic.
// Its one stated deviation from the plain version is the bf16 rounding
// of P^T and dS^T before the second products.
//
// q, k and v are read in place through their strides (views of the fused
// qkv projection; innermost stride 1; for the bf16 bodies, a 16-byte
// aligned base and strides of 16-byte multiples). o, dO, lse, delta and
// the outputs are contiguous: the wrapper makes o and dO contiguous,
// which copies nothing for autograd's cotangent of the forward's
// contiguous output.
#include "common.cuh"
#include "hopper.cuh"

namespace paddle_tpu_torch {
namespace {

constexpr int kB = 64;        // q rows per q tile and keys per k tile
constexpr int kThreads = 256;

template <int D>
constexpr size_t dq_smem_bytes() {   // Qs, dOs, Ks, Vs, dSs
  return sizeof(float) * (4 * kB * (D + 1) + kB * (kB + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // Ks, Vs, Qs, dOs, Ps, dSs, lse, delta
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    const int* __restrict__ kv_lens, T* __restrict__ dq,
                    int T_len, int S, int H,
                    int64_t q_sb, int64_t q_st, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    float scale, int causal, int compute_delta) {
  static_assert(D == 64, "the 4x4 thread sub-tile covers 64 columns");
  constexpr int LD = D + 1;
  constexpr int LP = kB + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kB][LD], pre-scaled
  float* dOs = Qs + kB * LD;      // [kB][LD]
  float* Ks = dOs + kB * LD;      // [kB][LD]
  float* Vs = Ks + kB * LD;       // [kB][LD]
  float* dSs = Vs + kB * LD;      // [kB][LP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb_ = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  // o, dO and dq are contiguous [B, T, H, D]; lse and delta [B, T, H]
  const int64_t row_st = static_cast<int64_t>(H) * D;
  const int64_t base = (static_cast<int64_t>(b) * T_len * H + h) * D;
  const T* ob = o + base;
  const T* dob = dout + base;

  for (int idx = tid; idx < kB * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    const int t = q0 + row;
    const bool in = t < T_len;
    Qs[row * LD + d] = in ? to_f32(qb[t * q_st + d]) * scale : 0.f;
    dOs[row * LD + d] = in ? to_f32(dob[t * row_st + d]) : 0.f;
  }
  __syncthreads();

  // lse and delta of this thread's rows; a padded row (t >= T) gets 0 for
  // both, so that its dS is 0 (its dq is never written)
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + r * 4 + i;
    const bool in = t < T_len;
    const int64_t ri = (static_cast<int64_t>(b) * T_len + t) * H + h;
    lse_r[i] = in ? lse[ri] : 0.f;
    if (compute_delta) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = c + 16 * j;
        part += in ? dOs[(r * 4 + i) * LD + d] * to_f32(ob[t * row_st + d])
                   : 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      delta_r[i] = part;
      if (c == 0 && in) delta[ri] = part;
    } else {
      delta_r[i] = in ? delta[ri] : 0.f;
    }
  }

  // the forward's k-tile bound: tiles wholly past the causal diagonal or
  // past kv_len have P == 0 exactly and add nothing to dq
  int hi = (S + kB - 1) / kB;
  if (causal) hi = min(hi, (q0 + kB + kB - 1) / kB);
  hi = min(hi, (kv_len + kB - 1) / kB);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's dS.K is done with Ks and dSs
    for (int idx = tid; idx < kB * D; idx += kThreads) {
      const int row = idx / D, d = idx % D;
      const int s = k0 + row;
      const bool in = s < S;
      Ks[row * LD + d] = in ? to_f32(kb_[s * k_ss + d]) : 0.f;
      Vs[row * LD + d] = in ? to_f32(vb[s * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(r * 4 + i) * LD + d];
        dov[i] = dOs[(r * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(c + 16 * j) * LD + d];
        vv[j] = Vs[(c + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c + 16 * j;
        const bool ok = kp < kv_len && (!causal || qp >= kp);
        const float p = ok ? expf(sc[i][j] - lse_r[i]) : 0.f;
        dSs[(r * 4 + i) * LP + c + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kB; ++kk) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(r * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[kk * LD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + r * 4 + i;
    if (t >= T_len) continue;
    T* row = dq + base + t * row_st;
#pragma unroll
    for (int j = 0; j < 4; ++j) store_f32(acc[i][j] * scale, row + c + 16 * j);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_lens, T* __restrict__ dk,
                     T* __restrict__ dv, int T_len, int S, int H,
                     int64_t q_sb, int64_t q_st, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     float scale, int causal) {
  static_assert(D == 64, "the 4x4 thread sub-tile covers 64 columns");
  constexpr int LD = D + 1;
  constexpr int LP = kB + 1;
  extern __shared__ float smem[];
  float* Ks = smem;               // [kB][LD]
  float* Vs = Ks + kB * LD;       // [kB][LD]
  float* Qs = Vs + kB * LD;       // [kB][LD], pre-scaled
  float* dOs = Qs + kB * LD;      // [kB][LD]
  float* Ps = dOs + kB * LD;      // [kB keys][LP queries]: P^T
  float* dSs = Ps + kB * LP;      // [kB keys][LP queries]: dS^T
  float* lse_s = dSs + kB * LP;   // [kB]
  float* delta_s = lse_s + kB;    // [kB]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kB;
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;   // key rows r*4+i, columns c+16j
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb_ = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int64_t row_st = static_cast<int64_t>(H) * D;
  const T* dob = dout + (static_cast<int64_t>(b) * T_len * H + h) * D;
  const int64_t lrow = static_cast<int64_t>(b) * T_len * H + h;  // lse/delta

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (k0 < kv_len) {  // else every key of the tile is masked: zeros
    for (int idx = tid; idx < kB * D; idx += kThreads) {
      const int row = idx / D, d = idx % D;
      const int s = k0 + row;
      const bool in = s < S;
      Ks[row * LD + d] = in ? to_f32(kb_[s * k_ss + d]) : 0.f;
      Vs[row * LD + d] = in ? to_f32(vb[s * v_ss + d]) : 0.f;
    }
    // causal: q tiles that end before this tile's first key see none of
    // its keys (the TPU kernel's lo)
    const int lo = causal ? k0 / kB : 0;
    const int n_q = (T_len + kB - 1) / kB;
    for (int qt = lo; qt < n_q; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's products are done with Qs,
                        // dOs, Ps and dSs
      for (int idx = tid; idx < kB * D; idx += kThreads) {
        const int row = idx / D, d = idx % D;
        const int t = q0 + row;
        const bool in = t < T_len;
        Qs[row * LD + d] = in ? to_f32(qb[t * q_st + d]) * scale : 0.f;
        dOs[row * LD + d] = in ? to_f32(dob[t * row_st + d]) : 0.f;
      }
      if (tid < kB) {
        const int t = q0 + tid;
        const bool in = t < T_len;
        lse_s[tid] = in ? lse[lrow + static_cast<int64_t>(t) * H] : 0.f;
        delta_s[tid] = in ? delta[lrow + static_cast<int64_t>(t) * H] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];   // [key r*4+i][query c+16j]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(r * 4 + i) * LD + d];
          vv[i] = Vs[(r * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(c + 16 * j) * LD + d];
          dov[j] = dOs[(c + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
            dpt[i][j] = fmaf(dov[j], vv[i], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + r * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c + 16 * j;
          const int qp = q0 + col;
          // padded q rows (t >= T) are masked too: their lse is not real
          const bool ok = kp < kv_len && qp < T_len && (!causal || qp >= kp);
          const float p = ok ? expf(st[i][j] - lse_s[col]) : 0.f;
          Ps[(r * 4 + i) * LP + col] = p;
          dSs[(r * 4 + i) * LP + col] = p * (dpt[i][j] - delta_s[col]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float pv[4], dsv[4], dov[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(r * 4 + i) * LP + qq];
          dsv[i] = dSs[(r * 4 + i) * LP + qq];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dov[j] = dOs[qq * LD + c + 16 * j];
          qv[j] = Qs[qq * LD + c + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + r * 4 + i;
    if (s >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store_f32(dk_acc[i][j], dk + row + c + 16 * j);  // scale is in Qs
      store_f32(dv_acc[i][j], dv + row + c + 16 * j);
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta,
              const int* kv_lens, void* dq, int B, int T_len, int S, int H,
              int64_t q_sb, int64_t q_st, int64_t q_sh,
              int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh,
              float scale, int causal, int compute_delta,
              cudaStream_t stream) {
  constexpr int D = 64;
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kB - 1) / kB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, kv_lens, static_cast<T*>(dq),
      T_len, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale, causal, compute_delta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* kv_lens,
               void* dk, void* dv, int B, int T_len, int S, int H,
               int64_t q_sb, int64_t q_st, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               float scale, int causal, cudaStream_t stream) {
  constexpr int D = 64;
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kB - 1) / kB, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_lens, static_cast<T*>(dk), static_cast<T*>(dv), T_len, S, H, q_sb,
      q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dk/dv (#3): products on the tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;   // one warpgroup: 64 keys
constexpr int kStages = 2;        // Q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

struct DkvSmem {                  // every tile 1024-byte aligned
  __nv_bfloat16 k[64 * 64];
  __nv_bfloat16 v[64 * 64];
  __nv_bfloat16 q[kStages][64 * 64];
  __nv_bfloat16 dout[kStages][64 * 64];
  float lse[kStages][64];         // log2(e) * lse of the tile's q rows
  float delta[kStages][64];
  uint64_t kv_bar;
  uint64_t full[kStages];
};
constexpr size_t kDkvSmemBytes = sizeof(DkvSmem) + 1024;  // + align1024

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
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kB;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const int64_t lrow = static_cast<int64_t>(b) * T_len * H + h;  // lse/delta
  const float scale_log2 = scale * kLog2e;
  const int row0 = acc_row(tid, 0);   // this thread's keys k0 + row0 (+8)

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
      mbar_expect_tx(&sm.kv_bar, 2 * kTileBytes);
      tma_load_tile(sm.k, &kmap, &sm.kv_bar, h, k0, b);
      tma_load_tile(sm.v, &vmap, &sm.kv_bar, h, k0, b);
      for (int s = 0; s < kStages && s < n; ++s) {
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load_tile(sm.q[s], &qmap, &sm.full[s], h, (lo + s) * kB, b);
        tma_load_tile(sm.dout[s], &domap, &sm.full[s], h, (lo + s) * kB, b);
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
      gemm_abt(sc, sm.k, sm.q[st]);
      gemm_abt(dp, sm.v, sm.dout[st]);
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
      // registers as the A operands, dO and Q [q][d] read MN-major
      uint32_t pf[16], df[16];
      acc_to_frag(sc, pf);
      acc_to_frag(dp, df);
      wgmma_fence();
      gemm_pb(dv_acc, pf, sm.dout[st]);
      gemm_pb(dk_acc, df, sm.q[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv_acc);
      fence_acc(dk_acc);

      // every warp is done with stage st: refill it with tile it + kStages
      __syncthreads();
      if (refill) {
        dst[st * kB] = next;
        if (tid == 0) {
          const int qn = q0 + kStages * kB;
          mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
          tma_load_tile(sm.q[st], &qmap, &sm.full[st], h, qn, b);
          tma_load_tile(sm.dout[st], &domap, &sm.full[st], h, qn, b);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = k0 + row0 + 8 * r;
    if (s >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * H + h) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * r;
      const int col = acc_col(tid, i);
      *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* kv_lens, void* dk, void* dv, int B, int T_len,
                    int S, int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                    int64_t v_ss, int64_t v_sh, float scale, int causal,
                    cudaStream_t stream) {
  const int64_t row_st = static_cast<int64_t>(H) * 64;   // dout contiguous
  CUtensorMap qm, km, vm, dom;
  if (!sm90::make_tile_map(&qm, q, B, T_len, H, q_sb, q_st, q_sh) ||
      !sm90::make_tile_map(&km, k, B, S, H, k_sb, k_ss, k_sh) ||
      !sm90::make_tile_map(&vm, v, B, S, H, v_sb, v_ss, v_sh) ||
      !sm90::make_tile_map(&dom, dout, B, T_len, H, T_len * row_st, row_st,
                           64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kB - 1) / kB, B * H);
  flash_bwd_dkv_wgmma_kernel<<<grid, kWgThreads, kDkvSmemBytes, stream>>>(
      qm, km, vm, dom, lse, delta, kv_lens, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T_len, S, H, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dq (#2): products on the tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kDqStages = 2;      // the K/V ring's depth

struct DqSmem {                   // every tile 1024-byte aligned
  __nv_bfloat16 q[64 * 64];
  __nv_bfloat16 dout[64 * 64];
  __nv_bfloat16 k[kDqStages][64 * 64];
  __nv_bfloat16 v[kDqStages][64 * 64];
  uint64_t qdo_bar;
  uint64_t full[kDqStages];
};
constexpr size_t kDqSmemBytes = sizeof(DqSmem) + 1024;   // + align1024

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
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kB;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const float scale_log2 = scale * kLog2e;
  const int row0 = acc_row(tid, 0);   // this thread's q rows q0 + row0 (+8)
  // o, dO and dq are contiguous [B, T, H, 64]; lse and delta [B, T, H]
  const int64_t row_st = static_cast<int64_t>(H) * 64;
  const int64_t base = (static_cast<int64_t>(b) * T_len * H + h) * 64;

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
    mbar_expect_tx(&sm.qdo_bar, 2 * kTileBytes);
    tma_load_tile(sm.q, &qmap, &sm.qdo_bar, h, q0, b);
    tma_load_tile(sm.dout, &domap, &sm.qdo_bar, h, q0, b);
    for (int s = 0; s < kDqStages && s < hi; ++s) {
      mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
      tma_load_tile(sm.k[s], &kmap, &sm.full[s], h, s * kB, b);
      tma_load_tile(sm.v[s], &vmap, &sm.full[s], h, s * kB, b);
    }
  }

  // lse (in log2 units) and delta of this thread's two rows, while the
  // tiles load; a row past T gets 0 for both (its dq is never written).
  // delta = rowsum(dO * O) comes from global memory, not from the
  // swizzled dO tile: the row's quad of lanes reads 16 elements each.
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
        const int64_t at = base + t * row_st + 16 * (tid & 3);
        const uint4* op = reinterpret_cast<const uint4*>(o + at);
        const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
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

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

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
      gemm_abt(sc, sm.q, sm.k[st]);
      gemm_abt(dp, sm.dout, sm.v[st]);
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
      // K [keys][d] read MN-major
      uint32_t df[16];
      acc_to_frag(dp, df);
      wgmma_fence();
      gemm_pb(acc, df, sm.k[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);

      // every warp is done with stage st: refill it with tile kt + kDqStages
      __syncthreads();
      if (tid == 0 && kt + kDqStages < hi) {
        const int kn = k0 + kDqStages * kB;
        mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_tile(sm.k[st], &kmap, &sm.full[st], h, kn, b);
        tma_load_tile(sm.v[st], &vmap, &sm.full[st], h, kn, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + 8 * r;
    if (t >= T_len) continue;
    __nv_bfloat16* row = dq + base + t * row_st;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(row + acc_col(tid, i)) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, const int* kv_lens, void* dq, int B,
                   int T_len, int S, int H, int64_t q_sb, int64_t q_st,
                   int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                   int causal, int compute_delta, cudaStream_t stream) {
  const int64_t row_st = static_cast<int64_t>(H) * 64;   // dout contiguous
  CUtensorMap qm, km, vm, dom;
  if (!sm90::make_tile_map(&qm, q, B, T_len, H, q_sb, q_st, q_sh) ||
      !sm90::make_tile_map(&km, k, B, S, H, k_sb, k_ss, k_sh) ||
      !sm90::make_tile_map(&vm, v, B, S, H, v_sb, v_ss, v_sh) ||
      !sm90::make_tile_map(&dom, dout, B, T_len, H, T_len * row_st, row_st,
                           64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kB - 1) / kB, B * H);
  flash_bwd_dq_wgmma_kernel<<<grid, kWgThreads, kDqSmemBytes, stream>>>(
      qm, km, vm, dom, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, kv_lens,
      static_cast<__nv_bfloat16*>(dq), T_len, S, H, scale, causal,
      compute_delta);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paddle_tpu_torch

// q [B, T, H, D] and k/v [B, S, H, D] with element strides (innermost
// stride 1); o, dout and dq contiguous [B, T, H, D] in q's dtype; lse and
// delta contiguous [B, T, H] f32 (delta is written when compute_delta is
// 1, read otherwise); kv_lens [B] int32 in [1, S] or null. Returns the
// launch's cudaError_t (0 on success).
extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, const int* kv_lens,
    void* dq, int B, int T, int S, int H, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int compute_delta, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (D != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_dq<float>(q, k, v, o, dout, lse, delta, kv_lens, dq, B, T,
                            S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb,
                            v_ss, v_sh, scale, causal, compute_delta, st);
  if (dtype == kBF16)
    return launch_dq_bf16(q, k, v, o, dout, lse, delta, kv_lens, dq, B, T,
                          S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb,
                          v_ss, v_sh, scale, causal, compute_delta, st);
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
  if (D != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_dkv<float>(q, k, v, dout, lse, delta, kv_lens, dk, dv, B,
                             T, S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                             v_sb, v_ss, v_sh, scale, causal, st);
  if (dtype == kBF16)
    return launch_dkv_bf16(q, k, v, dout, lse, delta, kv_lens, dk, dv, B, T,
                           S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb,
                           v_ss, v_sh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
