// Flash attention at head width 256 for Hopper (sm_90a): the forward
// (#1), dq (#2) and dk/dv (#3) bodies the entries of flash_fwd.cu and
// flash_bwd.cu launch when D = 256 (GPT-J's and Gemma's heads), in f32
// and bf16.
//
// They compute what the D = 64 and D = 128 bodies compute (the TPU
// kernels _fa_fwd_kernel, _fa_bwd_dq_kernel and _fa_bwd_dkv_kernel of
// paddle_tpu/ops/pallas_kernels.py): blockwise online-softmax attention
// with the causal (top-left aligned) and per-sample kv_lens masks, o and
// the f32 row logsumexp; then, from lse, P recomputed a tile at a time,
// dS = P * (dO.V^T - delta), dQ = scale * dS.K, dV = P^T.dO and
// dK = scale * dS^T.Q, with delta = rowsum(dO * O) computed by the dq
// body when the caller gives none.
//
// Design: the simple body. The tensor-core bodies do not double to
// D = 256 (at D = 128 they already hold 242-254 registers a thread, and
// the f32 three-pass body would need ~192 KB of shared memory for Q and
// one K/V stage), so these run their products on the f32 units. A block
// of 256 threads owns 32 rows (q rows for the forward and dq, keys for
// dk/dv) of one (b, h); each tile of the other side is 32 rows. Every
// tile is converted to f32 in shared memory (rows of 260 floats, so that
// the 16-byte loads of 8 rows at one d fall in 8 different groups of 4
// banks). Eight consecutive lanes own one row: for S (and dP) each lane
// takes 4 of the tile's 32 columns, the dot products reading both
// operands 4 floats at a time; the online softmax reduces a row over its
// 8 lanes (3 shuffles); and each lane keeps 32 of the row's 256 output
// columns in registers, 4 contiguous ones in each 32-column group
// (d = 32 j + 4 lane8 + e), so the second product reads its operand rows
// 16 bytes at a time without a bank conflict. P (and dS) pass through
// shared memory between the two products. Loads are plain strided loads, so no
// alignment rule applies to q, k and v. Every output element has one
// owner and every sum runs in a fixed order, with no atomics, so two runs
// give the same bits.
//
// Numerics: f32 sums throughout. In bf16 the inputs are widened to f32
// and P (forward), dS (dq), P^T and dS^T (dk/dv) are rounded to bf16
// before the second product, as the wgmma bodies round them (l sums the
// f32 P); outputs are rounded once at the end.
#include "common.cuh"
#include "flash_wide.cuh"

namespace paddle_tpu_torch {
namespace wide {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // rows a block owns, rows a tile
constexpr int kLd = kD + 4;               // f32 row pitch in shared memory
constexpr int kQuads = kD / 32;           // 4-column groups a lane keeps
constexpr int kPLd = kRows + 1;           // pitch of the P / dS tiles
constexpr size_t kTile = sizeof(float) * kRows * kLd;
constexpr size_t kPTile = sizeof(float) * kRows * kPLd;

__device__ __forceinline__ float round_like(float x, const float*) {
  return x;
}
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [r0, r0 + kRows) of a [*, kD] operand at ``base`` (row stride
// ``rs`` elements) into f32 shared memory; rows at or past ``limit`` are
// zeros. Consecutive threads read consecutive elements of a row.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          int64_t rs, int r0, int limit) {
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int gr = r0 + r;
    dst[r * kLd + d] = gr < limit ? to_f32(base[gr * rs + d]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// acc[j] += w * row[32 j + 4 g .. + 3]: a lane's 32 output columns
__device__ __forceinline__ void axpy_row(float4 acc[kQuads], float w,
                                         const float* row, int g) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const float4 v = ld4(row + 32 * j + 4 * g);
    acc[j].x = fmaf(w, v.x, acc[j].x);
    acc[j].y = fmaf(w, v.y, acc[j].y);
    acc[j].z = fmaf(w, v.z, acc[j].z);
    acc[j].w = fmaf(w, v.w, acc[j].w);
  }
}

// out[32 j + 4 g + e] = acc[j].e * mul, in T
template <typename T>
__device__ __forceinline__ void store_row(T* out, const float4 acc[kQuads],
                                          float mul, int g) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    T* p = out + 32 * j + 4 * g;
    store_f32(acc[j].x * mul, p);
    store_f32(acc[j].y * mul, p + 1);
    store_f32(acc[j].z * mul, p + 2);
    store_f32(acc[j].w * mul, p + 3);
  }
}

// a row's reduction over its 8 lanes
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int w = 1; w < 8; w <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 1; w < 8; w <<= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// the keys past which no q row of [q0, q0 + kRows) has a live one
__device__ __forceinline__ int key_end(int kv_len, int causal, int q0) {
  return causal ? min(kv_len, q0 + kRows) : kv_len;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ kv_lens,
                T* __restrict__ o, float* __restrict__ lse, int T_len, int S,
                int H, int64_t q_sb, int64_t q_st, int64_t q_sh,
                int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh, float scale, int causal) {
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);
  float* sk = sq + kRows * kLd;
  float* sv = sk + kRows * kLd;
  float* sp = sv + kRows * kLd;
  const int tid = threadIdx.x, r = tid / 8, g = tid % 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows, tq = q0 + r;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const int n_kt = (key_end(kv_len, causal, q0) + kRows - 1) / kRows;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  load_rows(sq, q + b * q_sb + h * q_sh, q_st, q0, T_len);

  // m: the row's running max of scale*s; l: this lane's part of the sum
  float m = kNeg, l = 0.f;
  float4 acc[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();                    // every lane is done with the tiles
    load_rows(sk, kb, k_ss, k0, S);
    load_rows(sv, vb, v_ss, k0, S);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < kD; d += 4) {
      const float4 q4 = ld4(sq + r * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i] = dot4(q4, ld4(sk + (g + 8 * i) * kLd + d), s[i]);
    }
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + g + 8 * i;
      const bool ok = kp < kv_len && (!causal || tq >= kp);
      s[i] = ok ? s[i] * scale : kNeg;
      mx = fmaxf(mx, s[i]);
    }
    // tile 0 holds key 0, live for every row, so m is real after it
    const float m_new = fmaxf(m, row_max(mx));
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - m);
      l += p;
      sp[r * kPLd + g + 8 * i] = round_like(p, q);
    }
    __syncwarp();                       // the row's 8 lanes share a warp
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      acc[j].x *= corr;
      acc[j].y *= corr;
      acc[j].z *= corr;
      acc[j].w *= corr;
    }
    for (int c = 0; c < kRows; ++c)
      axpy_row(acc, sp[r * kPLd + c], sv + c * kLd, g);
  }
  l = row_sum(l);
  if (tq >= T_len) return;
  // a row with no live key has l == 0 (the l_safe guard of the TPU kernel)
  const float ls = l == 0.f ? 1.f : l;
  const int64_t row = (static_cast<int64_t>(b) * T_len + tq) * H + h;
  store_row(o + row * kD, acc, 1.f / ls, g);
  if (g == 0) lse[row] = m + logf(ls);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, const int* __restrict__ kv_lens,
               T* __restrict__ dq, int T_len, int S, int H, int64_t q_sb,
               int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss,
               int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
               float scale, int causal, int compute_delta) {
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);
  float* sdo = sq + kRows * kLd;
  float* sk = sdo + kRows * kLd;
  float* sv = sk + kRows * kLd;
  float* sds = sv + kRows * kLd;
  const int tid = threadIdx.x, r = tid / 8, g = tid % 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows, tq = q0 + r;
  const bool live_row = tq < T_len;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const int n_kt = (key_end(kv_len, causal, q0) + kRows - 1) / kRows;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  // o, dout, dq, lse and delta are contiguous [B, T, H(, D)]
  const int64_t row = (static_cast<int64_t>(b) * T_len + tq) * H + h;
  const int64_t o_rs = static_cast<int64_t>(H) * kD;
  load_rows(sq, q + b * q_sb + h * q_sh, q_st, q0, T_len);
  load_rows(sdo, dout + (static_cast<int64_t>(b) * T_len * H + h) * kD,
            o_rs, q0, T_len);
  __syncthreads();
  float lse_r = 0.f, delta_r = 0.f;
  if (compute_delta) {
    float part = 0.f;
    if (live_row) {
#pragma unroll 8
      for (int j = 0; j < kD / 8; ++j)
        part = fmaf(sdo[r * kLd + g + 8 * j], to_f32(o[row * kD + g + 8 * j]),
                    part);
    }
    delta_r = row_sum(part);
    if (live_row && g == 0) delta[row] = delta_r;
  } else if (live_row) {
    delta_r = delta[row];
  }
  if (live_row) lse_r = lse[row];

  float4 acc[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_rows(sk, kb, k_ss, k0, S);
    load_rows(sv, vb, v_ss, k0, S);
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < kD; d += 4) {
      const float4 q4 = ld4(sq + r * kLd + d), do4 = ld4(sdo + r * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (g + 8 * i) * kLd + d;
        s[i] = dot4(q4, ld4(sk + c), s[i]);
        dp[i] = dot4(do4, ld4(sv + c), dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + g + 8 * i;
      const bool ok = live_row && kp < kv_len && (!causal || tq >= kp);
      const float p = ok ? expf(s[i] * scale - lse_r) : 0.f;
      sds[r * kPLd + g + 8 * i] = round_like(p * (dp[i] - delta_r), q);
    }
    __syncwarp();
    for (int c = 0; c < kRows; ++c)
      axpy_row(acc, sds[r * kPLd + c], sk + c * kLd, g);
  }
  if (!live_row) return;
  store_row(dq + row * kD, acc, scale, g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ kv_lens, T* __restrict__ dk,
                T* __restrict__ dv, int T_len, int S, int H, int64_t q_sb,
                int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                float scale, int causal) {
  extern __shared__ float4 smem_f4[];
  float* sk = reinterpret_cast<float*>(smem_f4);
  float* sv = sk + kRows * kLd;
  float* sq = sv + kRows * kLd;
  float* sdo = sq + kRows * kLd;
  float* sp = sdo + kRows * kLd;
  float* sds = sp + kRows * kPLd;
  float* slse = sds + kRows * kPLd;
  float* sdelta = slse + kRows;
  const int tid = threadIdx.x, c = tid / 8, g = tid % 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows, kp = k0 + c;
  const int kv_len = kv_lens ? min(kv_lens[b], S) : S;
  const int64_t key_row = (static_cast<int64_t>(b) * S + kp) * H + h;
  float4 dka[kQuads], dva[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
    dka[j] = dva[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // a tile wholly at or past kv_len has no live pair: it writes zeros
  if (k0 < kv_len) {
    load_rows(sk, k + b * k_sb + h * k_sh, k_ss, k0, S);
    load_rows(sv, v + b * v_sb + h * v_sh, v_ss, k0, S);
    const T* qb = q + b * q_sb + h * q_sh;
    const T* dob = dout + (static_cast<int64_t>(b) * T_len * H + h) * kD;
    const int64_t o_rs = static_cast<int64_t>(H) * kD;
    // q rows before the tile's first key see none of its keys (causal)
    for (int q0 = causal ? k0 : 0; q0 < T_len; q0 += kRows) {
      __syncthreads();
      load_rows(sq, qb, q_st, q0, T_len);
      load_rows(sdo, dob, o_rs, q0, T_len);
      if (tid < kRows) {
        const int t = q0 + tid;
        const int64_t rw = (static_cast<int64_t>(b) * T_len + t) * H + h;
        slse[tid] = t < T_len ? lse[rw] : 0.f;
        sdelta[tid] = t < T_len ? delta[rw] : 0.f;
      }
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < kD; d += 4) {
        const float4 k4 = ld4(sk + c * kLd + d), v4 = ld4(sv + c * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rq = (g + 8 * i) * kLd + d;
          s[i] = dot4(ld4(sq + rq), k4, s[i]);
          dp[i] = dot4(ld4(sdo + rq), v4, dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = g + 8 * i, tq = q0 + rr;
        const bool ok = tq < T_len && kp < kv_len && (!causal || tq >= kp);
        const float p = ok ? expf(s[i] * scale - slse[rr]) : 0.f;
        sp[c * kPLd + rr] = round_like(p, q);
        sds[c * kPLd + rr] = round_like(p * (dp[i] - sdelta[rr]), q);
      }
      __syncwarp();
      for (int rr = 0; rr < kRows; ++rr) {
        axpy_row(dva, sp[c * kPLd + rr], sdo + rr * kLd, g);
        axpy_row(dka, sds[c * kPLd + rr], sq + rr * kLd, g);
      }
    }
  }
  if (kp >= S) return;
  store_row(dk + key_row * kD, dka, scale, g);
  store_row(dv + key_row * kD, dva, 1.f, g);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int fwd_as(const void* q, const void* k, const void* v, const int* kv_lens,
           void* o, float* lse, int B, int T_len, int S, int H, int64_t q_sb,
           int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss,
           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
           float scale, int causal, cudaStream_t st) {
  const size_t smem = 3 * kTile + kPTile;
  cudaError_t err = prepare(wide_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kRows - 1) / kRows, B * H);
  wide_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_lens, static_cast<T*>(o), lse, T_len, S,
      H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_as(const void* q, const void* k, const void* v, const void* o,
          const void* dout, const float* lse, float* delta,
          const int* kv_lens, void* dq_out, int B, int T_len, int S, int H,
          int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
          int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
          int64_t v_sh, float scale, int causal, int compute_delta,
          cudaStream_t st) {
  const size_t smem = 4 * kTile + kPTile;
  cudaError_t err = prepare(wide_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kRows - 1) / kRows, B * H);
  wide_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, kv_lens,
      static_cast<T*>(dq_out), T_len, S, H, q_sb, q_st, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, scale, causal, compute_delta);
  return (int)cudaGetLastError();
}

template <typename T>
int dkv_as(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kv_lens,
           void* dk, void* dv, int B, int T_len, int S, int H, int64_t q_sb,
           int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss,
           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
           float scale, int causal, cudaStream_t st) {
  const size_t smem = 4 * kTile + 2 * kPTile + 2 * kRows * sizeof(float);
  cudaError_t err = prepare(wide_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  wide_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_lens, static_cast<T*>(dk), static_cast<T*>(dv), T_len, S, H, q_sb,
      q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

int fwd(const void* q, const void* k, const void* v, const int* kv_lens,
        void* o, float* lse, int B, int T, int S, int H, int64_t q_sb,
        int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
        int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return fwd_as<float>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb, q_st,
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                         causal, st);
  if (dtype == kBF16)
    return fwd_as<__nv_bfloat16>(q, k, v, kv_lens, o, lse, B, T, S, H, q_sb,
                                 q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                 v_sh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const float* lse, float* delta, const int* kv_lens,
       void* dq_out, int B, int T, int S, int H, int64_t q_sb, int64_t q_st,
       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
       int64_t v_ss, int64_t v_sh, float scale, int causal,
       int compute_delta, int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return dq_as<float>(q, k, v, o, dout, lse, delta, kv_lens, dq_out, B, T,
                        S, H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                        v_sh, scale, causal, compute_delta, st);
  if (dtype == kBF16)
    return dq_as<__nv_bfloat16>(q, k, v, o, dout, lse, delta, kv_lens,
                                dq_out, B, T, S, H, q_sb, q_st, q_sh, k_sb,
                                k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                                compute_delta, st);
  return (int)cudaErrorInvalidValue;
}

int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int* kv_lens, void* dk,
        void* dv, int B, int T, int S, int H, int64_t q_sb, int64_t q_st,
        int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
        int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return dkv_as<float>(q, k, v, dout, lse, delta, kv_lens, dk, dv, B, T, S,
                         H, q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                         v_sh, scale, causal, st);
  if (dtype == kBF16)
    return dkv_as<__nv_bfloat16>(q, k, v, dout, lse, delta, kv_lens, dk, dv,
                                 B, T, S, H, q_sb, q_st, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace paddle_tpu_torch
