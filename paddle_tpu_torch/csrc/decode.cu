// Dense decode attention for Hopper (sm_90a): kernels #4 and #5.
//
// Replaces the TPU kernels _decode_attn_kernel (#4) and
// _decode_attn_q_kernel (#5) of paddle_tpu/ops/pallas_kernels.py (called
// by decode_attention, the decode step's cache read): one query token per
// sample reads rows j <= pos[b] of its dense cache k/v [B, L, H, D] (f32 or
// bf16; for #5 int8 with f32 scales [B, L, H]) with an f32 softmax and an
// f32 output [B, H, D].
//
// Bound by bytes, like every decode read (decode_attn.cuh). The TPU kernel
// streams a sample's whole [L, H, D] block through VMEM; here the blocks of
// an (h, b) walk only its live rows with the shared row walk, reading the
// cache in place through its strides: the decode step hands over a
// [:, :L] view of the [B, max_len, H, D] cache, and a copy would move the
// whole cache every step. A drained serving slot decodes on past the read
// bound (pos[b] >= L), so the live count is clamped to L: no row >= L is
// ever read.
//
// Both reads split across blocks. Each read walks its live rows one
// dependent row group after another, so a block's time grows with L while
// the bytes it moves do not fill the card: at B = 8, H = 12 one block per
// (h, b) is 96 blocks on 132 SMs, the same time in f32 and bf16, and the
// int8 read (a quarter of f32's bytes) no faster than f32's. So the grid is
// (H, B, splits): block s walks rows [s*chunk, (s+1)*chunk) of the live
// ones (a chunk wholly past them walks nothing and gives m = kNeg, l = 0,
// acc = 0) and writes its partial (m, l, acc[64]) in f32 to scratch. The
// last block of a (b, h) to finish -- found by an atomic ticket, which it
// resets for the next launch -- merges the partials in chunk order, so the
// result is deterministic and one read stays one launch. With one split a
// block owns its whole read and writes o directly, as #6 and #7 do (they
// keep one block per (h, b)). #4 and #5 run one body, templated over the
// cache's row loader (decode_attn.cuh DenseRows, DenseRowsQ); the split
// count and chunk come from the wrapper (ops/cuda_kernels.py
// decode_splits).
#include "decode_attn.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace decode;

// The dense caches, as a kernel argument: rows(b, h, lane) is the row
// loader of one (b, h) read, at this lane's first element.
template <typename T>
struct DenseCache {                    // #4: k/v [B, L, H, D] of T
  const T* k;
  const T* v;
  int64_t sb, sl, sh;                  // batch, row and head strides
  __device__ __forceinline__ DenseRows<T> rows(int b, int h,
                                               int lane) const {
    const int64_t at = b * sb + h * sh + lane;
    return DenseRows<T>{k + at, v + at, sl};
  }
};

struct DenseCacheQ {                   // #5: int8 k/v, f32 scales [B, L, H]
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  int64_t sb, sl, sh;                  // k/v strides
  int64_t ssb, ssl, ssh;               // the scales' strides
  __device__ __forceinline__ DenseRowsQ rows(int b, int h, int lane) const {
    const int64_t at = b * sb + h * sh + lane;
    const int64_t sat = b * ssb + h * ssh;
    return DenseRowsQ{k + at, v + at, ks + sat, vs + sat, sl, ssl};
  }
};

// #4 and #5: block (h, b, s) walks chunk s and writes its partial to
// part[(b*H + h)*splits + s] = (m, l, acc[kD]); the last of the (b, h)
// blocks to arrive merges them into o. With one split (part and tickets
// unused) the block writes o itself.
template <typename TQ, typename Cache>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dense_decode_split_kernel(const TQ* __restrict__ q, const Cache cache,
                          const int* __restrict__ pos,
                          float* __restrict__ o, float* __restrict__ part,
                          int* __restrict__ tickets, int H, int L,
                          int chunk, int64_t q_sb, int64_t q_sh,
                          float scale) {
  constexpr int kPart = kD + 2;
  __shared__ bool last;
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int bh = b * H + h;
  const int j_lo = s * chunk;
  const int j_hi = min(j_lo + chunk, min(pos[b] + 1, L));
  Partial pt{kNeg, 0.f, 0.f};
  if (j_lo < j_hi) {        // else the chunk is past the live rows
    const int lane = (tid % kLanesPerRow) * kE;
    pt = walk_rows(q + b * q_sb + h * q_sh + lane, scale, j_lo, j_hi,
                   cache.rows(b, h, lane));
  }
  if (splits == 1) {        // the whole read (row 0 is live, so l > 0)
    if (tid < kD) o[static_cast<int64_t>(bh) * kD + tid] = pt.acc / pt.l;
    return;
  }
  float* mine = part + (static_cast<int64_t>(bh) * splits + s) * kPart;
  if (tid < kD) mine[2 + tid] = pt.acc;
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
  if (tid < kD) {
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
    o[static_cast<int64_t>(bh) * kD + tid] = acc / l;
  }
}

template <typename TQ, typename Cache>
int launch(const void* q, const Cache& cache, const int* pos, float* o,
           float* part, int* tickets, int B, int H, int L, int splits,
           int chunk, int64_t q_sb, int64_t q_sh, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B, splits);
  dense_decode_split_kernel<TQ, Cache><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), cache, pos, o, part, tickets, H, L, chunk,
      q_sb, q_sh, scale);
  return (int)cudaGetLastError();
}

// the split arguments both entries take: 0 when they tile [0, L)
inline bool bad_split(int D, int L, int splits, int chunk, const float* part,
                      const int* tickets) {
  return D != kD || splits < 1 || chunk < 1 ||
         (splits > 1 && (part == nullptr || tickets == nullptr)) ||
         static_cast<int64_t>(splits - 1) * chunk >= L ||
         static_cast<int64_t>(splits) * chunk < L;
}

}  // namespace
}  // namespace paddle_tpu_torch

// #4. q [B, H, D] with element strides (innermost 1); k/v [B, L, H, D]
// with shared element strides (batch kv_sb, row kv_sl, head kv_sh;
// innermost 1), each a multiple of 8, 16-byte-aligned bases; pos [B] int32
// >= 0 (the live count is clamped to L); o [B, H, D] contiguous f32.
// ``splits`` chunks of ``chunk`` rows cover [0, L) (splits == 1: one block
// per (h, b), part and tickets unused, may be null); else part is f32
// scratch of B*H*splits*(D + 2) and tickets B*H int32 zeros, left zero
// again by the launch. Returns the launch's cudaError_t.
extern "C" int paddle_decode_attention(
    const void* q, const void* k, const void* v, const int* pos, float* o,
    float* part, int* tickets, int B, int H, int D, int L, int splits,
    int chunk, int64_t q_sb, int64_t q_sh, int64_t kv_sb, int64_t kv_sl,
    int64_t kv_sh, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (bad_split(D, L, splits, chunk, part, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const DenseCache<float> c{static_cast<const float*>(k),
                              static_cast<const float*>(v), kv_sb, kv_sl,
                              kv_sh};
    return launch<float>(q, c, pos, o, part, tickets, B, H, L, splits, chunk,
                         q_sb, q_sh, scale, st);
  }
  if (dtype == kBF16) {
    const DenseCache<__nv_bfloat16> c{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kv_sb, kv_sl, kv_sh};
    return launch<__nv_bfloat16>(q, c, pos, o, part, tickets, B, H, L,
                                 splits, chunk, q_sb, q_sh, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// #5. As #4 over an int8 cache k/v [B, L, H, D] (strides as #4's) with f32
// scales k_scale/v_scale [B, L, H] sharing element strides (sc_sb, sc_sl,
// sc_sh); q f32 or bf16 (``q_dtype``); the same splits, part and tickets.
extern "C" int paddle_decode_attention_q(
    const void* q, const int8_t* k, const float* k_scale, const int8_t* v,
    const float* v_scale, const int* pos, float* o, float* part,
    int* tickets, int B, int H, int D, int L, int splits, int chunk,
    int64_t q_sb, int64_t q_sh, int64_t kv_sb, int64_t kv_sl, int64_t kv_sh,
    int64_t sc_sb, int64_t sc_sl, int64_t sc_sh, float scale, int q_dtype,
    void* stream) {
  using namespace paddle_tpu_torch;
  if (bad_split(D, L, splits, chunk, part, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DenseCacheQ c{k, v, k_scale, v_scale, kv_sb, kv_sl, kv_sh,
                      sc_sb, sc_sl, sc_sh};
  if (q_dtype == kF32)
    return launch<float>(q, c, pos, o, part, tickets, B, H, L, splits, chunk,
                         q_sb, q_sh, scale, st);
  if (q_dtype == kBF16)
    return launch<__nv_bfloat16>(q, c, pos, o, part, tickets, B, H, L,
                                 splits, chunk, q_sb, q_sh, scale, st);
  return (int)cudaErrorInvalidValue;
}
