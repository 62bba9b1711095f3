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
// Both reads run the split body of decode_attn.cuh (decode_split_kernel)
// on the grid (H, B, splits), over the caches' row loaders (DenseRows,
// DenseRowsQ), as the paged reads #6 and #7 do (paged_decode.cu); the
// split count and chunk come from the wrapper (ops/cuda_kernels.py
// decode_splits).
#include "decode_attn.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace decode;

// The dense caches, as a kernel argument: rows<kPer>(b, h, lane) is the
// row loader of one (b, h) read, for this lane's chunks.
template <typename T>
struct DenseCache {                    // #4: k/v [B, L, H, D] of T
  const T* k;
  const T* v;
  int64_t sb, sl, sh;                  // batch, row and head strides
  template <int kPer>
  __device__ __forceinline__ DenseRows<kPer, T> rows(int b, int h,
                                                     Lane ln) const {
    const int64_t at = b * sb + h * sh;
    return DenseRows<kPer, T>{k + at, v + at, sl, ln};
  }
};

struct DenseCacheQ {                   // #5: int8 k/v, f32 scales [B, L, H]
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  int64_t sb, sl, sh;                  // k/v strides
  int64_t ssb, ssl, ssh;               // the scales' strides
  template <int kPer>
  __device__ __forceinline__ DenseRowsQ<kPer> rows(int b, int h,
                                                   Lane ln) const {
    const int64_t at = b * sb + h * sh;
    const int64_t sat = b * ssb + h * ssh;
    return DenseRowsQ<kPer>{k + at, v + at, ks + sat, vs + sat, sl, ssl, ln};
  }
};

}  // namespace
}  // namespace paddle_tpu_torch

// #4. q [B, H, D] (D a multiple of 8 up to 256) with element strides
// (innermost 1); k/v [B, L, H, D]
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
  using namespace paddle_tpu_torch::decode;
  if (bad_split(D, L, splits, chunk, part, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const DenseCache<float> c{static_cast<const float*>(k),
                              static_cast<const float*>(v), kv_sb, kv_sl,
                              kv_sh};
    return launch<float>(q, c, pos, o, part, tickets, B, H, D, L, splits,
                         chunk, q_sb, q_sh, scale, st);
  }
  if (dtype == kBF16) {
    const DenseCache<__nv_bfloat16> c{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kv_sb, kv_sl, kv_sh};
    return launch<__nv_bfloat16>(q, c, pos, o, part, tickets, B, H, D, L,
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
  using namespace paddle_tpu_torch::decode;
  if (bad_split(D, L, splits, chunk, part, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DenseCacheQ c{k, v, k_scale, v_scale, kv_sb, kv_sl, kv_sh,
                      sc_sb, sc_sl, sc_sh};
  if (q_dtype == kF32)
    return launch<float>(q, c, pos, o, part, tickets, B, H, D, L, splits,
                         chunk, q_sb, q_sh, scale, st);
  if (q_dtype == kBF16)
    return launch<__nv_bfloat16>(q, c, pos, o, part, tickets, B, H, D, L,
                                 splits, chunk, q_sb, q_sh, scale, st);
  return (int)cudaErrorInvalidValue;
}
