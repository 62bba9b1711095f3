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
// streams a sample's whole [L, H, D] block through VMEM; here one block per
// (h, b) walks only the live rows with the shared row walk, reading the
// cache in place through its strides: the decode step hands over a
// [:, :L] view of the [B, max_len, H, D] cache, and a copy would move the
// whole cache every step. A drained serving slot decodes on past the read
// bound (pos[b] >= L), so the live count is clamped to L: no row >= L is
// ever read.
#include "decode_attn.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace decode;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ o, int H, int L, int64_t q_sb,
                    int64_t q_sh, int64_t kv_sb, int64_t kv_sl,
                    int64_t kv_sh, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = (threadIdx.x % kLanesPerRow) * kE;
  const int64_t at = b * kv_sb + h * kv_sh + lane;
  const DenseRows<T> rows{k + at, v + at, kv_sl};
  row_walk(q + b * q_sb + h * q_sh + lane, scale, min(pos[b] + 1, L), rows,
           o + (static_cast<int64_t>(b) * H + h) * kD);
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dense_decode_q_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                      const float* __restrict__ k_scale,
                      const int8_t* __restrict__ v,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ pos, float* __restrict__ o,
                      int H, int L, int64_t q_sb, int64_t q_sh,
                      int64_t kv_sb, int64_t kv_sl, int64_t kv_sh,
                      int64_t sc_sb, int64_t sc_sl, int64_t sc_sh,
                      float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = (threadIdx.x % kLanesPerRow) * kE;
  const int64_t at = b * kv_sb + h * kv_sh + lane;
  const int64_t sat = b * sc_sb + h * sc_sh;
  const DenseRowsQ rows{k + at, v + at, k_scale + sat, v_scale + sat, kv_sl,
                        sc_sl};
  row_walk(q + b * q_sb + h * q_sh + lane, scale, min(pos[b] + 1, L), rows,
           o + (static_cast<int64_t>(b) * H + h) * kD);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           float* o, int B, int H, int L, int64_t q_sb, int64_t q_sh,
           int64_t kv_sb, int64_t kv_sl, int64_t kv_sh, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B);
  dense_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, o, H, L, q_sb, q_sh, kv_sb, kv_sl,
      kv_sh, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(const void* q, const int8_t* k, const float* k_scale,
             const int8_t* v, const float* v_scale, const int* pos, float* o,
             int B, int H, int L, int64_t q_sb, int64_t q_sh, int64_t kv_sb,
             int64_t kv_sl, int64_t kv_sh, int64_t sc_sb, int64_t sc_sl,
             int64_t sc_sh, float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  dense_decode_q_kernel<TQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), k, k_scale, v, v_scale, pos, o, H, L, q_sb,
      q_sh, kv_sb, kv_sl, kv_sh, sc_sb, sc_sl, sc_sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paddle_tpu_torch

// #4. q [B, H, D] with element strides (innermost 1); k/v [B, L, H, D]
// with shared element strides (batch kv_sb, row kv_sl, head kv_sh;
// innermost 1), each a multiple of 8, 16-byte-aligned bases; pos [B] int32
// >= 0 (the live count is clamped to L); o [B, H, D] contiguous f32.
// Returns the launch's cudaError_t.
extern "C" int paddle_decode_attention(
    const void* q, const void* k, const void* v, const int* pos, float* o,
    int B, int H, int D, int L, int64_t q_sb, int64_t q_sh, int64_t kv_sb,
    int64_t kv_sl, int64_t kv_sh, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (D != decode::kD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, pos, o, B, H, L, q_sb, q_sh, kv_sb, kv_sl,
                         kv_sh, scale, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, pos, o, B, H, L, q_sb, q_sh, kv_sb,
                                 kv_sl, kv_sh, scale, st);
  return (int)cudaErrorInvalidValue;
}

// #5. As #4 over an int8 cache k/v [B, L, H, D] (strides as #4's) with f32
// scales k_scale/v_scale [B, L, H] sharing element strides (sc_sb, sc_sl,
// sc_sh); q f32 or bf16 (``q_dtype``).
extern "C" int paddle_decode_attention_q(
    const void* q, const int8_t* k, const float* k_scale, const int8_t* v,
    const float* v_scale, const int* pos, float* o, int B, int H, int D,
    int L, int64_t q_sb, int64_t q_sh, int64_t kv_sb, int64_t kv_sl,
    int64_t kv_sh, int64_t sc_sb, int64_t sc_sl, int64_t sc_sh, float scale,
    int q_dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (D != decode::kD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_q<float>(q, k, k_scale, v, v_scale, pos, o, B, H, L, q_sb,
                           q_sh, kv_sb, kv_sl, kv_sh, sc_sb, sc_sl, sc_sh,
                           scale, st);
  if (q_dtype == kBF16)
    return launch_q<__nv_bfloat16>(q, k, k_scale, v, v_scale, pos, o, B, H,
                                   L, q_sb, q_sh, kv_sb, kv_sl, kv_sh, sc_sb,
                                   sc_sl, sc_sh, scale, st);
  return (int)cudaErrorInvalidValue;
}
