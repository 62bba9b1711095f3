// Paged decode attention for Hopper (sm_90a): kernels #6 and #7.
//
// Replaces the TPU kernels _paged_attn_kernel (#6) and _paged_attn_q_kernel
// (#7) of paddle_tpu/ops/pallas_kernels.py (called by
// paged_decode_attention): one query token per sample reads its KV cache
// through a block table — pools [P, bs, H, D] (f32 or bf16; for #7 int8
// with f32 scale pools [P, bs, H]), tables [B, NB] (entries past the live
// pages name the null page 0), rows j <= pos[b] live — with an f32 softmax
// and an f32 output [B, H, D].
//
// Bound by bytes, like every decode read (decode_attn.cuh). The TPU kernels
// assemble every page of a sample in VMEM (dequantized, for #7) and then
// run one softmax; here nothing is assembled: one block per (h, b) reads
// its own table entries and walks only the live rows with the shared row
// walk of decode_attn.cuh, dequantizing an int8 row as it loads it. Rows
// past pos — including every row of the null page — are never read.
#include "decode_attn.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace decode;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, float* __restrict__ o,
                    int H, int bs, int NB, int64_t q_sb, int64_t q_sh,
                    float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = (threadIdx.x % kLanesPerRow) * kE;
  const PagedRows<T> rows{k_pool, v_pool,
                          tables + static_cast<int64_t>(b) * NB, bs, H, h,
                          lane};
  row_walk(q + b * q_sb + h * q_sh + lane, scale, min(pos[b] + 1, NB * bs),
           rows, o + (static_cast<int64_t>(b) * H + h) * kD);
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_decode_q_kernel(const TQ* __restrict__ q,
                      const int8_t* __restrict__ k_pool,
                      const float* __restrict__ k_scale,
                      const int8_t* __restrict__ v_pool,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,
                      const int* __restrict__ pos, float* __restrict__ o,
                      int H, int bs, int NB, int64_t q_sb, int64_t q_sh,
                      float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = (threadIdx.x % kLanesPerRow) * kE;
  const PagedRowsQ rows{k_pool, v_pool, k_scale, v_scale,
                        tables + static_cast<int64_t>(b) * NB, bs, H, h,
                        lane};
  row_walk(q + b * q_sb + h * q_sh + lane, scale, min(pos[b] + 1, NB * bs),
           rows, o + (static_cast<int64_t>(b) * H + h) * kD);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* pos, float* o, int B, int H, int bs,
           int NB, int64_t q_sb, int64_t q_sh, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, pos, o, H, bs, NB, q_sb, q_sh,
      scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(const void* q, const int8_t* k_pool, const float* k_scale,
             const int8_t* v_pool, const float* v_scale, const int* tables,
             const int* pos, float* o, int B, int H, int bs, int NB,
             int64_t q_sb, int64_t q_sh, float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_decode_q_kernel<TQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), k_pool, k_scale, v_pool, v_scale, tables,
      pos, o, H, bs, NB, q_sb, q_sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paddle_tpu_torch

// #6. q [B, H, D] with element strides (innermost 1); k_pool/v_pool
// [P, bs, H, D] contiguous and 16-byte aligned; tables [B, NB] int32
// contiguous, every entry in [0, P); pos [B] int32 >= 0 (rows past NB*bs
// are not read); o [B, H, D] contiguous f32. Returns the launch's
// cudaError_t.
extern "C" int paddle_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* pos, float* o, int B, int H, int D, int bs, int NB,
    int64_t q_sb, int64_t q_sh, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (D != decode::kD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k_pool, v_pool, tables, pos, o, B, H, bs, NB,
                         q_sb, q_sh, scale, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, pos, o, B, H, bs,
                                 NB, q_sb, q_sh, scale, st);
  return (int)cudaErrorInvalidValue;
}

// #7. As #6 over int8 pools [P, bs, H, D] (contiguous, 16-byte aligned)
// with f32 scale pools [P, bs, H] (contiguous); q f32 or bf16 (``q_dtype``).
extern "C" int paddle_paged_decode_attention_q(
    const void* q, const int8_t* k_pool, const float* k_scale,
    const int8_t* v_pool, const float* v_scale, const int* tables,
    const int* pos, float* o, int B, int H, int D, int bs, int NB,
    int64_t q_sb, int64_t q_sh, float scale, int q_dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (D != decode::kD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_q<float>(q, k_pool, k_scale, v_pool, v_scale, tables, pos,
                           o, B, H, bs, NB, q_sb, q_sh, scale, st);
  if (q_dtype == kBF16)
    return launch_q<__nv_bfloat16>(q, k_pool, k_scale, v_pool, v_scale,
                                   tables, pos, o, B, H, bs, NB, q_sb, q_sh,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}
