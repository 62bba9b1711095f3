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
// run one softmax; here nothing is assembled. Both reads launch the split
// body of the dense reads #4 and #5 (decode_attn.cuh decode_split_kernel)
// over the paged row loaders (PagedRows, PagedRowsQ): the NB*bs rows of a
// sample's table are split into the wrapper's chunks (ops/cuda_kernels.py
// decode_splits), each block walks the live rows of its chunk, and the
// last block of an (h, b) merges the chunks. An int8 row is dequantized as
// it is loaded. Rows past pos — including every row of the null page, and
// every row past NB*bs — are never read. A row group carries its page's
// table entry across the page's rows (TableRows), so a row's address
// waits on no load of the table.
#include "decode_attn.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace decode;

// The page pools, as a kernel argument: rows<kPer>(b, h, lane) is the row
// loader of one (b, h) read, for this lane's chunks.
template <typename T, bool kCarry>
struct PagedCache {                    // #6: pools [P, bs, H, D] of T
  const T* k_pool;
  const T* v_pool;
  const int* tables;                   // [B, NB]
  int bs, NB, H, D;
  template <int kPer>
  __device__ __forceinline__ PagedRows<kPer, T, kCarry> rows(
      int b, int h, Lane ln) const {
    return {k_pool, v_pool,
            TableRows<kCarry>{tables + static_cast<int64_t>(b) * NB, bs, NB,
                              H, h},
            D, ln};
  }
};

template <bool kCarry>
struct PagedCacheQ {                   // #7: int8 pools, f32 scale pools
  const int8_t* k_pool;
  const int8_t* v_pool;
  const float* ks_pool;
  const float* vs_pool;
  const int* tables;
  int bs, NB, H, D;
  template <int kPer>
  __device__ __forceinline__ PagedRowsQ<kPer, kCarry> rows(int b, int h,
                                                           Lane ln) const {
    return {k_pool, v_pool, ks_pool, vs_pool,
            TableRows<kCarry>{tables + static_cast<int64_t>(b) * NB, bs, NB,
                              H, h},
            D, ln};
  }
};

template <typename T, bool kCarry>
int launch_paged(const void* q, const void* k_pool, const void* v_pool,
                 const int* tables, const int* pos, float* o, float* part,
                 int* tickets, int B, int H, int D, int bs, int NB,
                 int splits, int chunk, int64_t q_sb, int64_t q_sh,
                 float scale, cudaStream_t st) {
  const PagedCache<T, kCarry> c{static_cast<const T*>(k_pool),
                                static_cast<const T*>(v_pool), tables, bs,
                                NB, H, D};
  return launch<T>(q, c, pos, o, part, tickets, B, H, D, NB * bs, splits,
                   chunk, q_sb, q_sh, scale, st);
}

template <typename TQ, bool kCarry>
int launch_paged_q(const void* q, const int8_t* k_pool, const float* k_scale,
                   const int8_t* v_pool, const float* v_scale,
                   const int* tables, const int* pos, float* o, float* part,
                   int* tickets, int B, int H, int D, int bs, int NB,
                   int splits, int chunk, int64_t q_sb, int64_t q_sh,
                   float scale, cudaStream_t st) {
  const PagedCacheQ<kCarry> c{k_pool, v_pool, k_scale, v_scale, tables, bs,
                              NB, H, D};
  return launch<TQ>(q, c, pos, o, part, tickets, B, H, D, NB * bs, splits,
                    chunk, q_sb, q_sh, scale, st);
}

}  // namespace
}  // namespace paddle_tpu_torch

// #6. q [B, H, D] (D a multiple of 8 up to 128) with element strides
// (innermost 1); k_pool/v_pool
// [P, bs, H, D] contiguous and 16-byte aligned; tables [B, NB] int32
// contiguous, every entry in [0, P); pos [B] int32 >= 0 (rows past NB*bs
// are not read); o [B, H, D] contiguous f32. ``splits`` chunks of ``chunk``
// rows cover [0, NB*bs), with part and tickets as paddle_decode_attention
// takes them. ``carry`` 1: each row group carries its page's table entry
// (the read's design); 0: every row looks its entry up (the one-block
// body's loader, kept for chip_smoke.py's comparison). Returns the
// launch's cudaError_t.
extern "C" int paddle_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* pos, float* o, float* part, int* tickets, int B, int H, int D,
    int bs, int NB, int splits, int chunk, int carry, int64_t q_sb,
    int64_t q_sh, float scale, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::decode;
  if (bs < 1 || NB < 1 ||
      bad_split(D, static_cast<int64_t>(NB) * bs, splits, chunk, part,
                tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto run) {
    return run(q, k_pool, v_pool, tables, pos, o, part, tickets, B, H, D,
               bs, NB, splits, chunk, q_sb, q_sh, scale, st);
  };
  if (dtype == kF32)
    return carry ? go(launch_paged<float, true>)
                 : go(launch_paged<float, false>);
  if (dtype == kBF16)
    return carry ? go(launch_paged<__nv_bfloat16, true>)
                 : go(launch_paged<__nv_bfloat16, false>);
  return (int)cudaErrorInvalidValue;
}

// #7. As #6 over int8 pools [P, bs, H, D] (contiguous, 16-byte aligned)
// with f32 scale pools [P, bs, H] (contiguous); q f32 or bf16 (``q_dtype``).
extern "C" int paddle_paged_decode_attention_q(
    const void* q, const int8_t* k_pool, const float* k_scale,
    const int8_t* v_pool, const float* v_scale, const int* tables,
    const int* pos, float* o, float* part, int* tickets, int B, int H, int D,
    int bs, int NB, int splits, int chunk, int carry, int64_t q_sb,
    int64_t q_sh, float scale, int q_dtype, void* stream) {
  using namespace paddle_tpu_torch;
  using namespace paddle_tpu_torch::decode;
  if (bs < 1 || NB < 1 ||
      bad_split(D, static_cast<int64_t>(NB) * bs, splits, chunk, part,
                tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto run) {
    return run(q, k_pool, k_scale, v_pool, v_scale, tables, pos, o, part,
               tickets, B, H, D, bs, NB, splits, chunk, q_sb, q_sh, scale,
               st);
  };
  if (q_dtype == kF32)
    return carry ? go(launch_paged_q<float, true>)
                 : go(launch_paged_q<float, false>);
  if (q_dtype == kBF16)
    return carry ? go(launch_paged_q<__nv_bfloat16, true>)
                 : go(launch_paged_q<__nv_bfloat16, false>);
  return (int)cudaErrorInvalidValue;
}
