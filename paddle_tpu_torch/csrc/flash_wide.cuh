// The attention bodies at head width 256 (flash_wide.cu), called by the
// C entries of flash_fwd.cu (#1) and flash_bwd.cu (#2, #3) when D = 256.
// Arguments as those entries take them; each returns the launch's
// cudaError_t.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace paddle_tpu_torch {
namespace wide {

constexpr int kD = 256;

int fwd(const void* q, const void* k, const void* v, const int* kv_lens,
        void* o, float* lse, int B, int T, int S, int H, int64_t q_sb,
        int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
        int dtype, cudaStream_t stream);

int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const float* lse, float* delta, const int* kv_lens,
       void* dq, int B, int T, int S, int H, int64_t q_sb, int64_t q_st,
       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
       int64_t v_ss, int64_t v_sh, float scale, int causal,
       int compute_delta, int dtype, cudaStream_t stream);

int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const int* kv_lens, void* dk,
        void* dv, int B, int T, int S, int H, int64_t q_sb, int64_t q_st,
        int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int causal,
        int dtype, cudaStream_t stream);

}  // namespace wide
}  // namespace paddle_tpu_torch
