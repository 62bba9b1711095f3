// Shared parts of the GRU sequence kernels (gru_seq.cu, gru_seq_bwd.cu).
//
// The GRU forward takes the LSTM kernels' grid partition and helpers
// (lstm.cuh): block (x, y) owns hidden units [x*kUnits, (x+1)*kUnits) for
// batch rows [y*kRows, (y+1)*kRows), 256 threads laid out as Lane says,
// rows staged as f32 with stage_rows, products split over kSplit lanes
// and summed with split_sum. Both kernels take the cooperative launch
// that checks the whole grid is resident, and the kTooLarge answer (the
// backward gives a block twice the units, gru_seq_bwd.cu). What differs
// is the gate layout (z, r, candidate; U packed [u_z | u_r | u_c]) and
// that a GRU step needs two exchanges across the grid: the candidate
// reads (r*h) @ u_c over all H units.
#pragma once

#include "lstm.cuh"

namespace paddle_tpu_torch {
namespace gru {

namespace cg = cooperative_groups;
using lstm::kPad;
using lstm::kRows;
using lstm::kRowsPer;
using lstm::kSplit;
using lstm::kThreads;
using lstm::kTooLarge;
using lstm::kUnits;
using lstm::Lane;
using lstm::launch_cooperative;
using lstm::sigmoid;
using lstm::split_sum;
using lstm::stage_rows;

// The GRU forward is compiled for two blocks an SM: at the bench shape
// (B = 64, H = 512) its grid is 128 x 2 = 256 blocks on 132 SMs.
constexpr int kMinBlocks = 2;

// Gate columns g0 .. g0+NG-1 of U (each H wide) for the block's units, as
// f32: w[(k*kUnits + u)*NG + g] = U[k, (g0+g)*H + j0 + u].
template <int NG, typename DT>
__device__ __forceinline__ void stage_cols(const DT* u, int H, int j0, int g0,
                                           float* w) {
  const int64_t G = 3 * static_cast<int64_t>(H);
  for (int idx = threadIdx.x; idx < H * kUnits * NG; idx += blockDim.x) {
    const int g = idx % NG, u_ = (idx / NG) % kUnits, k = idx / (NG * kUnits);
    w[idx] = to_f32(u[k * G + static_cast<int64_t>(g0 + g) * H + j0 + u_]);
  }
}

template <int NG>
struct Dots {
  float v[NG];
};

// The owner's (row, unit) products of the staged f32 rows `hs` (row stride
// ld, H wide) with NG gate columns staged by stage_cols. Every thread of
// the block must call it (the sums are warp shuffles); the result is
// meaningful in owner lanes.
template <int NG>
__device__ __forceinline__ Dots<NG> cols_dot(const float* hs, int ld,
                                             const float* w, int H,
                                             const Lane& l) {
  float acc[kRowsPer][NG];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[i][g] = 0.f;
  const float* h = hs + l.rg * kRowsPer * ld;
  for (int k = l.ks; k < H; k += kSplit) {
    float wv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) wv[g] = w[(k * kUnits + l.u) * NG + g];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const float hv = h[i * ld + k];
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[i][g] = fmaf(hv, wv[g], acc[i][g]);
    }
  }
  Dots<NG> out;
#pragma unroll
  for (int g = 0; g < NG; ++g) out.v[g] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float s = split_sum(acc[i][g]);
      if (i == l.ks) out.v[g] = s;
    }
  return out;
}

}  // namespace gru
}  // namespace paddle_tpu_torch
