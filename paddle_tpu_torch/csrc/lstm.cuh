// Shared parts of the LSTM sequence kernels (lstm_seq.cu, lstm_seq_bwd.cu):
// the grid partition, the thread layout, row staging and the gate
// computation, so that the backward recomputes exactly the gates the
// forward computed.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace paddle_tpu_torch {
namespace lstm {

namespace cg = cooperative_groups;

// Block (x, y) owns hidden units [x*kUnits, (x+1)*kUnits) -- the gate
// columns g*H + unit of those units for g = i, f, g, o -- for batch rows
// [y*kRows, (y+1)*kRows).
constexpr int kUnits = 4;
constexpr int kRows = 32;
// A thread computes kRowsPer rows x 4 gates of one unit over every
// kSplit-th k of a product; the kSplit threads of one (row group, unit)
// are neighbouring lanes and sum their partials with shuffles. Reusing
// each loaded U value for kRowsPer rows and each h value for 4 gates is
// what keeps the product off the shared-memory bandwidth limit.
constexpr int kRowsPer = 4;
constexpr int kSplit = 8;
constexpr int kThreads = (kRows / kRowsPer) * kUnits * kSplit;  // 256
// padding of a staged row, in floats (16-byte aligned rows)
constexpr int kPad = 4;
// loads a thread keeps in flight while staging rows
constexpr int kBatch = 8;

// the C entries' answer when the grid does not fit in one wave of the
// card or a block's shared memory exceeds the limit (rnn_kernels.py
// reads it): a grid barrier needs every block resident
constexpr int kTooLarge = 720;  // cudaErrorCooperativeLaunchTooLarge

// Where a thread sits: row group rg (rows rg*kRowsPer ...), unit u of the
// block, k-slice ks. Lane ks < kRowsPer owns row rg*kRowsPer + ks of unit
// u: it keeps that (row, unit)'s state in registers and does its
// elementwise work; every (row, unit) of the block has one owner.
struct Lane {
  int rg, u, ks;
  __device__ Lane()
      : rg(threadIdx.x / (kSplit * kUnits)),
        u((threadIdx.x / kSplit) % kUnits),
        ks(threadIdx.x % kSplit) {}
  __device__ bool owner() const { return ks < kRowsPer; }
  __device__ int row() const { return rg * kRowsPer + ks; }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// four consecutive elements as f32, read past L1 (the exchange buffers
// are written by other blocks during the kernel, and L1 is not coherent)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows b0 .. b0+kRows-1 (row b at src + b*stride, `width` elements, a
// multiple of 4) into dst[r*ld + k] as f32; rows past B are zero. Each
// thread issues kBatch loads before it stores any, so the latency of
// L2 is paid once per batch, not once per load.
template <typename S>
__device__ __forceinline__ void stage_rows(const S* src, int64_t stride,
                                           int b0, int B, int width,
                                           float* dst, int ld) {
  const int n4 = width / 4, total = kRows * n4;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * kThreads;
      const int r = idx / n4, k = (idx % n4) * 4;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && b0 + r < B)
        v[i] = load4(src + static_cast<int64_t>(b0 + r) * stride + k);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * kThreads;
      if (idx < total)
        *reinterpret_cast<float4*>(dst + (idx / n4) * ld + (idx % n4) * 4) =
            v[i];
    }
  }
}

// U's gate columns of the block's units as f32: uc[k*kUnits + u] holds
// U[k, g*H + j0 + u] for g = i, f, g, o, so one 16-byte load gives a
// thread its four gates' weights for one k.
template <typename DT>
__device__ __forceinline__ void stage_u_cols(const DT* u, int H, int j0,
                                             float4* uc) {
  const int64_t G = 4 * H;
  for (int idx = threadIdx.x; idx < H * kUnits; idx += blockDim.x) {
    const int k = idx / kUnits, col = j0 + idx % kUnits;
    const DT* row = u + k * G + col;
    uc[idx] = make_float4(to_f32(row[0]), to_f32(row[H]), to_f32(row[2 * H]),
                          to_f32(row[3 * H]));
  }
}

// Sum v over the kSplit lanes of a (row group, unit): they differ in the
// low bits of the lane index, so a butterfly over those bits leaves the
// sum in all of them.
__device__ __forceinline__ float split_sum(float v) {
#pragma unroll
  for (int off = kSplit / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// h_{t-1} @ U for the owner's (row, unit): the four gates' dot products
// over k, from the staged f32 rows `hs` (row stride ld) and `uc`. Every
// thread of the block must call it (the sums are warp shuffles); the
// result is meaningful in owner lanes.
__device__ __forceinline__ float4 gate_dot(const float* hs, int ld,
                                           const float4* uc, int H,
                                           const Lane& l) {
  float acc[kRowsPer][4];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
  const float* h = hs + l.rg * kRowsPer * ld;
  for (int k = l.ks; k < H; k += kSplit) {
    const float4 w = uc[k * kUnits + l.u];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const float hv = h[i * ld + k];
      acc[i][0] = fmaf(hv, w.x, acc[i][0]);
      acc[i][1] = fmaf(hv, w.y, acc[i][1]);
      acc[i][2] = fmaf(hv, w.z, acc[i][2]);
      acc[i][3] = fmaf(hv, w.w, acc[i][3]);
    }
  }
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const float4 s = make_float4(split_sum(acc[i][0]), split_sum(acc[i][1]),
                                 split_sum(acc[i][2]), split_sum(acc[i][3]));
    if (i == l.ks) out = s;
  }
  return out;
}

// The four gates of xw[b, t, unit] (the gate columns are H apart) as f32.
template <typename DT>
__device__ __forceinline__ float4 load_gates(const DT* xw_row, int H) {
  return make_float4(to_f32(xw_row[0]), to_f32(xw_row[H]),
                     to_f32(xw_row[2 * H]), to_f32(xw_row[3 * H]));
}

struct Gates {
  float i, f, g, o;
};

// The activations in the op order of the JAX kernel body:
// gates = xw_t + h_{t-1} @ U + b, forget_bias added to f before the
// sigmoid. `xw` and `bias` hold the unit's four gates, `dot` the product.
__device__ __forceinline__ Gates activate(float4 xw, float4 dot, float4 bias,
                                          float forget_bias) {
  Gates q;
  q.i = sigmoid((xw.x + dot.x) + bias.x);
  q.f = sigmoid((xw.y + dot.y) + bias.y + forget_bias);
  q.g = tanhf((xw.z + dot.z) + bias.z);
  q.o = sigmoid((xw.w + dot.w) + bias.w);
  return q;
}

template <typename DT>
__device__ __forceinline__ float4 unit_bias(const DT* b, int H, int unit) {
  return make_float4(to_f32(b[unit]), to_f32(b[H + unit]),
                     to_f32(b[2 * H + unit]), to_f32(b[3 * H + unit]));
}

// Launch `kernel` cooperatively on grid (H / kUnits, ceil(B / kRows)),
// after checking that the grid fits in one wave at `smem` bytes of
// dynamic shared memory. Returns a cudaError_t (kTooLarge if it does not
// fit).
template <typename Kernel>
int launch_cooperative(Kernel kernel, int B, int H, size_t smem,
                       void** args, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > static_cast<size_t>(optin)) return kTooLarge;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / kUnits, (B + kRows - 1) / kRows);
  if (static_cast<long>(grid.x) * grid.y > static_cast<long>(per_sm) * sms)
    return kTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    grid, dim3(kThreads), args, smem, stream);
  return (int)err;
}

}  // namespace lstm
}  // namespace paddle_tpu_torch
