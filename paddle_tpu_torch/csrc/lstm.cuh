// Shared parts of the recurrent kernels: the LSTM backward's grid
// partition and thread layout (lstm_seq_bwd.cu), the gate activations, so
// that the backward recomputes exactly the gates the forward (lstm_seq.cu)
// computed, and the cooperative launch of all five recurrent kernels.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace paddle_tpu_torch {
namespace lstm {

namespace cg = cooperative_groups;

// Block (x, y) of the LSTM backward owns hidden units [x*kUnits,
// (x+1)*kUnits) -- the gate columns g*H + unit of those units for g = i,
// f, g, o -- for batch rows [y*kRows, (y+1)*kRows).
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

// Launch `kernel` cooperatively on grid (ceil(H / units), ceil(B / rows))
// of `threads` a block, after checking that the grid fits in one wave at
// `smem` bytes of dynamic shared memory. Returns a cudaError_t (kTooLarge
// if it does not fit).
template <typename Kernel>
int launch_cooperative(Kernel kernel, int B, int H, size_t smem,
                       void** args, cudaStream_t stream,
                       int units = kUnits, int rows = kRows,
                       int threads = kThreads) {
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
        &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + units - 1) / units, (B + rows - 1) / rows);
  if (static_cast<long>(grid.x) * grid.y > static_cast<long>(per_sm) * sms)
    return kTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    grid, dim3(threads), args, smem, stream);
  return (int)err;
}

}  // namespace lstm
}  // namespace paddle_tpu_torch
