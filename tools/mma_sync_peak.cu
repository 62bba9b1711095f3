// The rate at which this card runs warp-level tensor-core products
// (mma.sync), the instruction the f32 flash-backward bodies are built on
// (paddle_tpu_torch/csrc/tf32x3.cuh): TF32 m16n8k8 and, for scale, bf16
// m16n8k16. Each warp runs independent accumulators back to back on
// register operands, so nothing but the tensor pipe and the issue of the
// instructions limits it; the best figure over 1, 2 and 4 blocks of four
// warps an SM is the ceiling of a kernel built on mma.sync.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_peak \
//       tools/mma_sync_peak.cu && ./mma_sync_peak
//
// Prints one line per (instruction, blocks an SM) with TF/s (dense, two
// operations a multiply-add), timed by CUDA events over one launch.
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdio>

namespace {

constexpr int kAcc = 8;          // independent accumulators a warp
constexpr int kThreads = 128;
constexpr int kIters = 4096;

__global__ void tf32_loop(float* out, int iters) {
  float d[kAcc][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < kAcc; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void bf16_loop(float* out, int iters) {
  float d[kAcc][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + threadIdx.x + i;
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < kAcc; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int run(const char* name, void (*kernel)(float*, int), double flops,
        int sms, int per_sm) {
  const int blocks = sms * per_sm;
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * kThreads) != cudaSuccess)
    return 1;
  kernel<<<blocks, kThreads>>>(out, 16);          // warm-up
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  kernel<<<blocks, kThreads>>>(out, kIters);
  cudaEventRecord(end);
  if (cudaEventSynchronize(end) != cudaSuccess) return 1;
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, end);
  const double mmas = double(blocks) * (kThreads / 32) * kIters * kAcc;
  std::printf("%s: %d blocks of %d threads an SM: %.1f TF/s\n", name,
              per_sm, kThreads, mmas * flops / (ms * 1e9));
  cudaFree(out);
  return cudaGetLastError() != cudaSuccess;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    std::fprintf(stderr, "mma_sync_peak: no CUDA device\n");
    return 2;
  }
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  int bad = 0;
  for (int per_sm : {1, 2, 4}) {
    bad |= run("mma.sync m16n8k8 tf32", tf32_loop, 2.0 * 16 * 8 * 8,
               prop.multiProcessorCount, per_sm);
    bad |= run("mma.sync m16n8k16 bf16", bf16_loop, 2.0 * 16 * 8 * 16,
               prop.multiProcessorCount, per_sm);
  }
  return bad;
}
