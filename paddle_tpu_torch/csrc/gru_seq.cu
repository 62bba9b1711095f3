// Masked GRU over a whole sequence for Hopper (sm_90a).
//
// Replaces the TPU kernel _gru_seq_kernel (paddle_tpu/ops/pallas_kernels.py,
// called by gru_sequence_fused): from xw = x@W + b [B, T, 3H] (the bias is
// added before the kernel), lengths [B], U [H, 3H] packed [u_z | u_r | u_c]
// and h0 [B, H], run T steps of
//   z = sigmoid(xz + h @ u_z), r = sigmoid(xr + h @ u_r),
//   c = tanh(xc + (r*h) @ u_c), h' = (1-z) h + z c,
// freezing sample b's state for t >= lengths[b]; write out [B, T, H] (0 at
// frozen steps) and hT [B, H]. Arithmetic in f32, stores in the I/O dtype,
// h carried in f32 across all T steps.
//
// What bounds it on the H100: the recurrence. Each step's gates need all of
// h_{t-1}, and the candidate needs r*h_{t-1} of all units, so a step is two
// dependent products (2*B*H*2H, then 2*B*H*H operations) on a U that does
// not fit one SM (3 MB in f32 at H = 512). The TPU kernel keeps U resident
// in VMEM and loops over T inside one program; here U is split across
// blocks instead.
//
// Design: the LSTM kernels' cooperative grid (lstm.cuh, gru.cuh), block
// (x, y) owning kUnits hidden units -- the 3*kUnits gate columns of U,
// kept in shared memory as f32 -- for kRows batch rows. A step: stage h of
// the block's rows (all H units) from an f32 exchange in global memory,
// compute z and r of the block's units, write r*h to a second exchange,
// meet at a grid barrier; stage r*h of all units, compute c and h', write
// h to the first exchange, meet at a second barrier. Two barriers a step
// (the LSTM needs one). With two barriers each exchange is read and
// rewritten on opposite sides of a barrier, so neither is double-buffered.
// Tensor cores, clusters with distributed shared memory in place of the
// global exchanges, and skipping steps past the longest length are later
// work.
#include "gru.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace gru;

__host__ __device__ inline size_t fwd_smem_bytes(int H) {
  return static_cast<size_t>(H) * kUnits * 3 * sizeof(float) +
         static_cast<size_t>(kRows) * (H + kPad) * sizeof(float);
}

template <typename DT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gru_seq_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
               const DT* __restrict__ u, const DT* __restrict__ h0,
               DT* __restrict__ out, DT* __restrict__ h_t,
               float* __restrict__ h_x, float* __restrict__ rh_x, int B,
               int T, int H) {
  extern __shared__ float4 smem[];
  float* wzr = reinterpret_cast<float*>(smem);  // [H][kUnits][2]
  float* wc = wzr + H * kUnits * 2;             // [H][kUnits]
  float* hs = wc + H * kUnits;                  // [kRows][ld]
  const int ld = H + kPad;
  const int64_t G = 3 * static_cast<int64_t>(H);
  const Lane l;
  const int j0 = blockIdx.x * kUnits, b0 = blockIdx.y * kRows;
  const int b = b0 + l.row(), unit = j0 + l.u;
  // the owner lane of each (row, unit) carries its state
  const bool live = l.owner() && b < B;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;

  stage_cols<2>(u, H, j0, 0, wzr);
  stage_cols<1>(u, H, j0, 2, wc);
  float h = 0.f;
  int len = 0;
  if (live) {
    h = to_f32(h0[bh]);
    len = lens[b];
  }
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < T; ++t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    float xz = 0.f, xr = 0.f, xc = 0.f;
    if (live) {  // in flight while the rows are staged
      const DT* x = xw + bt * G + unit;
      xz = to_f32(x[0]);
      xr = to_f32(x[H]);
      xc = to_f32(x[2 * H]);
    }
    // h_{t-1} of the block's rows: h0 at t = 0, else the exchange the
    // previous step wrote (all blocks wrote it before the barrier)
    if (t == 0)
      stage_rows(h0, H, b0, B, H, hs, ld);
    else
      stage_rows(h_x, H, b0, B, H, hs, ld);
    __syncthreads();
    const Dots<2> zr = cols_dot<2>(hs, ld, wzr, H, l);
    float z = 0.f;
    if (live) {
      z = sigmoid(xz + zr.v[0]);
      const float r = sigmoid(xr + zr.v[1]);
      rh_x[bh] = r * h;
    }
    // every block's r*h is in the exchange after this, and every block is
    // done reading h_x and hs
    grid.sync();
    stage_rows(rh_x, H, b0, B, H, hs, ld);
    __syncthreads();
    const Dots<1> dc = cols_dot<1>(hs, ld, wc, H, l);
    if (live) {
      const float c = tanhf(xc + dc.v[0]);
      const float h_new = (1.f - z) * h + z * c;
      const float m = t < len ? 1.f : 0.f;
      h = m * h_new + (1.f - m) * h;
      store_f32(m * h, out + bt * H + unit);
      h_x[bh] = h;
    }
    // orders this step's h writes before the next step's reads, and this
    // step's reads of rh_x and hs before the next step's writes
    if (t + 1 < T) grid.sync();
  }
  if (live) store_f32(h, h_t + bh);
}

template <typename DT>
int launch(const void* xw, const int* lens, const void* u, const void* h0,
           void* out, void* h_t, float* h_x, float* rh_x, int B, int T, int H,
           cudaStream_t stream) {
  void* args[] = {&xw, &lens, &u, &h0, &out, &h_t, &h_x, &rh_x, &B, &T, &H};
  return launch_cooperative(gru_seq_kernel<DT>, B, H, fwd_smem_bytes(H), args,
                            stream);
}

}  // namespace
}  // namespace paddle_tpu_torch

// xw [B, T, 3H] (bias added); lens [B] int32; u [H, 3H]; h0 [B, H]; out
// [B, T, H]; h_t [B, H]: contiguous, 16-byte aligned, all of the one dtype
// `dtype` (f32 or bf16) but lens. h_x and rh_x are f32 scratch [B, H]. H a
// multiple of 4. Returns the launch's cudaError_t, or 720 when the grid
// does not fit in one wave or a block's shared memory exceeds the limit.
extern "C" int paddle_gru_seq(const void* xw, const int* lens, const void* u,
                              const void* h0, void* out, void* h_t,
                              float* h_x, float* rh_x, int B, int T, int H,
                              int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (H % gru::kUnits != 0 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(xw, lens, u, h0, out, h_t, h_x, rh_x, B, T, H, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(xw, lens, u, h0, out, h_t, h_x, rh_x, B, T,
                                 H, st);
  return (int)cudaErrorInvalidValue;
}
