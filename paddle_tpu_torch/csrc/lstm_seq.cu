// Masked LSTM over a whole sequence for Hopper (sm_90a): the inference
// forward and, with kSave, the training forward.
//
// Replaces the TPU kernels _lstm_seq_kernel and _lstm_seq_train_kernel
// (paddle_tpu/ops/pallas_kernels.py, called by lstm_sequence_fused): from
// the precomputed xw = x@W [B, T, 4H], lengths [B], U [H, 4H], b [4H] and
// h0/c0 [B, H], run T steps of gates = xw_t + h_{t-1} @ U + b (i, f, g, o;
// forget_bias on f), freezing the state of sample b for t >= lengths[b];
// write out [B, T, H] (0 at frozen steps), hT, cT and, when training, the
// post-mask cell sequence c_seq [B, T, H]. Arithmetic in f32, stores in
// the I/O dtype, h and c carried in f32 across all T steps.
//
// What bounds it on the H100: the recurrence. Each step needs all of
// h_{t-1} before any unit's gates can start, and its product h_{t-1} @ U
// is 2*B*H*4H operations on a U that does not fit one SM (1 MB in f32 at
// H = 256, against 227 KB of shared memory). The TPU kernel keeps U
// resident in VMEM and loops over T inside one program; here U is split
// across blocks instead.
//
// Design: a cooperative grid, block (x, y) owning kUnits hidden units (the
// 4*kUnits gate columns of U, kept in shared memory as f32) for kRows
// batch rows (lstm.cuh). Each step a block stages h_{t-1} of its rows (all
// H units) from a double-buffered f32 exchange in global memory, computes
// its gate tile -- each product split over kSplit lanes, each lane
// reusing a U load for kRowsPer rows -- updates c in the registers of the
// (row, unit)'s owner lane, writes its units' h_t to the exchange and
// meets the other blocks at one grid barrier. The grid must be resident
// at once, which the launch checks. Tensor cores, clusters with
// distributed shared memory in place of the global exchange, and skipping
// steps past the longest length are later work.
#include "lstm.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace lstm;

template <typename DT, bool kSave>
__global__ void __launch_bounds__(kThreads)
lstm_seq_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
                const DT* __restrict__ u, const DT* __restrict__ bias,
                const DT* __restrict__ h0, const DT* __restrict__ c0,
                DT* __restrict__ out, DT* __restrict__ h_t,
                DT* __restrict__ c_t, DT* __restrict__ c_seq,
                float* __restrict__ h_x, int B, int T, int H,
                float forget_bias) {
  extern __shared__ float4 smem[];
  float4* uc = smem;                                        // [H][kUnits]
  float* hs = reinterpret_cast<float*>(smem + H * kUnits);  // [kRows][ld]
  const int ld = H + kPad;
  const int64_t G = 4 * static_cast<int64_t>(H);
  const Lane l;
  const int j0 = blockIdx.x * kUnits, b0 = blockIdx.y * kRows;
  const int b = b0 + l.row(), unit = j0 + l.u;
  // the owner lane of each (row, unit) carries its state
  const bool live = l.owner() && b < B;

  stage_u_cols(u, H, j0, uc);
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  float h = 0.f, c = 0.f;
  int len = 0;
  if (live) {
    bv = unit_bias(bias, H, unit);
    h = to_f32(h0[static_cast<int64_t>(b) * H + unit]);
    c = to_f32(c0[static_cast<int64_t>(b) * H + unit]);
    len = lens[b];
  }
  cg::grid_group grid = cg::this_grid();
  const int64_t bh = static_cast<int64_t>(B) * H;

  for (int t = 0; t < T; ++t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) xv = load_gates(xw + bt * G + unit, H);  // in flight meanwhile
    // h_{t-1} of the block's rows: h0 at t = 0, else the exchange slot
    // the previous step wrote (all blocks wrote it before the barrier)
    if (t == 0)
      stage_rows(h0, H, b0, B, H, hs, ld);
    else
      stage_rows(h_x + (t & 1) * bh, H, b0, B, H, hs, ld);
    __syncthreads();
    const float4 dot = gate_dot(hs, ld, uc, H, l);
    if (live) {
      const Gates q = activate(xv, dot, bv, forget_bias);
      const float c_new = q.f * c + q.i * q.g;
      const float h_new = q.o * tanhf(c_new);
      const float m = t < len ? 1.f : 0.f;
      h = m * h_new + (1.f - m) * h;
      c = m * c_new + (1.f - m) * c;
      store_f32(m * h, out + bt * H + unit);
      if (kSave) store_f32(c, c_seq + bt * H + unit);
      h_x[((t + 1) & 1) * bh + static_cast<int64_t>(b) * H + unit] = h;
    }
    // the barrier orders this step's exchange writes before the next
    // step's reads, and this step's reads of hs before the next staging
    if (t + 1 < T) grid.sync();
  }
  if (live) {
    store_f32(h, h_t + static_cast<int64_t>(b) * H + unit);
    store_f32(c, c_t + static_cast<int64_t>(b) * H + unit);
  }
}

template <typename DT, bool kSave>
int launch(const void* xw, const int* lens, const void* u, const void* b,
           const void* h0, const void* c0, void* out, void* h_t, void* c_t,
           void* c_seq, float* h_x, int B, int T, int H, float forget_bias,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(H) * kUnits * sizeof(float4) +
                      static_cast<size_t>(kRows) * (H + kPad) * sizeof(float);
  void* args[] = {&xw,  &lens, &u,   &b,    &h0, &c0, &out, &h_t,
                  &c_t, &c_seq, &h_x, &B,    &T,  &H,  &forget_bias};
  return launch_cooperative(lstm_seq_kernel<DT, kSave>, B, H, smem, args,
                            stream);
}

template <bool kSave>
int dispatch(const void* xw, const int* lens, const void* u, const void* b,
             const void* h0, const void* c0, void* out, void* h_t, void* c_t,
             void* c_seq, float* h_x, int B, int T, int H, float forget_bias,
             int dtype, void* stream) {
  if (H % kUnits != 0 || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float, kSave>(xw, lens, u, b, h0, c0, out, h_t, c_t, c_seq,
                                h_x, B, T, H, forget_bias, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kSave>(xw, lens, u, b, h0, c0, out, h_t, c_t,
                                        c_seq, h_x, B, T, H, forget_bias, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_tpu_torch

// xw [B, T, 4H]; lens [B] int32; u [H, 4H]; b [4H]; h0/c0 [B, H]; out
// [B, T, H]; h_t/c_t [B, H]: contiguous, 16-byte aligned, all of the one
// dtype `dtype` (f32 or bf16) but lens. h_x is f32 scratch [2, B, H]. H a
// multiple of 4. Returns the launch's cudaError_t, or 720 when the grid
// does not fit in one wave.
extern "C" int paddle_lstm_seq(const void* xw, const int* lens, const void* u,
                               const void* b, const void* h0, const void* c0,
                               void* out, void* h_t, void* c_t, float* h_x,
                               int B, int T, int H, float forget_bias,
                               int dtype, void* stream) {
  return paddle_tpu_torch::dispatch<false>(xw, lens, u, b, h0, c0, out, h_t,
                                           c_t, nullptr, h_x, B, T, H,
                                           forget_bias, dtype, stream);
}

// paddle_lstm_seq plus the post-mask cell sequence c_seq [B, T, H].
extern "C" int paddle_lstm_seq_train(const void* xw, const int* lens,
                                     const void* u, const void* b,
                                     const void* h0, const void* c0,
                                     void* out, void* h_t, void* c_t,
                                     void* c_seq, float* h_x, int B, int T,
                                     int H, float forget_bias, int dtype,
                                     void* stream) {
  return paddle_tpu_torch::dispatch<true>(xw, lens, u, b, h0, c0, out, h_t,
                                          c_t, c_seq, h_x, B, T, H,
                                          forget_bias, dtype, stream);
}

// The batch rows one block of the LSTM kernels owns (the backward's
// partial dU buffer has one [H, 4H] slice per tile of this many rows).
extern "C" int paddle_lstm_batch_tile() {
  return paddle_tpu_torch::lstm::kRows;
}
