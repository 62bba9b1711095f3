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
// across the blocks of one cooperative grid: a step is the wait for the
// block's rows of h_{t-1} from L2, the product's FMAs and one grid
// barrier.
//
// Design (recur.cuh): block (x, y) owns UNITS hidden units -- the 4*UNITS
// gate columns of U, kept in shared memory as f32 -- for `rows` batch
// rows, a plan chosen by ops/rnn_kernels.py forward_plan (8 units x 16
// rows at the flagship B = 64, H = 256: 128 blocks of 128 threads, an SM
// each). Before the loop the owners write h0 to slot 0 of a
// double-buffered f32 exchange. Each step a warp reads its rows of h_{t-1}
// straight into registers, its half-warps multiply them with two gates'
// columns each (i, f and g, o), reduce-scatter and trade, so that each
// owner lane holds the four gates of its (row, unit), activates them in
// lstm.cuh's op order, updates h and c in registers, writes out, c_seq
// and h (a warp's owners write neighbouring units of each row together),
// asks L2 for the next step's xw (a prefetch, not a load: the barrier's
// fence would wait for a load) and meets the other blocks at one grid
// barrier. Rows past their length are not read, warps whose rows are all
// dead skip the product, the loop ends at the longest length, and the
// owners write the frozen steps last.
#include "lstm.cuh"
#include "recur.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace recur;
using lstm::activate;
using lstm::Gates;

// rows a warp takes: 4, or 2 at 16 units (64 accumulators a lane)
template <int UNITS>
constexpr int kRL = UNITS == 8 ? 4 : 2;

template <typename DT, int UNITS, bool kSave, bool kWide>
__global__ void __launch_bounds__(kMaxThreads, kWide ? 1 : 2)
lstm_seq_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
                const DT* __restrict__ u, const DT* __restrict__ bias,
                const DT* __restrict__ h0, const DT* __restrict__ c0,
                DT* __restrict__ out, DT* __restrict__ h_t,
                DT* __restrict__ c_t, DT* __restrict__ c_seq,
                float* __restrict__ h_x, int B, int T, int H,
                float forget_bias, int parts) {
  constexpr int RL = kRL<UNITS>;
  using P = Prod<4, UNITS, RL>;
  constexpr int kOwn = P::kOwn;         // (row, unit)s a lane owns: 1
  constexpr int kRing = (kWide ? 16 : 8) / RL;   // column steps in flight
  extern __shared__ float4 us[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int pair = warp / parts, rows = blockDim.x / 32 / parts * RL;
  const int j0 = blockIdx.x * UNITS;
  const int bw = blockIdx.y * rows + pair * RL;      // the warp's rows
  const KSplit ks{warp % parts, parts, 1 + pair,
                  reinterpret_cast<float*>(us + P::slots(H)) + pair * 128};
  const int64_t G = 4 * static_cast<int64_t>(H);
  const int64_t BH = static_cast<int64_t>(B) * H;
  P::stage(u, 4, 0, H, j0, us);
  const int t_max = longest(lens, B, T);
  int wlen[RL];
#pragma unroll
  for (int r = 0; r < RL; ++r)
    wlen[r] = bw + r < B ? min(max(lens[bw + r], 0), T) : 0;
  int orow, unit;
  P::owned(lane / kHalf, lane % kHalf, 0, orow, unit);
  const int b = bw + orow;
  unit += j0;
  const bool own = ks.part == 0 && b < B && unit < H;
  const int len = own ? min(max(lens[b], 0), T) : 0;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;
  auto xw_at = [&](int t) {
    return xw + (static_cast<int64_t>(b) * T + t) * G + unit;
  };
  float h[kOwn] = {}, c[kOwn] = {}, bv[4][kOwn] = {};
  if (own) {
    load_n<kOwn>(h0 + bh, h);
    load_n<kOwn>(c0 + bh, c);
#pragma unroll
    for (int g = 0; g < 4; ++g) load_n<kOwn>(bias + g * H + unit, bv[g]);
    store_n<kOwn>(h, h_x + bh);         // step 0 reads h0 from slot 0
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();                          // (the staging of U included)

  for (int t = 0; t < t_max; ++t) {
    bool live[RL];
#pragma unroll
    for (int r = 0; r < RL; ++r) live[r] = t < wlen[r];
    const bool mine = own && t < len;
    // the four gates' xw, in flight during the product (in L2 since the
    // step before)
    Raw<kOwn, DT> xv[4];
    if (mine)
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g].load(xw_at(t) + g * H);
    float dot[4][kOwn];
    P::template dot<kRing>(
        dot, h_x + (t & 1) * BH + static_cast<int64_t>(bw) * H, live, us, H,
        ks);
    if (mine) {
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const Gates q = activate(
            make_float4(xv[0][o], xv[1][o], xv[2][o], xv[3][o]),
            make_float4(dot[0][o], dot[1][o], dot[2][o], dot[3][o]),
            make_float4(bv[0][o], bv[1][o], bv[2][o], bv[3][o]),
            forget_bias);
        c[o] = q.f * c[o] + q.i * q.g;
        h[o] = q.o * tanhf(c[o]);
      }
      const int64_t bt = static_cast<int64_t>(b) * T + t;
      store_n<kOwn>(h, out + bt * H + unit);
      if (kSave) store_n<kOwn>(c, c_seq + bt * H + unit);
      store_n<kOwn>(h, h_x + ((t + 1) & 1) * BH + bh);
    }
    if (own && t + 1 < len)             // the next step's xw into L2
      for (int g = 0; g < 4; ++g) prefetch_l2(xw_at(t + 1) + g * H);
    // the barrier orders this step's exchange writes before the next
    // step's reads, and this step's reads of its slot before the writes of
    // the step after next
    if (t + 1 < t_max) grid.sync();
  }
  if (own) {
    float zero[kOwn];
#pragma unroll
    for (int o = 0; o < kOwn; ++o) zero[o] = 0.f * h[o];  // m * h at m = 0
    for (int t = len; t < T; ++t) {
      const int64_t bt = static_cast<int64_t>(b) * T + t;
      store_n<kOwn>(zero, out + bt * H + unit);
      if (kSave) store_n<kOwn>(c, c_seq + bt * H + unit);
    }
    store_n<kOwn>(h, h_t + bh);
    store_n<kOwn>(c, c_t + bh);
  }
}

template <typename DT, int UNITS, bool kSave>
int launch(const void* xw, const int* lens, const void* u, const void* b,
           const void* h0, const void* c0, void* out, void* h_t, void* c_t,
           void* c_seq, float* h_x, int B, int T, int H, float forget_bias,
           int rows, int parts, cudaStream_t stream) {
  void* args[] = {&xw,  &lens,  &u,   &b, &h0, &c0, &out,         &h_t,
                  &c_t, &c_seq, &h_x, &B, &T,  &H,  &forget_bias, &parts};
  const int threads = 32 * parts * rows / kRL<UNITS>;
  const long blocks = static_cast<long>((H + UNITS - 1) / UNITS) *
                      ((B + rows - 1) / rows);
  const size_t smem = fwd_smem_bytes(4, H, UNITS) +
                      (parts == 2 ? threads / 64 * kPairBytes : 0);
  auto go = [&](auto kernel) {
    return lstm::launch_cooperative(kernel, B, H, smem, args, stream, UNITS,
                                    rows, threads);
  };
  return one_an_sm(blocks) ? go(lstm_seq_kernel<DT, UNITS, kSave, true>)
                           : go(lstm_seq_kernel<DT, UNITS, kSave, false>);
}

template <bool kSave>
int dispatch(const void* xw, const int* lens, const void* u, const void* b,
             const void* h0, const void* c0, void* out, void* h_t, void* c_t,
             void* c_seq, float* h_x, int B, int T, int H, float forget_bias,
             int units, int rows, int parts, int dtype, void* stream) {
  if (H % 4 != 0 || B <= 0 || T <= 0 ||
      !plan_taken(units, rows, parts, units == 8 ? kRL<8> : kRL<16>))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PADDLE_LSTM_LAUNCH(DT, U)                                           \
  launch<DT, U, kSave>(xw, lens, u, b, h0, c0, out, h_t, c_t, c_seq, h_x, B, \
                       T, H, forget_bias, rows, parts, st)
  if (dtype == kF32)
    return units == 8 ? PADDLE_LSTM_LAUNCH(float, 8)
                      : PADDLE_LSTM_LAUNCH(float, 16);
  if (dtype == kBF16)
    return units == 8 ? PADDLE_LSTM_LAUNCH(__nv_bfloat16, 8)
                      : PADDLE_LSTM_LAUNCH(__nv_bfloat16, 16);
#undef PADDLE_LSTM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paddle_tpu_torch

// xw [B, T, 4H]; lens [B] int32; u [H, 4H]; b [4H]; h0/c0 [B, H]; out
// [B, T, H]; h_t/c_t [B, H]: contiguous, 16-byte aligned, all of the one
// dtype `dtype` (f32 or bf16) but lens. h_x is f32 scratch [2, B, H]. H a
// multiple of 4; the plan: `units` (8 or 16) hidden units x `rows` (8, 16
// or 32) batch rows a block, `parts` (1 or 2) warps a row group sharing k
// (recur.cuh KSplit). Returns the launch's cudaError_t, or 720 when
// the grid does not fit in one wave or a block's shared memory exceeds the
// limit.
extern "C" int paddle_lstm_seq(const void* xw, const int* lens, const void* u,
                               const void* b, const void* h0, const void* c0,
                               void* out, void* h_t, void* c_t, float* h_x,
                               int B, int T, int H, float forget_bias,
                               int units, int rows, int parts, int dtype,
                               void* stream) {
  return paddle_tpu_torch::dispatch<false>(
      xw, lens, u, b, h0, c0, out, h_t, c_t, nullptr, h_x, B, T, H,
      forget_bias, units, rows, parts, dtype, stream);
}

// paddle_lstm_seq plus the post-mask cell sequence c_seq [B, T, H].
extern "C" int paddle_lstm_seq_train(const void* xw, const int* lens,
                                     const void* u, const void* b,
                                     const void* h0, const void* c0,
                                     void* out, void* h_t, void* c_t,
                                     void* c_seq, float* h_x, int B, int T,
                                     int H, float forget_bias, int units,
                                     int rows, int parts, int dtype,
                                     void* stream) {
  return paddle_tpu_torch::dispatch<true>(
      xw, lens, u, b, h0, c0, out, h_t, c_t, c_seq, h_x, B, T, H,
      forget_bias, units, rows, parts, dtype, stream);
}

// The card's SM count and the shared memory a block may opt in to: what
// the wrappers' plans (ops/rnn_kernels.py forward_plan) are made for.
extern "C" int paddle_card_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// The batch rows one block of the LSTM backward owns (its partial dU
// buffer has one [H, 4H] slice per tile of this many rows).
extern "C" int paddle_lstm_batch_tile() {
  return paddle_tpu_torch::lstm::kRows;
}
