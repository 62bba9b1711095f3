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
// not fit one SM (3 MB in f32 at H = 512), with a grid barrier after each.
// The TPU kernel keeps U resident in VMEM and loops over T inside one
// program; here U is split across the blocks of one cooperative grid, and
// each product first waits for its rows of the exchanged state from L2:
// those waits, the two barriers and the FMAs bound a step.
//
// Design (recur.cuh): block (x, y) owns UNITS hidden units -- the 3*UNITS
// gate columns of U, kept in shared memory as f32 -- for `rows` batch rows,
// a plan chosen by ops/rnn_kernels.py forward_plan from B, H and the card
// (8 units x 32 rows at B = 64, H = 512: 128 blocks of 256 threads, an SM
// each). Before the loop the owners write h0 to the exchange h_x. A step:
// each warp reads its 4 rows of h_{t-1} from h_x straight into registers;
// its half-warps multiply them with u_z and with u_r and reduce-scatter;
// the owner lanes form z and r and write r*h to a second exchange; a grid
// barrier; the same with r*h and u_c (the half-warps split the units),
// the owners form c and h', write h to h_x and ask L2 for the next step's
// xw (a prefetch, not a load: the barrier's fence would wait for a load);
// a grid barrier. Each exchange is read and rewritten on opposite sides
// of a barrier, so neither is double-buffered. Rows past their length are
// not read, warps whose rows are all dead skip the product, and the loop
// ends at the longest length; the owners write the frozen steps' zeros
// last.
#include "lstm.cuh"
#include "recur.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace recur;
using lstm::sigmoid;

// rows a warp takes
constexpr int kRL = 4;

template <typename DT, int UNITS, bool kWide>
__global__ void __launch_bounds__(kMaxThreads, kWide ? 1 : 2)
gru_seq_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
               const DT* __restrict__ u, const DT* __restrict__ h0,
               DT* __restrict__ out, DT* __restrict__ h_t,
               float* __restrict__ h_x, float* __restrict__ rh_x, int B,
               int T, int H, int parts) {
  using ZR = Prod<2, UNITS, kRL>;
  using C = Prod<1, UNITS, kRL>;
  constexpr int kOwn = ZR::kOwn;        // (row, unit)s a lane owns
  constexpr int kRing = kWide ? 4 : 2;  // column steps in flight
  extern __shared__ float4 smem_f4[];
  float4* us_zr = smem_f4;
  float4* us_c = us_zr + ZR::slots(H);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int pair = warp / parts, rows = blockDim.x / 32 / parts * kRL;
  const int j0 = blockIdx.x * UNITS;
  const int bw = blockIdx.y * rows + pair * kRL;     // the warp's rows
  const KSplit ks{warp % parts, parts, 1 + pair,
                  reinterpret_cast<float*>(us_c + C::slots(H)) + pair * 128};
  const int64_t G = 3 * static_cast<int64_t>(H);
  ZR::stage(u, 3, 0, H, j0, us_zr);
  C::stage(u, 3, 2, H, j0, us_c);
  const int t_max = longest(lens, B, T);
  int wlen[kRL];
#pragma unroll
  for (int r = 0; r < kRL; ++r)
    wlen[r] = bw + r < B ? min(max(lens[bw + r], 0), T) : 0;
  // the lane's (row, unit)s: kOwn neighbouring units of one row (H is a
  // multiple of 4 and the first unit even: all inside or all past H)
  int orow, unit;
  ZR::owned(lane / kHalf, lane % kHalf, 0, orow, unit);
  const int b = bw + orow;
  unit += j0;
  const bool own = ks.part == 0 && b < B && unit < H;
  const int len = own ? min(max(lens[b], 0), T) : 0;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;
  auto xw_at = [&](int t, int g) {
    return xw + (static_cast<int64_t>(b) * T + t) * G + g * H + unit;
  };
  float h[kOwn] = {};
  if (own) {
    load_n<kOwn>(h0 + bh, h);
    store_n<kOwn>(h, h_x + bh);         // step 0 reads h0 from the exchange
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();                          // (the staging of U included)

  for (int t = 0; t < t_max; ++t) {
    bool live[kRL];
#pragma unroll
    for (int r = 0; r < kRL; ++r) live[r] = t < wlen[r];
    const bool mine = own && t < len;
    // z's and r's xw, in flight during the product (in L2 since the step
    // before)
    Raw<kOwn, DT> xz, xr, xc;
    if (mine) {
      xz.load(xw_at(t, 0));
      xr.load(xw_at(t, 1));
    }
    float zr[2][kOwn];
    ZR::template dot<kRing>(zr, h_x + static_cast<int64_t>(bw) * H, live,
                            us_zr, H, ks);
    float z[kOwn], rh[kOwn];
    if (mine) {
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        z[o] = sigmoid(xz[o] + zr[0][o]);
        rh[o] = sigmoid(xr[o] + zr[1][o]) * h[o];
      }
      store_n<kOwn>(rh, rh_x + bh);
    }
    // every live row's r*h is in the exchange after this, and every block
    // is done reading h_x
    grid.sync();
    if (mine) xc.load(xw_at(t, 2));
    float dc[1][kOwn];
    C::template dot<kRing>(dc, rh_x + static_cast<int64_t>(bw) * H, live,
                           us_c, H, ks);
    if (mine) {
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const float c = tanhf(xc[o] + dc[0][o]);
        h[o] = (1.f - z[o]) * h[o] + z[o] * c;
      }
      store_n<kOwn>(h, out + (static_cast<int64_t>(b) * T + t) * H + unit);
      store_n<kOwn>(h, h_x + bh);
    }
    if (own && t + 1 < len)             // the next step's xw into L2
      for (int g = 0; g < 3; ++g) prefetch_l2(xw_at(t + 1, g));
    // orders this step's h writes before the next step's reads, and this
    // step's reads of rh_x before the next step's writes
    if (t + 1 < t_max) grid.sync();
  }
  if (own) {
    float zero[kOwn];
#pragma unroll
    for (int o = 0; o < kOwn; ++o) zero[o] = 0.f * h[o];  // m * h at m = 0
    for (int t = len; t < T; ++t)
      store_n<kOwn>(zero, out + (static_cast<int64_t>(b) * T + t) * H + unit);
    store_n<kOwn>(h, h_t + bh);
  }
}

template <typename DT, int UNITS>
int launch(const void* xw, const int* lens, const void* u, const void* h0,
           void* out, void* h_t, float* h_x, float* rh_x, int B, int T, int H,
           int rows, int parts, cudaStream_t stream) {
  void* args[] = {&xw, &lens, &u,  &h0, &out, &h_t, &h_x,
                  &rh_x, &B,  &T,  &H,  &parts};
  const int threads = 32 * parts * rows / kRL;
  const long blocks = static_cast<long>((H + UNITS - 1) / UNITS) *
                      ((B + rows - 1) / rows);
  const size_t smem = fwd_smem_bytes(3, H, UNITS) +
                      (parts == 2 ? threads / 64 * kPairBytes : 0);
  auto go = [&](auto kernel) {
    return lstm::launch_cooperative(kernel, B, H, smem, args, stream, UNITS,
                                    rows, threads);
  };
  return one_an_sm(blocks) ? go(gru_seq_kernel<DT, UNITS, true>)
                           : go(gru_seq_kernel<DT, UNITS, false>);
}

template <typename DT>
int dispatch(const void* xw, const int* lens, const void* u, const void* h0,
             void* out, void* h_t, float* h_x, float* rh_x, int B, int T,
             int H, int units, int rows, int parts, cudaStream_t stream) {
  if (units == 8)
    return launch<DT, 8>(xw, lens, u, h0, out, h_t, h_x, rh_x, B, T, H, rows,
                         parts, stream);
  return launch<DT, 16>(xw, lens, u, h0, out, h_t, h_x, rh_x, B, T, H, rows,
                        parts, stream);
}

}  // namespace
}  // namespace paddle_tpu_torch

// xw [B, T, 3H] (bias added); lens [B] int32; u [H, 3H]; h0 [B, H]; out
// [B, T, H]; h_t [B, H]: contiguous, 16-byte aligned, all of the one dtype
// `dtype` (f32 or bf16) but lens. h_x and rh_x are f32 scratch [B, H]. H a
// multiple of 4; the plan: `units` (8 or 16) hidden units x `rows` (8, 16
// or 32) batch rows a block, `parts` (1 or 2) warps a row group sharing k
// (recur.cuh KSplit). Returns the launch's cudaError_t, or 720 when
// the grid does not fit in one wave or a block's shared memory exceeds the
// limit.
extern "C" int paddle_gru_seq(const void* xw, const int* lens, const void* u,
                              const void* h0, void* out, void* h_t,
                              float* h_x, float* rh_x, int B, int T, int H,
                              int units, int rows, int parts, int dtype,
                              void* stream) {
  using namespace paddle_tpu_torch;
  if (H % 4 != 0 || B <= 0 || T <= 0 ||
      !recur::plan_taken(units, rows, parts, kRL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(xw, lens, u, h0, out, h_t, h_x, rh_x, B, T, H,
                           units, rows, parts, st);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(xw, lens, u, h0, out, h_t, h_x, rh_x, B, T,
                                   H, units, rows, parts, st);
  return (int)cudaErrorInvalidValue;
}
