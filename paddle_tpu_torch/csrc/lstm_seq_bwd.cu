// Backward of the masked LSTM sequence for Hopper (sm_90a).
//
// Replaces the TPU kernel _lstm_seq_bwd_kernel (paddle_tpu/ops/
// pallas_kernels.py, called by lstm_sequence_fused_bwd): the reverse-time
// recurrence from the forward's residuals (xw, the masked outputs and the
// post-mask cell sequence) and the output cotangents. At each step t, from
// T-1 down to 0, it recomputes the gates from xw_t + h_{t-1} @ U + b, with
// h_{t-1} the saved out[t-1] (h0 at t = 0), forms the gate cotangents
// dgates [B, 4H] (written to dxw in the I/O dtype), adds h_{t-1}^T dgates
// to dU and carries dh_{t-1} = (1-m) dh_t + dgates @ U^T and
// dc_{t-1} = (1-m) dc + dc_t f back, m the step's mask. Returns dxw, dh0,
// dc0 and dU [H, 4H] in f32. dx, dW and db are products outside (ops/rnn.py).
//
// What bounds it on the H100: the recurrence, as in the forward, with
// three products per step instead of one (the gate recompute, dU and
// dh_{t-1}), about 3 x 2*B*H*4H operations.
//
// Design: the forward's cooperative grid and thread layout (lstm.cuh),
// block (x, y) owning kUnits hidden units for kRows batch rows. Per step
// a block stages h_{t-1} of its rows (all H, from `out`, so no exchange is
// needed for the recompute), computes its units' gates and dgates (in
// the owner lanes, which keep dh and dc in registers), writes dgates to a
// double-buffered f32 exchange (f32, not the I/O dtype: dh_{t-1} is
// formed from f32 dgates, as in the JAX kernel) and adds its dU columns
// in shared memory (the block owns those columns, so no atomics). After
// one grid barrier it reads the dgates rows of its batch tile (all 4H
// columns, in chunks) and forms dh_{t-1} for its units from U's rows of
// those units, also in shared memory, the product split over lanes as in
// the forward. With several batch tiles, each tile's dU goes to a partial
// buffer and, after one more barrier, the first tile's blocks sum the
// partials in a fixed order (deterministic).
#include "lstm.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace lstm;

// dgates columns staged per chunk for the dh_{t-1} product
constexpr int kChunk = 256;
constexpr int kCols = 4 * kUnits;      // gate columns a block owns
constexpr int kDuLd = kCols + kPad;    // row stride of the dU accumulator
// row padding of U's rows in shared memory: the 4 units' rows land 8
// banks apart, so the dh product's loads never share a bank
constexpr int kPadU = 8;

struct Smem {
  float4* uc;   // [H][kUnits]   U's gate columns of the block's units
  float* ur;    // [kUnits][4H + kPadU]  U's rows of those units
  float* buf;   // [kRows][max(H, kChunk) + kPad]  h_{t-1} rows / dgates
  float* dgl;   // [kRows][kCols]  this step's dgates of the block
  float* du;    // [H][kDuLd]    the block's dU columns
  int ld_ur, ld_buf;
};

__host__ __device__ inline size_t smem_bytes(int H) {
  const size_t w = H > kChunk ? H : kChunk;
  return static_cast<size_t>(H) * kUnits * sizeof(float4) +
         static_cast<size_t>(kUnits) * (4 * H + kPadU) * sizeof(float) +
         static_cast<size_t>(kRows) * (w + kPad) * sizeof(float) +
         static_cast<size_t>(kRows) * kCols * sizeof(float) +
         static_cast<size_t>(H) * kDuLd * sizeof(float);
}

__device__ inline Smem carve(float4* base, int H) {
  Smem s;
  s.ld_ur = 4 * H + kPadU;
  s.ld_buf = (H > kChunk ? H : kChunk) + kPad;
  s.uc = base;
  s.ur = reinterpret_cast<float*>(base + H * kUnits);
  s.buf = s.ur + kUnits * s.ld_ur;
  s.dgl = s.buf + kRows * s.ld_buf;
  s.du = s.dgl + kRows * kCols;
  return s;
}

template <typename DT>
__global__ void __launch_bounds__(kThreads)
lstm_seq_bwd_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
                    const DT* __restrict__ u, const DT* __restrict__ bias,
                    const DT* __restrict__ h0, const DT* __restrict__ c0,
                    const DT* __restrict__ out, const DT* __restrict__ c_seq,
                    const DT* __restrict__ g_out, const DT* __restrict__ g_ht,
                    const DT* __restrict__ g_ct, DT* __restrict__ dxw,
                    DT* __restrict__ dh0, DT* __restrict__ dc0,
                    float* __restrict__ du, float* __restrict__ dg_x,
                    float* __restrict__ du_part, int B, int T, int H,
                    float forget_bias) {
  extern __shared__ float4 smem[];
  const Smem s = carve(smem, H);
  const int64_t G = 4 * static_cast<int64_t>(H);
  const Lane l;
  const int j0 = blockIdx.x * kUnits, b0 = blockIdx.y * kRows;
  const int r = l.row(), b = b0 + r, unit = j0 + l.u;
  const bool owner = l.owner(), live = owner && b < B;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;

  stage_u_cols(u, H, j0, s.uc);
  for (int idx = threadIdx.x; idx < kUnits * G; idx += blockDim.x) {
    const int row = idx / G, col = idx % G;
    s.ur[row * s.ld_ur + col] = to_f32(u[(j0 + row) * G + col]);
  }
  for (int idx = threadIdx.x; idx < H * kDuLd; idx += blockDim.x)
    s.du[idx] = 0.f;

  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  float dh = 0.f, dc = 0.f;
  int len = 0;
  if (live) {
    bv = unit_bias(bias, H, unit);
    dh = to_f32(g_ht[bh]);
    dc = to_f32(g_ct[bh]);
    len = lens[b];
  }
  cg::grid_group grid = cg::this_grid();
  const int64_t bg = static_cast<int64_t>(B) * G;

  for (int t = T - 1; t >= 0; --t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    // the owner's per-step inputs, in flight while the rows are staged
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    float c_prev = 0.f, go = 0.f;
    if (live) {
      xv = load_gates(xw + bt * G + unit, H);
      c_prev = t > 0 ? to_f32(c_seq[bt * H - H + unit]) : to_f32(c0[bh]);
      go = to_f32(g_out[bt * H + unit]);
    }
    // h_{t-1} of the block's rows: the saved masked output, h0 at t = 0
    __syncthreads();  // the previous step's readers of buf are done
    if (t > 0)
      stage_rows(out + static_cast<int64_t>(t - 1) * H,
                 static_cast<int64_t>(T) * H, b0, B, H, s.buf, s.ld_buf);
    else
      stage_rows(h0, H, b0, B, H, s.buf, s.ld_buf);
    __syncthreads();

    const float4 dot = gate_dot(s.buf, s.ld_buf, s.uc, H, l);
    float dh_keep = 0.f;
    float* dg_out = dg_x + (t & 1) * bg;
    if (owner) {
      float dg[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const Gates q = activate(xv, dot, bv, forget_bias);
        const float c_cur = q.f * c_prev + q.i * q.g;
        const float tc = tanhf(c_cur);
        const float m = t < len ? 1.f : 0.f;
        const float dh_t = dh + m * go;
        const float dhp = m * dh_t;
        const float dct = m * dc + dhp * q.o * (1.f - tc * tc);
        const float do_ = dhp * tc;
        dg[0] = (dct * q.g) * q.i * (1.f - q.i);
        dg[1] = (dct * c_prev) * q.f * (1.f - q.f);
        dg[2] = (dct * q.i) * (1.f - q.g * q.g);
        dg[3] = do_ * q.o * (1.f - q.o);
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          store_f32(dg[gi], dxw + bt * G + gi * H + unit);
          dg_out[static_cast<int64_t>(b) * G + gi * H + unit] = dg[gi];
        }
        dh_keep = (1.f - m) * dh_t;
        dc = (1.f - m) * dc + dct * q.f;
      }
      // rows past B add zero to dU
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        s.dgl[r * kCols + gi * kUnits + l.u] = dg[gi];
    }
    __syncthreads();

    // dU[:, block's columns] += h_{t-1}^T dgates over the block's rows;
    // thread k owns row k of the accumulator (rows past B are zero)
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      float acc[kCols];
      float4* drow = reinterpret_cast<float4*>(s.du + k * kDuLd);
#pragma unroll
      for (int q4 = 0; q4 < kCols / 4; ++q4) {
        const float4 d = drow[q4];
        acc[4 * q4] = d.x; acc[4 * q4 + 1] = d.y;
        acc[4 * q4 + 2] = d.z; acc[4 * q4 + 3] = d.w;
      }
      for (int rr = 0; rr < kRows; ++rr) {
        const float hv = s.buf[rr * s.ld_buf + k];
        const float4* d4 = reinterpret_cast<const float4*>(s.dgl + rr * kCols);
#pragma unroll
        for (int q4 = 0; q4 < kCols / 4; ++q4) {
          const float4 d = d4[q4];
          acc[4 * q4 + 0] = fmaf(hv, d.x, acc[4 * q4 + 0]);
          acc[4 * q4 + 1] = fmaf(hv, d.y, acc[4 * q4 + 1]);
          acc[4 * q4 + 2] = fmaf(hv, d.z, acc[4 * q4 + 2]);
          acc[4 * q4 + 3] = fmaf(hv, d.w, acc[4 * q4 + 3]);
        }
      }
#pragma unroll
      for (int q4 = 0; q4 < kCols / 4; ++q4)
        drow[q4] = make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2],
                               acc[4 * q4 + 3]);
    }

    // every block's dgates of step t are in the exchange after this
    grid.sync();

    // dh_{t-1} = (1-m) dh_t + dgates_t[b, :] @ U[unit, :]^T: the dgates
    // rows of the block's batch tile staged kChunk columns at a time; as
    // in gate_dot a lane sums every kSplit-th column for kRowsPer rows
    float acc[kRowsPer] = {0.f, 0.f, 0.f, 0.f};
    const float* urow = s.ur + l.u * s.ld_ur;
    const float* drows = s.buf + l.rg * kRowsPer * s.ld_buf;
    for (int c0_ = 0; c0_ < G; c0_ += kChunk) {
      const int w = G - c0_ < kChunk ? static_cast<int>(G - c0_) : kChunk;
      __syncthreads();
      stage_rows(dg_out + c0_, G, b0, B, w, s.buf, s.ld_buf);
      __syncthreads();
      for (int k = l.ks; k < w; k += kSplit) {
        const float wv = urow[c0_ + k];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i)
          acc[i] = fmaf(drows[i * s.ld_buf + k], wv, acc[i]);
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const float v = split_sum(acc[i]);
      if (i == l.ks) mine = v;
    }
    dh = dh_keep + mine;
  }
  if (live) {
    store_f32(dh, dh0 + bh);
    store_f32(dc, dc0 + bh);
  }

  // dU: the block's columns of its tile's sum, summed over tiles in order
  const int tiles = gridDim.y;
  float* dst = tiles == 1 ? du : du_part + blockIdx.y * H * G;
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * kCols; idx += blockDim.x) {
    const int k = idx / kCols, q = idx % kCols;
    dst[k * G + (q / kUnits) * H + j0 + q % kUnits] = s.du[k * kDuLd + q];
  }
  if (tiles == 1) return;
  grid.sync();
  if (blockIdx.y != 0) return;
  for (int idx = threadIdx.x; idx < H * kCols; idx += blockDim.x) {
    const int k = idx / kCols, q = idx % kCols;
    const int64_t off = k * G + (q / kUnits) * H + j0 + q % kUnits;
    float sum = 0.f;
    for (int y = 0; y < tiles; ++y) sum += __ldcg(du_part + y * H * G + off);
    du[off] = sum;
  }
}

template <typename DT>
int launch(const void* xw, const int* lens, const void* u, const void* b,
           const void* h0, const void* c0, const void* out,
           const void* c_seq, const void* g_out, const void* g_ht,
           const void* g_ct, void* dxw, void* dh0, void* dc0, float* du,
           float* dg_x, float* du_part, int B, int T, int H,
           float forget_bias, cudaStream_t stream) {
  void* args[] = {&xw,    &lens, &u,   &b,   &h0,  &c0,      &out,
                  &c_seq, &g_out, &g_ht, &g_ct, &dxw, &dh0,     &dc0,
                  &du,    &dg_x, &du_part, &B, &T,  &H, &forget_bias};
  return launch_cooperative(lstm_seq_bwd_kernel<DT>, B, H, smem_bytes(H),
                            args, stream);
}

}  // namespace
}  // namespace paddle_tpu_torch

// The forward's arguments (xw, lens, u, b, h0, c0; see lstm_seq.cu) plus
// out and c_seq [B, T, H] saved by paddle_lstm_seq_train, the cotangents
// g_out [B, T, H] and g_ht/g_ct [B, H]; outputs dxw [B, T, 4H], dh0/dc0
// [B, H] in the I/O dtype and du [H, 4H] f32. Scratch: dg_x f32
// [2, B, 4H], and du_part f32 [ceil(B / 32), H, 4H] (may be null when
// B <= 32). Returns the launch's cudaError_t, or 720 when the grid does
// not fit in one wave or a block's shared memory exceeds the limit.
extern "C" int paddle_lstm_seq_bwd(
    const void* xw, const int* lens, const void* u, const void* b,
    const void* h0, const void* c0, const void* out, const void* c_seq,
    const void* g_out, const void* g_ht, const void* g_ct, void* dxw,
    void* dh0, void* dc0, float* du, float* dg_x, float* du_part, int B,
    int T, int H, float forget_bias, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (H % lstm::kUnits != 0 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(xw, lens, u, b, h0, c0, out, c_seq, g_out, g_ht, g_ct,
                         dxw, dh0, dc0, du, dg_x, du_part, B, T, H,
                         forget_bias, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(xw, lens, u, b, h0, c0, out, c_seq, g_out,
                                 g_ht, g_ct, dxw, dh0, dc0, du, dg_x, du_part,
                                 B, T, H, forget_bias, st);
  return (int)cudaErrorInvalidValue;
}
