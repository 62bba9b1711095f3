// Backward of the masked GRU sequence for Hopper (sm_90a).
//
// Replaces the TPU kernel _gru_seq_bwd_kernel (paddle_tpu/ops/
// pallas_kernels.py, called by gru_sequence_fused_bwd): the reverse-time
// recurrence from the forward's residuals (xw with the bias added, the
// masked outputs) and the output cotangents. With h_{t-1} the saved out[t-1]
// (h0 at t = 0, in the I/O dtype as saved), it recomputes z, r, r*h_{t-1}
// and c of every step, then from t = T-1 down to 0 forms
//   dgz = (dh' (c - h_{t-1})) z (1-z),  dgc = (dh' z)(1 - c^2),
//   drh = dgc @ u_c^T,                  dgr = (drh h_{t-1}) r (1-r),
//   dh_{t-1} = (1-m) dh_t + dh' (1-z) + drh r + dgz @ u_z^T + dgr @ u_r^T,
// with dh' = m dh_t and m the step's mask, and writes dxw = [dgz|dgr|dgc].
// dU = sum_t [h_{t-1}^T dgz | h_{t-1}^T dgr | (r h_{t-1})^T dgc] in f32.
// Returns dxw and dh0 in the I/O dtype and dU [H, 3H] in f32; dx, dW and
// db (= the sum of dxw) are products outside (ops/rnn.py).
//
// What bounds it on the H100: the adjoint recurrence. Three product
// groups of 2*B*H*3H operations each (the gate recompute, the dh products,
// dU), but only the dh products are serial: the recompute reads only
// saved outputs, and dU only the step's cotangents. Within the serial
// part the chain dgc (all units) -> drh -> dgr (all units) -> dh_{t-1}
// crosses the grid twice a step.
//
// Design: the forward's cooperative grid (gru.cuh), block (x, y) owning
// kUnits hidden units for kRows batch rows, in three phases:
//  1. recompute, parallel over t: z and r of the block's units from the
//     staged h_{t-1} rows, r*h_{t-1} to an f32 sequence in global memory;
//     one grid barrier; c from the staged r*h rows of all units. z, r, c
//     go to an f32 scratch sequence that only their owner lane reads back.
//  2. the reverse recurrence: dgz, dgc of the block's units to an f32
//     cotangent sequence (f32, not the I/O dtype: the products are formed
//     from f32 cotangents, as in the JAX kernel); a grid barrier; drh and
//     dgz @ u_z^T from the staged rows of all units against the block's
//     rows of U; dgr to the sequence; a second barrier; dgr @ u_r^T. dh
//     stays in the owner lane's registers. Two barriers a step.
//  3. dU, parallel over t: the block's 3*kUnits columns, summed over its
//     rows and steps in shared memory (no atomics); with several batch
//     tiles each tile's sum goes to a partial buffer and, after one more
//     barrier, the first tile's blocks add the partials in a fixed order
//     (deterministic).
// Shared memory holds the staged rows and, in turn, U's columns (phase
// 1), U's rows (phase 2) and the dU accumulator (phase 3).
#include "gru.cuh"

namespace paddle_tpu_torch {
namespace {

using namespace gru;

constexpr int kCols = 3 * kUnits;    // gate columns a block owns
constexpr int kDuLd = kCols + kPad;  // row stride of the dU accumulator
// row padding of U's rows in shared memory: the 4 units' rows land 8
// banks apart
constexpr int kPadU = 8;

__host__ __device__ inline size_t region_floats(int H) {
  const size_t cols = static_cast<size_t>(H) * kUnits * 3;
  const size_t rows = static_cast<size_t>(kUnits) * (3 * H + kPadU);
  const size_t acc = static_cast<size_t>(H) * kDuLd + kRows * kCols;
  size_t m = cols > rows ? cols : rows;
  return m > acc ? m : acc;
}

__host__ __device__ inline size_t bwd_smem_bytes(int H) {
  return (static_cast<size_t>(kRows) * (H + kPad) + region_floats(H)) *
         sizeof(float);
}

// h_{t-1} rows of the block's tile: the saved output at t > 0, h0 at t = 0
template <typename DT>
__device__ __forceinline__ void stage_h_prev(const DT* out, const DT* h0,
                                             int t, int b0, int B, int T,
                                             int H, float* buf, int ld) {
  if (t > 0)
    stage_rows(out + static_cast<int64_t>(t - 1) * H,
               static_cast<int64_t>(T) * H, b0, B, H, buf, ld);
  else
    stage_rows(h0, H, b0, B, H, buf, ld);
}

template <typename DT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gru_seq_bwd_kernel(const DT* __restrict__ xw, const int* __restrict__ lens,
                   const DT* __restrict__ u, const DT* __restrict__ h0,
                   const DT* __restrict__ out, const DT* __restrict__ g_out,
                   const DT* __restrict__ g_ht, DT* __restrict__ dxw,
                   DT* __restrict__ dh0, float* __restrict__ du,
                   float* __restrict__ gates, float* __restrict__ rh_seq,
                   float* __restrict__ dg_seq, float* __restrict__ du_part,
                   int B, int T, int H) {
  extern __shared__ float4 smem[];
  const int ld = H + kPad;
  float* buf = reinterpret_cast<float*>(smem);  // [kRows][ld]
  float* reg = buf + kRows * ld;                // the phase's region
  const int64_t G = 3 * static_cast<int64_t>(H);
  const int64_t TH = static_cast<int64_t>(T) * H, TG = T * G;
  const Lane l;
  const int j0 = blockIdx.x * kUnits, b0 = blockIdx.y * kRows;
  const int r = l.row(), b = b0 + r, unit = j0 + l.u;
  const bool live = l.owner() && b < B;
  const int64_t bh = static_cast<int64_t>(b) * H + unit;
  const int len = live ? lens[b] : 0;
  cg::grid_group grid = cg::this_grid();

  // ---- phase 1: recompute z, r, r*h_{t-1} and c of every step ----------
  float* wzr = reg;                  // [H][kUnits][2]
  float* wc = reg + H * kUnits * 2;  // [H][kUnits]
  stage_cols<2>(u, H, j0, 0, wzr);
  stage_cols<1>(u, H, j0, 2, wc);
  for (int t = 0; t < T; ++t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    float xz = 0.f, xr = 0.f;
    if (live) {
      xz = to_f32(xw[bt * G + unit]);
      xr = to_f32(xw[bt * G + H + unit]);
    }
    __syncthreads();  // the previous step's readers of buf are done
    stage_h_prev(out, h0, t, b0, B, T, H, buf, ld);
    __syncthreads();
    const Dots<2> zr = cols_dot<2>(buf, ld, wzr, H, l);
    if (live) {
      const float z = sigmoid(xz + zr.v[0]);
      const float rr = sigmoid(xr + zr.v[1]);
      gates[bt * G + unit] = z;
      gates[bt * G + H + unit] = rr;
      rh_seq[bt * H + unit] = rr * buf[r * ld + unit];
    }
  }
  grid.sync();  // every block's r*h_{t-1} of every step is written
  for (int t = 0; t < T; ++t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    const float xc = live ? to_f32(xw[bt * G + 2 * H + unit]) : 0.f;
    __syncthreads();
    stage_rows(rh_seq + static_cast<int64_t>(t) * H, TH, b0, B, H, buf, ld);
    __syncthreads();
    const Dots<1> dc = cols_dot<1>(buf, ld, wc, H, l);
    if (live) gates[bt * G + 2 * H + unit] = tanhf(xc + dc.v[0]);
  }

  // ---- phase 2: the reverse recurrence ----------------------------------
  const int ldu = 3 * H + kPadU;
  float* urows = reg;  // [kUnits][ldu]: U's rows of the block's units
  __syncthreads();     // phase 1's readers of the region are done
  for (int idx = threadIdx.x; idx < kUnits * G; idx += blockDim.x) {
    const int row = idx / G, col = idx % G;
    urows[row * ldu + col] = to_f32(u[(j0 + row) * G + col]);
  }
  const float* urow = urows + l.u * ldu;
  float dh = live ? to_f32(g_ht[bh]) : 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    const float* dg_t = dg_seq + static_cast<int64_t>(t) * G;
    float z = 0.f, rr = 0.f, h_prev = 0.f, m = 0.f, dh_t = 0.f, dhp = 0.f;
    float dgz = 0.f, dgc = 0.f;
    if (live) {
      z = gates[bt * G + unit];
      rr = gates[bt * G + H + unit];
      const float c = gates[bt * G + 2 * H + unit];
      h_prev = t > 0 ? to_f32(out[bt * H - H + unit]) : to_f32(h0[bh]);
      m = t < len ? 1.f : 0.f;
      dh_t = dh + m * to_f32(g_out[bt * H + unit]);
      dhp = m * dh_t;
      dgz = (dhp * (c - h_prev)) * z * (1.f - z);
      dgc = (dhp * z) * (1.f - c * c);
      dg_seq[bt * G + unit] = dgz;
      dg_seq[bt * G + 2 * H + unit] = dgc;
    }
    // every block's dgz and dgc of step t are written, and every block is
    // done reading buf
    grid.sync();
    stage_rows(dg_t + 2 * H, TG, b0, B, H, buf, ld);
    __syncthreads();
    const float drh = row_dot(buf, ld, urow + 2 * H, H, l);
    __syncthreads();
    stage_rows(dg_t, TG, b0, B, H, buf, ld);
    __syncthreads();
    const float az = row_dot(buf, ld, urow, H, l);
    if (live) {
      const float dgr = (drh * h_prev) * rr * (1.f - rr);
      dg_seq[bt * G + H + unit] = dgr;
      store_f32(dgz, dxw + bt * G + unit);
      store_f32(dgr, dxw + bt * G + H + unit);
      store_f32(dgc, dxw + bt * G + 2 * H + unit);
    }
    grid.sync();  // every block's dgr of step t is written
    stage_rows(dg_t + H, TG, b0, B, H, buf, ld);
    __syncthreads();
    const float ar = row_dot(buf, ld, urow + H, H, l);
    if (live)
      dh = ((1.f - m) * dh_t + dhp * (1.f - z)) + drh * rr + az + ar;
  }
  if (live) store_f32(dh, dh0 + bh);

  // ---- phase 3: dU of the block's columns, summed over rows and steps ---
  float* acc = reg;                 // [H][kDuLd]
  float* dgl = reg + H * kDuLd;     // [kRows][kCols]: this step's dgates
  __syncthreads();                  // phase 2's readers of the region
  for (int idx = threadIdx.x; idx < H * kDuLd; idx += blockDim.x)
    acc[idx] = 0.f;
  for (int t = 0; t < T; ++t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    __syncthreads();
    stage_h_prev(out, h0, t, b0, B, T, H, buf, ld);
    if (l.owner()) {  // rows past B add zero
#pragma unroll
      for (int g = 0; g < 3; ++g)
        dgl[r * kCols + g * kUnits + l.u] =
            b < B ? __ldcg(dg_seq + bt * G + g * H + unit) : 0.f;
    }
    __syncthreads();
    // z and r columns from h_{t-1}, then the c columns from r*h_{t-1};
    // thread k owns row k of the accumulator
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
        __syncthreads();
        stage_rows(rh_seq + static_cast<int64_t>(t) * H, TH, b0, B, H, buf,
                   ld);
        __syncthreads();
      }
      const int q0 = pass == 0 ? 0 : 2 * kUnits;
      const int nq = pass == 0 ? 2 * kUnits : kUnits;
      for (int k = threadIdx.x; k < H; k += blockDim.x) {
        float a[2 * kUnits];
        float* arow = acc + k * kDuLd + q0;
#pragma unroll
        for (int q = 0; q < 2 * kUnits; ++q) a[q] = q < nq ? arow[q] : 0.f;
        for (int rr_ = 0; rr_ < kRows; ++rr_) {
          const float hv = buf[rr_ * ld + k];
          const float* d = dgl + rr_ * kCols + q0;
#pragma unroll
          for (int q = 0; q < 2 * kUnits; ++q)
            if (q < nq) a[q] = fmaf(hv, d[q], a[q]);
        }
#pragma unroll
        for (int q = 0; q < 2 * kUnits; ++q)
          if (q < nq) arow[q] = a[q];
      }
    }
  }

  const int tiles = gridDim.y;
  float* dst = tiles == 1 ? du : du_part + blockIdx.y * H * G;
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * kCols; idx += blockDim.x) {
    const int k = idx / kCols, q = idx % kCols;
    dst[k * G + (q / kUnits) * H + j0 + q % kUnits] = acc[k * kDuLd + q];
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
int launch(const void* xw, const int* lens, const void* u, const void* h0,
           const void* out, const void* g_out, const void* g_ht, void* dxw,
           void* dh0, float* du, float* gates, float* rh_seq, float* dg_seq,
           float* du_part, int B, int T, int H, cudaStream_t stream) {
  void* args[] = {&xw,    &lens,  &u,      &h0,     &out,     &g_out,
                  &g_ht,  &dxw,   &dh0,    &du,     &gates,   &rh_seq,
                  &dg_seq, &du_part, &B,   &T,      &H};
  return launch_cooperative(gru_seq_bwd_kernel<DT>, B, H, bwd_smem_bytes(H),
                            args, stream);
}

}  // namespace
}  // namespace paddle_tpu_torch

// The forward's arguments (xw with the bias added, lens, u, h0; see
// gru_seq.cu), out [B, T, H] saved by paddle_gru_seq, the cotangents g_out
// [B, T, H] and g_ht [B, H]; outputs dxw [B, T, 3H] and dh0 [B, H] in the
// I/O dtype and du [H, 3H] f32. Scratch, all f32: gates [B, T, 3H], rh_seq
// [B, T, H], dg_seq [B, T, 3H], and du_part [ceil(B / 32), H, 3H] (may be
// null when B <= 32). Returns the launch's cudaError_t, or 720 when the
// grid does not fit in one wave or a block's shared memory exceeds the
// limit.
extern "C" int paddle_gru_seq_bwd(const void* xw, const int* lens,
                                  const void* u, const void* h0,
                                  const void* out, const void* g_out,
                                  const void* g_ht, void* dxw, void* dh0,
                                  float* du, float* gates, float* rh_seq,
                                  float* dg_seq, float* du_part, int B, int T,
                                  int H, int dtype, void* stream) {
  using namespace paddle_tpu_torch;
  if (H % gru::kUnits != 0 || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(xw, lens, u, h0, out, g_out, g_ht, dxw, dh0, du,
                         gates, rh_seq, dg_seq, du_part, B, T, H, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(xw, lens, u, h0, out, g_out, g_ht, dxw, dh0,
                                 du, gates, rh_seq, dg_seq, du_part, B, T, H,
                                 st);
  return (int)cudaErrorInvalidValue;
}
