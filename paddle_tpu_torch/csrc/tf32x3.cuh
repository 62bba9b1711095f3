// Three-pass TF32 products on Hopper's tensor cores (sm_90a), for f32
// operands that must keep f32's accuracy: the f32 bodies of the flash
// forward (flash_fwd.cu) and backward (flash_bwd.cu), and the gate
// recompute and dU products of the LSTM and GRU backwards
// (lstm_seq_bwd.cu, gru_seq_bwd.cu).
//
// The split. Each f32 operand x is split in registers into big, x
// rounded to TF32 (11 significant bits; round half away from zero: add
// half an ulp to the bits, clear the 13 low bits: two integer ops), and
// small = x - big, exact in f32 and handed to the tensor core as it is:
// the core reads the leading 11 significant bits of a .tf32 operand and
// ignores the rest. |x - big| <= 2^-11 |x|, and reading small so drops
// at most 2^-10 |small| <= 2^-21 |x|. A product a.b is summed into one
// f32 accumulator as small_a.big_b + big_a.small_b + big_a.big_b, the
// small terms first so that they are not rounded away behind the large
// one; the dropped small_a.small_b is at most 2^-22 |ab|. Each product so
// keeps a relative error under 5 * 2^-22 (about 1.2e-6), plus the f32
// accumulation's own rounding, against 2^-24 for an f32 FMA and about
// 2^-11 for one TF32 pass (which breaks the f32 kernels' rtol of 1e-4;
// this does not). It is CUTLASS's OpMultiplyAddFastF32 (big by
// round-half-ulp, small read truncated), the arithmetic of PyTorch's own
// f32 attention backward on this card, at three mma.sync a product: the
// least time an f32-accurate product takes here is 3 x its operations
// over the 495 TF/s dense TF32 peak. (cvt.rna.tf32.f32 compiles to four
// or five instructions with a NaN/Inf check on sm_90a; two a split keeps
// the bodies from being bound by instruction issue.) Inputs are finite.
//
// Accumulation. The tensor core adds its products into the f32
// accumulator without rounding to nearest (the addends are aligned and
// their low bits dropped), so a sum carried across many mma.sync loses
// more than an FMA chain would. Summed over the 1023 keys or queries of
// an attention row, that error was 10x the plain f32 route's and failed
// chip_smoke.py's f32 GPT-2 training-step check on the H100. So a long
// sum is taken a pipeline stage at a time: each stage's products go into
// a fresh accumulator, and the stages' sums are added into the running
// sum with f32 adds (round to nearest). Within a stage the sum is short.
//
// The instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// one warp a 16 x 8 x 8 product. Fragments (PTX ISA; lane = 4 g + t):
//   A [16 x 8]:  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B [8 x 8]:   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C [16 x 8]:  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
//
// Tiles. f32 tiles sit in shared memory as rows of 64 floats padded to
// kLdt = 68 (272 bytes: 16-byte aligned for cp.async, and 68 = 4 mod 32
// banks); a D = 128 head's rows are padded to 132 (ld_for). Three ways to
// read them, each free of bank conflicts:
//  * an operand whose reduction runs along the row (A = X[m][k], or B from
//    X[n][k]) by ldmatrix: its m8n8 b16 matrices are 8 rows of 16 bytes,
//    four floats, and lane 4g + t receives the 32-bit word (g, t), which
//    is exactly the fragment above; the 8 rows of a matrix lie 272 bytes
//    apart, in 8 distinct 16-byte bank groups;
//  * B from X[k][n] (the reduction runs down the rows: K in dQ = dS.K, Q
//    and dO in dK = dS^T.Q and dV = P^T.dO) by scalar loads, with the
//    reduction index permuted within each step of 8: logical k = t reads
//    row 2t and k = t + 4 row 2t + 1, so a warp's 32 loads fall on banks
//    8t + g (+4): distinct;
//  * A from an accumulator (P, dS as the next product's left operand)
//    with the same permutation, so no shuffle: c0, c2 are (rows g, g + 8;
//    k = 2t) and c1, c3 are (rows g, g + 8; k = 2t + 1), i.e. a0 = c0,
//    a1 = c2, a2 = c1, a3 = c3. The permutation is a relabelling of the
//    reduction index shared by both operands, so the product is unchanged.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace paddle_tpu_torch {
namespace tf32x3 {

constexpr int kLdt = 68;   // row pitch of an f32 [rows x 64] tile, in floats

// the row pitch of an f32 [rows x D] tile: D + 4 floats (68 at D = 64,
// 132 at D = 128), 4 mod 8 as the loaders below need
__host__ __device__ constexpr int ld_for(int D) { return D + 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous tile loads (cp.async, 16 bytes a copy) -------------------

// 16 bytes from global to shared; ``in`` false writes 16 zero bytes and
// reads nothing (src-size 0), so the ragged edge of a tile needs no branch
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 8 bytes, likewise (bf16 rows of 4k + 4 elements: 8-byte aligned only)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

// 4 bytes, likewise (the per-row lse and delta, H floats apart)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of a [L, COLS] f32 operand (row r at
// src + r * row_stride, 16-byte aligned) into a [ROWS][ld_for(COLS)]
// tile; rows at or past ``rows_valid`` are zero-filled. Issued by all
// THREADS threads, neighbouring threads on neighbouring 16-byte chunks of
// a row.
template <int ROWS, int THREADS, int COLS = 64>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                int64_t row_stride, int row0,
                                                int rows_valid, int tid) {
  constexpr int kChunks = COLS / 4;          // 16-byte chunks a row
  constexpr int kLd = ld_for(COLS);
  static_assert(ROWS * kChunks % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < rows_valid;
    const float* p = in ? src + (row0 + r) * row_stride + 4 * c : src;
    cp_async16(dst + r * kLd + 4 * c, p, in);
  }
}

// ---- the split and the three products --------------------------------------

struct FragA {               // one A fragment, split
  uint32_t big[4], small[4];
};
struct FragB {               // one B fragment, split
  uint32_t big[2], small[2];
};

// big = x rounded to TF32 (half away from zero), small = x - big
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1,
                                        float a2, float a3) {
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
}

__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], one TF32 pass
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b at f32 accuracy: the two small terms, then big . big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// d += a . b at f32 accuracy: the passes of mma3, less those with a small
// part that is 0 -- an operand of the bf16 I/O dtype is exact in TF32, so
// its product with the other's big and small parts is exact as in an f32
// FMA
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_passes(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  if (!kAExact) mma_tf32(d, a.small, b.big);
  if (!kBExact) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// 2^x by the SFU (ex2.approx.ftz, the approximation exp2f is built on:
// within 2 ulp; results below 2^-126 flush to 0, far under any f32
// tolerance of P)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- fragment loaders -----------------------------------------------------

__device__ __forceinline__ void ldsm_x4(float (&r)[4], const float* p) {
  uint32_t u0, u1, u2, u3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(u0), "=r"(u1), "=r"(u2), "=r"(u3)
               : "r"(smem_addr(p)) : "memory");
  r[0] = __uint_as_float(u0);
  r[1] = __uint_as_float(u1);
  r[2] = __uint_as_float(u2);
  r[3] = __uint_as_float(u3);
}

// Each loader takes the tile's row pitch ``ld`` in floats (kLdt for the
// attention tiles); every pitch ld = 4 mod 8 keeps all of them free of
// bank conflicts, as kLdt does (a row is an odd number of 16-byte groups
// for ldmatrix; rows 2t lie 8t banks apart for the scalar loads).

// A = X[row0 .. row0 + 15][k0 .. k0 + 7] of a [rows][ld] tile: the four
// matrices are (rows +0, cols +0), (+8, +0), (+0, +4), (+8, +4)
__device__ __forceinline__ void load_a(FragA& f, const float* tile,
                                       int row0, int k0, int lane,
                                       int ld = kLdt) {
  const int m = lane >> 3;
  float r[4];
  ldsm_x4(r, tile + (row0 + (lane & 7) + 8 * (m & 1)) * ld + k0
                 + 4 * (m >> 1));
  split_a(f, r[0], r[1], r[2], r[3]);
}

// B of two n-tiles, n0 .. n0 + 7 and n0 + 8 .. n0 + 15, at k0 .. k0 + 7,
// from an X[n][k] tile (B[k][n] = X[n][k]): matrices (n +0, k +0),
// (+0, +4), (+8, +0), (+8, +4)
__device__ __forceinline__ void load_b_nk2(FragB& f0, FragB& f1,
                                           const float* tile, int n0, int k0,
                                           int lane, int ld = kLdt) {
  const int m = lane >> 3;
  float r[4];
  ldsm_x4(r, tile + (n0 + (lane & 7) + 8 * (m >> 1)) * ld + k0
                 + 4 * (m & 1));
  split_b(f0, r[0], r[1]);
  split_b(f1, r[2], r[3]);
}

// B = X[k0 .. k0 + 7][n0 .. n0 + 7] of an X[k][n] tile, the reduction
// index permuted (k = t reads row 2t, k = t + 4 row 2t + 1)
__device__ __forceinline__ void load_b_kn(FragB& f, const float* tile,
                                          int k0, int n0, int lane,
                                          int ld = kLdt) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split_b(f, p[0], p[ld]);
}

// The A fragment X[row0 .. +15][k0 .. +7] of a [rows][ld] tile of f32 or
// bf16 (an operand whose reduction runs along its rows): ldmatrix for f32;
// scalar loads for bf16, whose values are exact in TF32 (their small
// parts are 0)
__device__ __forceinline__ void load_a_rows(FragA& f, const float* tile,
                                            int row0, int k0, int lane,
                                            int ld) {
  load_a(f, tile, row0, k0, lane, ld);
}
__device__ __forceinline__ void load_a_rows(FragA& f,
                                            const __nv_bfloat16* tile,
                                            int row0, int k0, int lane,
                                            int ld) {
  const __nv_bfloat16* q = tile + (row0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_a(f, to_f32(q[0]), to_f32(q[8 * ld]), to_f32(q[4]),
          to_f32(q[8 * ld + 4]));
}

// The A fragment X[k0 .. +7][m0 .. +15]^T of an X[k][m] tile of f32 or
// bf16 (h^T in the dU products: the reduction runs down the rows), the
// reduction index permuted as load_b_kn permutes it
template <typename T>
__device__ __forceinline__ void load_a_km(FragA& f, const T* tile, int k0,
                                          int m0, int lane, int ld) {
  const T* q = tile + (k0 + 2 * (lane & 3)) * ld + m0 + (lane >> 2);
  split_a(f, to_f32(q[0]), to_f32(q[8]), to_f32(q[ld]), to_f32(q[ld + 8]));
}

// The accumulator of one n-tile (columns 8j .. 8j + 7) as the A fragment
// of the k step over those columns, with load_b_kn's permutation
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split_a(f, c[0], c[2], c[1], c[3]);
}

}  // namespace tf32x3
}  // namespace paddle_tpu_torch
