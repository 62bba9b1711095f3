// Hopper (sm_90a) building blocks of the port's tensor-core kernels:
// mbarriers, TMA tile loads through a CUtensorMap, and warpgroup matrix
// multiplies (wgmma) on bf16 tiles held in shared memory with the 128-byte
// swizzle that TMA writes.
//
// The tiles these kernels move are [64 rows x 64] bf16: one 128-byte row
// per sequence position, so a tile is 8 KB and one 128B-swizzle atom is 8
// rows (1024 bytes). Every tile sits at a 1024-byte-aligned shared address.
// A head of width D = 128 is two such tiles side by side (a 128B-swizzle
// box holds 64 bf16 columns): columns 0-63 at the tile's address and
// columns 64-127 kTileBytes past it, each loaded by a box of its own.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paddle_tpu_torch {
namespace sm90 {

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 64 * 2;   // [64 x 64] bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte-aligned shared address at or past ``raw`` (a
// dynamic shared-memory block is sized 1024 bytes over its contents)
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces ``bytes`` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the barrier has completed the phase of parity ``phase``
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(phase) : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// One [64 x 64] box of a (D, H, L, B) map: columns c0..c0+63 of
// positions l0..l0+63 of head h of sample b. Rows past the map's L arrive
// as zeros.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c0, int h,
                                             int l0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(h), "r"(l0), "r"(b)
      : "memory");
}

// One [64 x D] tile (D / 64 boxes, kHalves = D / 64): positions l0..l0+63
// of head h of sample b, each 64-column half kTileBytes past the last.
// The barrier expects kHalves * kTileBytes for it.
template <int kHalves>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h, int l0,
                                              int b) {
#pragma unroll
  for (int c = 0; c < kHalves; ++c)
    tma_load_box(static_cast<uint8_t*>(dst) + c * kTileBytes, map, bar,
                 64 * c, h, l0, b);
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// K-major operands (the reduction runs along the 128-byte row): SBO = 1024
// (the next 8 rows), LBO unused; a 16-wide k step adds 32 bytes to the
// start. MN-major operands (the reduction runs down the rows, 64 output
// columns in one row): SBO = 1024 (the next 8 rows of k), LBO = the next
// 64 columns (none here); a k step of 16 rows adds 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16)
         | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define PTT_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PTT_WGMMA_OUT(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PTT_WGMMA_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (the fragment
// of one k step, see acc_to_frag), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PTT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_WGMMA_OUT(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef PTT_WGMMA_D32
#undef PTT_WGMMA_OUT

// C = A . B^T over a (64 * kHalves)-wide reduction: A [64 rows][D] and B
// [64 rows][D] K-major tiles of kHalves 64-column halves, four k steps of
// 16 a half. Issues; the caller commits and waits.
template <int kHalves>
__device__ __forceinline__ void gemm_abt(float (&d)[32], const void* a,
                                         const void* b) {
#pragma unroll
  for (int c = 0; c < kHalves; ++c) {
    const uint64_t da = smem_desc(static_cast<const uint8_t*>(a)
                                  + c * kTileBytes);
    const uint64_t db = smem_desc(static_cast<const uint8_t*>(b)
                                  + c * kTileBytes);
#pragma unroll
    for (int k = 0; k < 4; ++k)   // +32 bytes a step
      wgmma_ss(d, da + 2 * k, db + 2 * k, c > 0 || k > 0);
  }
}

// d += P . B over 64 rows of B: P as the bf16 fragments of a 64 x 64
// accumulator (acc_to_frag), B a [64 rows][64] tile read MN-major.
// Issues; the caller commits and waits.
__device__ __forceinline__ void gemm_pb(float (&d)[32],
                                        const uint32_t (&p)[16],
                                        const void* b) {
  const uint64_t db = smem_desc(b);
#pragma unroll
  for (int k = 0; k < 4; ++k)   // 16 rows of B (2048 bytes) a step
    wgmma_rs(d, p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3],
             db + k * (2048 >> 4));
}

// Accumulator layout of m64n64 (thread t of the warpgroup, lane = t % 32,
// warp = t / 32): d[4j + e] sits at row 16*warp + lane/4 + 8*(e >= 2) and
// column 8j + 2*(lane % 4) + (e & 1). A row's 64 columns lie in the 4
// lanes of a quad.
__device__ __forceinline__ int acc_row(int tid, int e) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return 8 * (i / 4) + 2 * (tid % 4) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 f32 accumulator as the bf16 A operand of four k steps: the
// accumulator layout of one wgmma is the register-A layout of the next,
// so k step k takes accumulator columns 16k..16k+15 as they lie.
__device__ __forceinline__ void acc_to_frag(const float (&d)[32],
                                            uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// ---- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPointByVersion, so that the library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a bf16 [B, L, H, D] tensor (D = 64 or 128) read through its
// element strides (batch sb, position sl, head sh; innermost 1) as
// (D, H, L, B), loaded in [64 positions x 64] boxes with the 128-byte
// swizzle (two boxes a tile at D = 128). Needs a 16-byte aligned base and
// strides of 16-byte multiples (the wrapper checks; the stride of a
// dimension of size 1 is not read).
// Returns false when the map is refused.
inline bool make_tile_map(CUtensorMap* map, const void* base, int B, int L,
                          int H, int D, int64_t sb, int64_t sl, int64_t sh) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  // a dimension of size 1 is never stepped: any legal stride will do
  const cuuint64_t strides[3] = {(cuuint64_t)(H == 1 ? D : sh) * 2,
                                 (cuuint64_t)(L == 1 ? D : sl) * 2,
                                 (cuuint64_t)(B == 1 ? D : sb) * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTileRows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace paddle_tpu_torch
