// The Hopper (sm_90a) GEMM mainloop of K5 (tsm_conv.cu), K12
// (conv_train.cu) and the stems (stem_tiles.cuh, stem_train.cu): wgmma
// from 128-byte-swizzled shared memory, fed by a ring of stages that TMA
// and cp.async fill. K10 (sparse_attention.cu) takes its descriptors,
// its TMA loads and the register-A product.
//
// A block of 256 threads (two warpgroups) computes tiles of kBM = 128
// output rows x BN (64, 128 or 256) columns; warpgroup g owns rows
// [64 g, 64 g + 64) and issues wgmma.mma_async m64nBNk16 (bf16 in, fp32
// accumulators in registers). Each stage brings kHBK = 64 of the
// reduction: a 128 x 64 A tile and a 64 x BN B tile, stored as panels of
// 128-byte rows (64 bf16) with the 16-byte chunks of row r XOR-swizzled by
// r % 8, the layout wgmma's 128B-swizzle descriptors read and TMA's
// 128-byte swizzle writes:
//   - K-major (A of a forward or data-gradient product, whose rows are
//     pixels): one panel [128 rows][64 k];
//   - MN-major (a weight [K][N] as it lies in memory; both operands of a
//     weight gradient, whose reduction runs over pixels): panels of 64
//     columns, each [64 k rows][64], wgmma's transpose bit set.
// A Src (the caller's operand source) fills a stage: dense tiles (weights,
// and activations or gradients read as plain [rows][channels] matrices)
// as TMA boxes completing on the slot's mbarrier, gathers (the 3x3 taps,
// the temporal shift, strides) by cp.async, zero-filling what lies outside
// the operand. It then transforms the arrived stage in place before the
// product (BN + ReLU, the BN backward, a finale); each thread transforms
// exactly the chunks it copied (or, for a TMA box, its share of them), so
// it waits only for its own copies and the slot's barrier, then fences
// its writes to the async proxy (fence.proxy.async) before the one
// barrier a stage. The stage's wgmmas are issued before the next stage's
// copies, so the product runs while they are issued. Loads run S - 1
// stages ahead of the product, across tile boundaries when a block owns
// several tiles (K5's persistent grid), so the next tile's operands
// arrive while this tile's epilogue runs.
//
// Epilogues: store_tile() stores bf16 straight from the accumulator
// registers (an affine on the way, column moments optional) through a
// small swizzled staging, whole 128-byte row segments per store;
// epilogue() keeps the contract of train_gemm.cuh's: fn(tile_row,
// tile_col, v[8]) hands a lane 8 consecutive fp32 columns of one row, the
// 32 lanes of a warp together; a warp owns 16 rows of the tile, and its
// 16-column blocks are visited in order, so sums taken there (the moment
// slots, one per warp) have a fixed order.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <atomic>

#include "conv_gemm.cuh"

namespace vcg {
namespace hop {

constexpr int kHBK = 64;                // reduction depth of a stage
constexpr int kPanel = kHBK * 128;      // bytes of one [64][64] bf16 panel
constexpr int kATile = kBM * 128;       // bytes of a 128 x 64 A tile
constexpr int kEpiLd = 20;              // fp32 pitch of the staging rows
constexpr int kEpiBytes = 8 * 16 * kEpiLd * 4;  // one 16-row block a warp

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled panel
__device__ __forceinline__ int swz(int r, int c) {
  return (r << 7) | ((c ^ (r & 7)) << 4);
}

// byte offset of element chunk (k, n / 8) in an MN-major [64][BN] tile
__device__ __forceinline__ int mn_off(int k, int n8) {
  return (n8 >> 3) * kPanel + swz(k, n8 & 7);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n64k16 with A from registers (the attention's probabilities): a lane's
// four registers hold bf16 pairs of rows r = 16 warp + lane / 4 and r + 8
// at columns 2 (lane % 4), + 1 and 8 + 2 (lane % 4), + 1: a[0] = (r, lo),
// a[1] = (r + 8, lo), a[2] = (r, hi), a[3] = (r + 8, hi), the layout of a
// m64n16 accumulator. The product reads them after issue: keep them
// unchanged until the wait (fence_regs).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_ra(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// Keep the compiler from moving or reusing registers an asynchronous
// product reads (its A fragments) across its issue and wait.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---------------------------------------------------------------------------
// TMA tiles and the mbarriers they complete on
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The one arrival of a stage's barrier, expecting bytes from its copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A box of a 2-d tensor map (coordinates: column, row) into shared memory
// at dst, completing on bar. map is the address of a __grid_constant__
// kernel parameter.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// A tensor map over a row-major matrix [rows][cols] of bf16 (elem 2) or
// int8 (elem 1) elements (16-byte aligned, cols * elem % 16 == 0) whose
// boxes are box_rows x 128 bytes, stored as one 128-byte-swizzled panel
// (the layout swz() writes); boxes past the matrix are filled with zeros.
inline cudaError_t tensor_map_2d(CUtensorMap* map, const void* base,
                                 uint64_t rows, uint64_t cols, int elem,
                                 uint32_t box_rows) {
  // the driver's entry, looked up once (every thread finds the same one)
  static std::atomic<PFN_cuTensorMapEncodeTiled_v12000> found_fn{nullptr};
  PFN_cuTensorMapEncodeTiled_v12000 encode =
      found_fn.load(std::memory_order_acquire);
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    found_fn.store(encode, std::memory_order_release);
  }
  const cuuint64_t dim[2] = {cols, rows};
  const cuuint64_t stride[1] = {cols * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem), box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map,
      elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dim, stride, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 [rows][cols] matrix's map: boxes box_rows x 64 columns.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base,
                              uint64_t rows, uint64_t cols,
                              uint32_t box_rows) {
  return tensor_map_2d(map, base, rows, cols, 2, box_rows);
}

// Issuing a TMA box costs its thread a few hundred cycles, so a stage's
// boxes are spread over the warps of the block: box i goes from lane 0 of
// warp first + i.
__device__ __forceinline__ bool tma_lane(int first, int i) {
  return threadIdx.x == 32 * (first + i);
}

// The MN-major B tile of rows k0.. and columns n0..n0 + BN of a weight
// through its tensor map (box_rows kHBK): BN / 64 boxes, one a panel,
// from warps first ...
template <int BN>
__device__ __forceinline__ void tma_w(uint8_t* b, const CUtensorMap* map,
                                      int k0, int n0, uint64_t* bar,
                                      int first) {
#pragma unroll
  for (int p = 0; p < BN / 64; ++p)
    if (tma_lane(first, p)) tma_load(b + p * kPanel, map, n0 + 64 * p, k0, bar);
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 64)
    wgmma_m64n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_m64n128<TA, TB>(d, da, db);
  else
    wgmma_m64n256<TA, TB>(d, da, db);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product's fence and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The product of one stage: kHBK / 16 wgmmas per warpgroup into acc,
// committed as one group. a: the A tile, K-major [128][64] (TA = 0) or
// MN-major [64 k][128] (TA = 1); b: the MN-major [64 k][BN] B tile.
template <int BN, int TA>
__device__ __forceinline__ void mma_issue(const uint8_t* a, const uint8_t* b,
                                          float (&acc)[BN / 2]) {
  const int wg = threadIdx.x >> 7;
  const uint32_t a0 = smem_addr(a) + (TA ? wg * kPanel : wg * 64 * 128);
  const uint32_t b0 = smem_addr(b);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kHBK / 16; ++kk) {
    // K-major A: 16 k are 32 bytes along the row; MN-major: 16 rows
    const uint64_t da = TA ? desc(a0 + kk * 2048, kPanel, 1024)
                           : desc(a0 + kk * 32, 16, 1024);
    wgmma<BN, TA, 1>(acc, da, desc(b0 + kk * 2048, kPanel, 1024));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(acc);
}

// Wait until at most N committed products are in flight.
template <int N, int R>
__device__ __forceinline__ void mma_wait(float (&acc)[R]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc(acc);
}

// ---------------------------------------------------------------------------
// int8: wgmma m64nBNk32 s32.s8.s8. For 8-bit operands wgmma takes no
// transpose bit, so both A and B are K-major: a panel row is 128 int8 k
// (the same 128-byte rows and swizzle as a bf16 panel's 64 k), and a stage
// of kIBK = 128 k is four k32 products. The s32 accumulators lie as the
// f32 ones do (acc[4 j + e]: rows r, r + 8 at columns 8 j + 2 (lane % 4)).
// ---------------------------------------------------------------------------

constexpr int kIBK = 128;  // int8 reduction depth of a stage (one panel row)

__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n256k32: the 256 columns of a stem's phase-packed product at once
__device__ __forceinline__ void wgmma_s8_m64n256(int (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The product of one int8 stage: four k32 wgmmas per warpgroup into acc,
// committed as one group; a: K-major [128 rows][128 k], b: K-major
// [128 n][128 k].
__device__ __forceinline__ void mma_issue_s8(const uint8_t* a,
                                             const uint8_t* b,
                                             int (&acc)[64]) {
  const uint32_t a0 = smem_addr(a) + (threadIdx.x >> 7) * 64 * 128;
  const uint32_t b0 = smem_addr(b);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kIBK / 32; ++kk)
    wgmma_s8_m64n128(acc, desc(a0 + kk * 32, 16, 1024),
                     desc(b0 + kk * 32, 16, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_acc(acc);
}

template <int N, int R>
__device__ __forceinline__ void mma_wait(int (&acc)[R]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc(acc);
}

// The ring and its stream of stages. Src provides
//   static constexpr int kStageBytes (a multiple of 1024; the A tile at
//     offset 0, the B tile at kATile, any raw staging after them),
//   static constexpr bool kTma: its stages complete on an mbarrier, whose
//     one arrival (mbar_expect) thread 0 makes in load,
//   load(stage, bar, tile, kt)  issue this thread's copies of stage kt of
//                               its tile-th tile (cp.async, no commit; TMA
//                               boxes completing on bar),
//   xform(stage, tile, kt)      transform this thread's arrived chunks,
// with tile counting this block's tiles from 0. Loads stream kAhead
// stages ahead over all of the block's tiles in order. With kOverlap a
// stage's product stays in flight while the next stage is transformed
// (a slot is then free two barriers after its product was issued, so one
// stage fewer is ahead). bars: S mbarriers in shared memory.
template <int BN, int S, int TA, class Src, bool kOverlap = false>
struct Mainloop {
  uint8_t* ring;
  uint64_t* bars;
  Src& src;
  int ktiles, total;
  int lq, lt, lk;  // next stage to load: index, tile, k step
  int ct;          // next tile to compute

  static constexpr int kRingBytes = S * Src::kStageBytes;
  static constexpr int kAhead = kOverlap ? S - 2 : S - 1;
  static_assert(kAhead >= 1, "ring too short");

  __device__ Mainloop(uint8_t* ring_, uint64_t* bars_, Src& src_, int ntiles,
                      int ktiles_)
      : ring(ring_), bars(bars_), src(src_), ktiles(ktiles_),
        total(ntiles * ktiles_), lq(0), lt(0), lk(0), ct(0) {
    if (Src::kTma) {
      if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) mbar_init(&bars[s]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) load_next();
  }

  __device__ void load_next() {
    if (lq < total) {
      src.load(ring + (lq % S) * Src::kStageBytes, &bars[lq % S], lt, lk);
      if (++lk == ktiles) {
        lk = 0;
        ++lt;
      }
    }
    ++lq;
    cp_async_commit();  // empty groups keep the count uniform
  }

  // The K loop of the next tile: per stage, once it has arrived and been
  // transformed, issue(stage, kt) issues its product, the next stage's
  // copies go out while the product runs, then wait() waits for it.
  template <class Issue, class Wait>
  __device__ void k_loop(Issue issue, Wait wait) {
    for (int kt = 0; kt < ktiles; ++kt) {
      const int q = ct * ktiles + kt;
      uint8_t* st = ring + (q % S) * Src::kStageBytes;
      cp_async_wait<kAhead - 1>();
      if (Src::kTma) mbar_wait(&bars[q % S], (q / S) & 1);
      src.xform(st, ct, kt);
      fence_async_smem();
      __syncthreads();
      issue(st, kt);
      load_next();
      wait();
    }
    ++ct;
  }

  // The K loop of the next tile into acc (zeroed first).
  __device__ void tile(float (&acc)[BN / 2]) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    k_loop(
        [&](const uint8_t* st, int) {
          mma_issue<BN, TA>(st, st + kATile, acc);
        },
        [&] {
          if (kOverlap)
            mma_wait<1>(acc);
          else
            mma_wait<0>(acc);
        });
    mma_wait<0>(acc);
  }

  // tile() with two accumulators: stages 0 .. split - 1 of the tile into
  // acc, the rest into acc2 (both zeroed first); each product is waited
  // before the next stage's copies.
  __device__ void tile2(float (&acc)[BN / 2], float (&acc2)[BN / 2],
                        int split) {
    static_assert(!kOverlap, "tile2 waits for each product");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = acc2[i] = 0.0f;
    k_loop(
        [&](const uint8_t* st, int kt) {
          if (kt < split)
            mma_issue<BN, TA>(st, st + kATile, acc);
          else
            mma_issue<BN, TA>(st, st + kATile, acc2);
        },
        [&] {
          mma_wait<0>(acc);
          fence_acc(acc2);
        });
  }

  // After the last tile: no copy in flight, and every thread past its
  // last product, so the ring may be reused; the barriers are invalidated,
  // so a later Mainloop over the same ones may initialize them again.
  __device__ void finish() {
    cp_async_wait<0>();
    __syncthreads();
    if (Src::kTma && threadIdx.x == 0)
      for (int s = 0; s < S; ++s) mbar_inval(&bars[s]);
  }
};

// Dynamic shared memory, rounded up to the 1024 bytes the swizzle needs
// (launch with kAlignSlack bytes more than the layout).
constexpr int kAlignSlack = 1024;

__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a = smem_addr(smem_raw);
  return smem_raw + ((1024 - (a & 1023)) & 1023);
}

// Hand every lane 8 consecutive accumulator columns of one tile row:
// fn(tile_row, tile_col, v[8]), all 32 lanes of a warp together (fn may
// use warp shuffles). A warp owns rows 16 w .. 16 w + 15 of the tile
// (w = warp index in the block); lanes of one parity hold the same 8
// columns of its 16 rows. ep: this warp's kEpiBytes / 8 of staging.
template <int BN, class Fn>
__device__ void epilogue(float* ep, const float (&acc)[BN / 2], Fn&& fn) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;
  const int r = lane >> 2;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the two n8 blocks of these 16 columns
      const int i = 8 * j + 4 * h;
      *reinterpret_cast<float2*>(ep + r * kEpiLd + 8 * h + c) =
          make_float2(acc[i], acc[i + 1]);
      *reinterpret_cast<float2*>(ep + (r + 8) * kEpiLd + 8 * h + c) =
          make_float2(acc[i + 2], acc[i + 3]);
    }
    __syncwarp();
    float v[8];
    const float* src = ep + (lane >> 1) * kEpiLd + (lane & 1) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    fn(row0 + (lane >> 1), 16 * j + (lane & 1) * 8, v);
    __syncwarp();
  }
}

constexpr int kStoreBytes = 8 * 1024;  // store_tile's staging, 1 KB a warp

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// store_tile's row placement: tile row gm is out row gm.
struct DenseRows {
  __device__ bool ok(int) const { return true; }
  __device__ size_t at(int gm) const { return static_cast<size_t>(gm); }
};

// Store a warp's 16 x BN accumulators straight from wgmma's registers:
// aff(col, y[4]) maps the four values a lane holds at columns col and
// col + 1 of rows r and r + 8 in place, each is rounded once to bf16 and
// goes to out rows
// row0 .. row0 + 15 (rows >= m are skipped), columns n0 + tile column;
// place (DenseRows by default) maps a tile row to its out row and may
// skip it (place.ok false: neither stored nor in the moments).
// Each 64-column group goes through this warp's 1 KB of staging (stg,
// 16-byte chunks XOR-swizzled by row) eight rows at a time, so every
// global store is a whole 128-byte row segment. With s0 != null, the
// column sums of the stored values and of their squares over the 16 rows
// are added to s0[col] and s1[col] (this warp's moment slots): each
// lane sums its two rows, then three xor-shuffles sum the 8 lanes of a
// column pair, in a fixed order.
template <int BN, class Aff, class Place = DenseRows>
__device__ void store_tile(uint8_t* stg, const float (&acc)[BN / 2], Aff aff,
                           bf16* out, int ld, int row0, int m, int n0,
                           float* s0, float* s1, Place place = Place{}) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2;
  const int q = lane & 3;
  const bool ok0 = row0 + r < m && place.ok(row0 + r);
  const bool ok1 = row0 + r + 8 < m && place.ok(row0 + r + 8);
#pragma unroll
  for (int grp = 0; grp < BN / 64; ++grp) {
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = 4 * (8 * grp + b);
      const int col = 64 * grp + 8 * b + 2 * q;
      // (row r, col), (r, col + 1), (r + 8, col), (r + 8, col + 1)
      float y[4] = {acc[i], acc[i + 1], acc[i + 2], acc[i + 3]};
      aff(n0 + col, y);
      lo[b] = pack2(y[0], y[1]);
      hi[b] = pack2(y[2], y[3]);
      if (s0 != nullptr) {
        const float2 a = ok0 ? unpack2(lo[b]) : make_float2(0.0f, 0.0f);
        const float2 c = ok1 ? unpack2(hi[b]) : make_float2(0.0f, 0.0f);
        float v[4] = {a.x + c.x, a.y + c.y, a.x * a.x + c.x * c.x,
                      a.y * a.y + c.y * c.y};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        if (r == 0) {
          s0[col] += v[0];
          s0[col + 1] += v[1];
          s1[col] += v[2];
          s1[col + 1] += v[3];
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // row rr (0..7) of this half: chunk b at (b ^ rr) * 16
#pragma unroll
      for (int b = 0; b < 8; ++b)
        *reinterpret_cast<uint32_t*>(stg + r * 128 + ((b ^ r) << 4) + 4 * q) =
            half ? hi[b] : lo[b];
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int rr = (lane >> 3) + 4 * k;
        const int cc = lane & 7;
        const int gm = row0 + rr + 8 * half;
        const uint4 v =
            *reinterpret_cast<const uint4*>(stg + rr * 128 + ((cc ^ rr) << 4));
        if (gm < m && place.ok(gm))
          *reinterpret_cast<uint4*>(out + place.at(gm) * ld + n0 + 64 * grp +
                                    8 * cc) = v;
      }
      __syncwarp();
    }
  }
}

// store_tile's affine for the training GEMMs: the bare product.
struct Identity {
  __device__ void operator()(int, float (&)[4]) const {}
};

// Per-device host caches: one slot a device ordinal, 0 until the
// device's value is known, then written once with a value that is the
// same whichever thread writes it. So a kernel may launch from several
// host threads on several cards at once, and a device pays the host
// calls behind a slot once, not on every launch.
constexpr int kMaxDevices = 64;

inline cudaError_t current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    e = cudaErrorInvalidDevice;
  return e;
}

// Raise kernel K's dynamic shared memory limit to bytes (above 48 KB),
// once per device: the call costs host time on every launch otherwise.
template <auto K>
inline cudaError_t allow_smem(int bytes) {
  static std::atomic<int> done[kMaxDevices];  // static: zero-initialized
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e == cudaSuccess && !done[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e == cudaSuccess) done[dev].store(1, std::memory_order_release);
  }
  return e;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The blocks of kernel K (of T threads) the card holds at once at smem
// bytes of dynamic shared memory each, found on the first launch on each
// device (the attribute and the occupancy query cost host time).
template <auto K, int T = kThreads>
inline cudaError_t resident(int smem, int* blocks) {
  static std::atomic<int> held[kMaxDevices];  // 0: not known yet
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return e;
  int n = held[dev].load(std::memory_order_acquire);
  if (n == 0) {
    int sms = 0, per_sm = 0;
    e = allow_smem<K>(smem);
    if (e == cudaSuccess) e = sm_count(&sms);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, T,
                                                        smem);
    if (e == cudaSuccess) {
      n = per_sm * sms;
      held[dev].store(n, std::memory_order_release);
    }
  }
  *blocks = n;
  return e;
}

}  // namespace hop
}  // namespace vcg
