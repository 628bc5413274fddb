// Int8 implicit-GEMM tile shared by the W8A8 kernels (tsm_bottleneck_int8.cu:
// K9 and K14a; stem_s2d.cu: the int8 stem of K14b).
//
// out[M, N] = A[M, K] x W[N, K]^T with int8 operands and int32 sums:
// mma.sync.m16n8k32 s8 x s8 -> s32 on 128 x 128 x 64 tiles, eight warps
// (2 along M x 4 along N, 64 x 32 each), A and W streamed into shared
// memory two cp.async stages deep. A is never materialised: a loader
// (`al.load(smem, k0)`) gathers each 128 x 64-byte A tile from wherever
// the caller's operand lives, applying shifts, padding and quantization
// on the way. W is stored N x K (K contiguous), so one 16-byte chunk is 16
// consecutive k of one output channel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vcg8 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 128;       // output channels per block
constexpr int kBK = 64;        // reduction depth (bytes) per stage
constexpr int kThreads = 256;  // eight warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int kLd = kBK + 16;  // smem pitch (bytes): conflict-free words
constexpr int kFM = 4;         // m16 tiles per warp
constexpr int kFN = 4;         // n8 tiles per warp

struct Smem {
  alignas(16) int8_t a[2][kBM * kLd];  // A tile, [row][k]
  alignas(16) int8_t b[2][kBN * kLd];  // W tile, [n][k] (W is stored N x K)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // a source size of 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// clip(round(v / s), -127, 127): IEEE division, round half to even
__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

// Thread i owns 16-byte chunk (i % 4) of A rows i / 4 and i / 4 + 64.
struct Rows {
  int kc, r[2], pix[2];
  bool ok[2];
  __device__ void init(int m0, int m) {
    kc = threadIdx.x & 3;
    for (int i = 0; i < 2; ++i) {
      r[i] = (threadIdx.x >> 2) + i * 64;
      pix[i] = m0 + r[i];
      ok[i] = pix[i] < m;
      if (!ok[i]) pix[i] = 0;
    }
  }
};

// W tile: rows n0.. of wt [nout, k_total] (K contiguous), 64 bytes each.
__device__ __forceinline__ void load_w(int8_t* bs, const int8_t* wt,
                                       int k_total, int k0, int n0) {
  const int kc = threadIdx.x & 3;
  for (int i = 0; i < 2; ++i) {
    const int r = (threadIdx.x >> 2) + i * 64;
    cp_async16(bs + r * kLd + kc * 16,
               wt + static_cast<size_t>(n0 + r) * k_total + k0 + kc * 16,
               true);
  }
}

// acc += A[m0.., :k_total] x W[n0.., :k_total]^T for this block's tile.
template <class ALoader>
__device__ void gemm_tile(Smem& sm, const ALoader& al, const int8_t* wt,
                          int k_total, int n0, int (&acc)[kFM][kFN][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int ktiles = k_total / kBK;
  al.load(sm.a[0], 0);
  load_w(sm.b[0], wt, k_total, 0, n0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) {
      al.load(sm.a[s ^ 1], (kt + 1) * kBK);
      load_w(sm.b[s ^ 1], wt, k_total, (kt + 1) * kBK, n0);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kFM][4], bfr[kFN][2];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        const int8_t* p = sm.a[s] + (wm * 64 + i * 16 + g) * kLd + kk + tg * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        const int8_t* p = sm.b[s] + (wn * 32 + j * 8 + g) * kLd + kk + tg * 4;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(int (&acc)[kFM][kFN][4]) {
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Calls fn(row, col, i, j, e) for each accumulator element this thread
// holds: element e of tile (i, j) sits at row g (+8 for e >= 2), column
// 2 * tg + (e & 1) of the m16 x n8 tile.
template <class Fn>
__device__ __forceinline__ void each_element(int m0, int n0, Fn fn) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(m0 + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0),
           n0 + wn * 32 + j * 8 + 2 * tg + (e & 1), i, j, e);
}

}  // namespace vcg8
