// Implicit-GEMM convolution core of the stems (K1, K8, K14b in
// stem_s2d.cu; K11 through train_gemm.cuh), and the constants and cp.async
// helpers that hopper_gemm.cuh builds on.
//
// A convolution over an NHWC bf16 activation is a matrix product
// out[M, Nout] = A[M, K] x W[K, Nout] with M = output pixels and
// K = kh * kw * Cin ordered (kh, kw, c): the row order of an HWIO weight
// reshaped to [K, Nout]. A is never materialised. Each 128 x BK tile of A
// is gathered straight from the activation into shared memory by the
// caller's loader (the stems' own), which also applies the zero padding.
// W tiles stream in with cp.async, two stages deep, and bf16 WMMA
// fragments accumulate in fp32. The epilogue applies the folded-BN
// affine and the optional ReLU, and stores bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace vcg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // output pixels per block
constexpr int kBK = 32;        // reduction depth per stage
constexpr int kThreads = 256;  // eight warps
constexpr int kALd = kBK + 8;  // padded smem pitch of the A tile (elements)

template <int BN>
struct Tile {
  static constexpr int kBLd = BN + 8;  // padded smem pitch of the W tile
  static constexpr int kWarpsN = BN == 128 ? 4 : 2;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;  // warp tile rows
  static constexpr int kWN = BN / kWarpsN;   // warp tile columns
  static constexpr int kFM = kWM / 16;
  static constexpr int kFN = kWN / 16;
};

template <int BN>
struct Smem {
  alignas(128) bf16 a[2][kBM * kALd];
  alignas(128) bf16 b[2][kBK * Tile<BN>::kBLd];
  alignas(128) float epi[8][16 * 16];
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

template <int BN>
__device__ __forceinline__ void load_w(bf16* bs, const bf16* w, int nout,
                                       int k0, int n0, int k_total) {
  constexpr int kPerRow = BN / 8;
  constexpr int kChunks = kBK * kPerRow;
  for (int q = threadIdx.x; q < kChunks; q += kThreads) {
    const int r = q / kPerRow;
    const int cc = q - r * kPerRow;
    const int k = k0 + r;
    const bool ok = k < k_total;
    const bf16* src = ok ? w + static_cast<size_t>(k) * nout + n0 + cc * 8 : w;
    cp_async16(bs + r * Tile<BN>::kBLd + cc * 8, src, ok);
  }
}

// One kBM x BN output tile: K loop over k_total (a multiple of kBK), then
// out = act(acc * scale + bias) in bf16.
template <int BN, class ALoader>
__device__ void conv_gemm_tile(Smem<BN>& sm, const ALoader& al, const bf16* w,
                               int k_total, int nout, int m0, int n0, int m,
                               const float* scale, const float* bias,
                               bf16* out, bool relu) {
  using namespace nvcuda;
  using TL = Tile<BN>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / TL::kWarpsN;
  const int wn = warp - wm * TL::kWarpsN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TL::kFM][TL::kFN];
#pragma unroll
  for (int i = 0; i < TL::kFM; ++i)
#pragma unroll
    for (int j = 0; j < TL::kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = k_total / kBK;
  al.load(sm.a[0], 0);
  load_w<BN>(sm.b[0], w, nout, 0, n0, k_total);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) {
      al.load(sm.a[s ^ 1], (kt + 1) * kBK);
      load_w<BN>(sm.b[s ^ 1], w, nout, (kt + 1) * kBK, n0, k_total);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[TL::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfr[TL::kFN];
#pragma unroll
      for (int i = 0; i < TL::kFM; ++i)
        wmma::load_matrix_sync(
            af[i], sm.a[s] + (wm * TL::kWM + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < TL::kFN; ++j)
        wmma::load_matrix_sync(
            bfr[j], sm.b[s] + kk * TL::kBLd + wn * TL::kWN + j * 16, TL::kBLd);
#pragma unroll
      for (int i = 0; i < TL::kFM; ++i)
#pragma unroll
        for (int j = 0; j < TL::kFN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time; a lane owns
  // 8 consecutive columns of one row and writes them as one 16-byte store
  float* ep = sm.epi[warp];
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < TL::kFM; ++i) {
#pragma unroll
    for (int j = 0; j < TL::kFN; ++j) {
      wmma::store_matrix_sync(ep, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * TL::kWM + i * 16 + r;
      const int gn = n0 + wn * TL::kWN + j * 16 + c8;
      if (gm < m) {
        float v[8];
        for (int e = 0; e < 8; ++e)
          v[e] = ep[r * 16 + c8 + e] * scale[gn + e] + bias[gn + e];
        alignas(16) bf16 o[8];
        for (int e = 0; e < 8; ++e)
          o[e] = __float2bfloat16_rn(relu ? fmaxf(v[e], 0.0f) : v[e]);
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(gm) * nout + gn) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

}  // namespace vcg
