// Temporal shift + 1x1 convolution (K5) for Hopper (sm_90a).
//
// Replaces video_chapter_generation_tpu/ops/tsm_conv_pallas.py:
//   tsm_conv1x1_bn_relu_pallas (inference, folded BN + ReLU epilogue)
//   tsm_conv1x1_pallas          (training forward, no epilogue)
//
//   y = act(shift(x) @ W * scale + bias)     x [N*T, H, W, C], W [C, F]
//
// The TPU kernel picks between a base-plus-correction product and three
// sliced products by the 128-lane alignment of the shift fold; both exist
// for the MXU only. Here the shift costs nothing: A is a pure copy of x
// whose fold-0 channels come from frame t + 1 and fold-1 channels from
// frame t - 1, straight into the swizzled ring of hopper_gemm.cuh (zeros
// at the clip ends), so the shifted tensor is never written. Products accumulate in fp32 and
// round once to bf16 after the epilogue; the training entry passes a unit
// scale and a zero bias (exact in fp32), so it stores the bare product.
//
// What bounds it on the H100: bytes. A tile does 2 F flops per 2 bytes of
// x it reads, so at F <= 512 the product stays below the card's ~295
// flop/byte ridge and the time is x read once (per column tile: the
// column tiles of one row tile run side by side, so the second read comes
// from L2) plus y written once. The design keeps bytes in flight: a
// persistent grid (as many blocks as fit on the card) walks the
// [M / 128] x [F / BN] tiles, tile index = m_tile * (F / BN) + n_tile, and
// its loads run two 64-deep stages ahead across tile boundaries, so at
// C = 64 (one stage a tile) the next tiles' x arrives while this tile's
// wgmmas and epilogue run; a stage's product stays in flight while the
// next stage is waited for (a fourth slot). W, and every stage of x whose 64 channels
// share one frame offset, come as TMA boxes; BN = 256 where F allows it
// (layers 3-4) reads x fewer times. The epilogue (scale, bias, ReLU) runs
// on the accumulator registers and stores whole 128-byte row segments
// (store_tile). conv1 of every serving bottleneck (K2-K4) is a launch of
// this kernel; its operand source, tile walk and epilogue live in
// tsm_tiles.cuh, so K15's conv1 phases run the same tiles.
#include <algorithm>

#include "tsm_tiles.cuh"

namespace vcg {
namespace {

using namespace hop;

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    tsm_conv1x1_kernel(ShiftSrc<BN> src, ScaleBias aff, bf16* out, int tiles,
                       const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap) {
  __shared__ alignas(8) uint64_t bars[kConvStages];
  src.xmap = &xmap;
  src.wmap = &wmap;
  if (threadIdx.x == 0) {
    tma_prefetch(&xmap);
    tma_prefetch(&wmap);
  }
  shift_tiles<BN>(aligned_smem(), bars, src, aff, out, tiles);
}

template <int BN>
int launch(const ShiftSrc<BN>& src, const ScaleBias& aff, bf16* out,
           const bf16* w, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  cudaError_t e = tensor_map(&xmap, src.x, src.m, src.c, kBM);
  if (e == cudaSuccess) e = tensor_map(&wmap, w, src.c, src.f, kHBK);
  int held = 0;
  if (e == cudaSuccess)
    e = resident<tsm_conv1x1_kernel<BN>>(shift_smem<BN>(), &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (src.m + kBM - 1) / kBM * src.ntn;
  const int grid = std::max(1, std::min(tiles, held));
  tsm_conv1x1_kernel<BN><<<grid, kThreads, shift_smem<BN>(), st>>>(
      src, aff, out, tiles, xmap, wmap);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int run(const void* x, const void* w, const float* scale, const float* bias,
        void* out, int n, int h, int wd, int c, int f, int t, int fold,
        int relu, cudaStream_t st) {
  return launch<BN>(
      shift_src<BN>(static_cast<const bf16*>(x), n * h * wd, h * wd, c, f, t,
                    fold),
      ScaleBias{scale, bias, relu}, static_cast<bf16*>(out),
      static_cast<const bf16*>(w), st);
}

}  // namespace
}  // namespace vcg

// x [n, h, w, c] bf16 (n = clips * t, frames time-major), w [c, f] bf16,
// scale/bias [f] float32 (8-byte aligned), out [n, h, w, f] bf16. c % 8
// == 0, f % 64 == 0 and fold % 8 == 0 (fold 0: no shift); the caller
// checks.
extern "C" int vcg_tsm_conv1x1(const void* x, const void* w,
                               const void* scale, const void* bias, void* out,
                               int n, int h, int wd, int c, int f, int t,
                               int fold, int relu, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vcg::hop::shift_bn(f)) {
    case 256:
      return vcg::run<256>(x, w, s, b, out, n, h, wd, c, f, t, fold, relu, st);
    case 128:
      return vcg::run<128>(x, w, s, b, out, n, h, wd, c, f, t, fold, relu, st);
    default:
      return vcg::run<64>(x, w, s, b, out, n, h, wd, c, f, t, fold, relu, st);
  }
}
