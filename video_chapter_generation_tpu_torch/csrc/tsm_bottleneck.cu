// Inference TSM bottleneck for Hopper (sm_90a), stride 1 and stride 2:
// kernels K2/K3 and K4.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_pallas.py:
//   tsm_bottleneck_pallas (_kernel, _kernel_flat)             -> stride 1
//   tsm_bottleneck_s2_pallas / _s2_planar_pallas (_kernel_s2,
//   _kernel_s2_planar)                                        -> stride 2
// The planar input of the TPU kernel is a row-major view of NHWC, so one
// stride-2 entry reading NHWC serves both.
//
//   y1  = relu(bn1(conv1x1(shift(x))))        K5's kernel (tsm_conv.cu)
//   y2  = relu(bn2(conv3x3(y1, stride)))
//   res = x, or bn_p(conv1x1(x, stride))      projection on the unshifted x
//   out = relu(bn3(conv1x1(y2)) + res)
//
// Design: one persistent launch a conv on hopper_gemm.cuh's wgmma
// mainloop, the tiles of tsm_tiles.cuh (ConvSrc). The wrapper
// (ops/tsm_block.py) launches conv1 as K5 itself; the entries here run
// conv2, conv3 and the projection on its y1:
//   - conv2 at stride 1: each 64-deep stage lies inside one tap, and is
//     the dense [M][F] view of y1 shifted by dh W + dw rows: one TMA box,
//     the rows whose tap leaves the image zeroed on arrival (y1 is
//     already activated, so the zero padding is a zero row). At stride 2
//     (K4) the rows are strided: cp.async, the pixels decoded once a
//     tile and the tap once a stage;
//   - conv3: y2 as a dense TMA A; its residual tile (x, or the
//     projection's r) comes by TMA into the slot of the tile's last
//     stage and is added in the epilogue's affine before the ReLU,
//     rounded once to bf16;
//   - the projection at stride 1 (layer 1's block0): a second
//     accumulation in conv3's tile (pair_kernel: x by TMA after y2, then
//     bn3 and bnp in the registers), so r (0.41 GB at 256 frames) is
//     neither written nor read back, which timed faster than its own
//     launch. At stride 2 (the K4 blocks) its gather in conv3's
//     one-block-an-SM ring timed slower than its own launch (two blocks
//     an SM) writing r, so it keeps the launch.
// Tile widths: BN = 256 where nout allows and the tiles fill their waves
// (conv_bn in tsm_tiles.cuh: layer 4's conv2 takes 128), 128 at most for
// conv3 (the residual tile shares the slot). Weights come by TMA.
//
// What bounds it on the H100: per block, layer 1 by bytes (x and out,
// 0.41 GB each at 256 frames), layers 3-4 by the products (2 M (C F +
// 9 F^2 + 4 F^2 [+ 4 C F]) flops at a few hundred flops a byte). What
// bounds the kernels themselves (chip_smoke.py's split, PERF.md): conv3
// at layers 1-2 runs near the byte rate (x in, out back); conv2 and the
// deeper conv3s at 2-5x their bound. Neither a deeper ring nor two
// k-blocks a stage moved them, a second block on the SM did: the cost
// of a stage beside its product (barrier, waits, the epilogue between
// tiles) is the suspect; the 3x3 also reads each row of y1 from L2 once
// a tap. Not profiled further.
#include <algorithm>

#include "tsm_tiles.cuh"

namespace vcg {
namespace {

using namespace hop;

template <int BN, bool kRes>
__global__ void __launch_bounds__(kThreads, ConvRing<BN, kRes>::kBlocks)
    conv_kernel(ConvSrc<BN, kRes> src, ScaleBias aff, bf16* out, int tiles,
                const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap rmap) {
  __shared__ alignas(8) uint64_t bars[ConvRing<BN, kRes>::kStages];
  src.xmap = &xmap;
  src.wmap = &wmap;
  src.rmap = &rmap;
  if (threadIdx.x == 0) {
    if (src.stride == 1) tma_prefetch(&xmap);
    tma_prefetch(&wmap);
    if (kRes) tma_prefetch(&rmap);
  }
  conv_tiles<BN, kRes>(aligned_smem(), bars, src, aff, out, tiles);
}

// conv3 with the projection in its tile: stages 0 .. a.ktiles - 1 bring
// y2 (a: a dense TMA A) and w3 into acc, the rest bring x at the block's
// stride (b: a dense TMA A at stride 1, a gather at stride 2) and wp into
// a second accumulator.
template <int BN>
struct PairSrc {
  static constexpr int kStageBytes = ConvSrc<BN, false>::kStageBytes;
  static constexpr bool kTma = true;
  ConvSrc<BN, false> a, b;
  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    if (kt < a.ktiles)
      a.load(st, bar, tile, kt);
    else
      b.load(st, bar, tile, kt - a.ktiles);
  }
  __device__ void xform(uint8_t*, int, int) {}
};

constexpr int kPairStages = 4;

template <int BN>
constexpr int pair_smem() {
  return kPairStages * PairSrc<BN>::kStageBytes + kStoreBytes + kAlignSlack;
}

// The block's two folded BNs at the end: s3, b3 of conv3, sp, bp of the
// projection.
struct TwoAffines {
  const float *s3, *b3, *sp, *bp;
};

struct Relu {
  __device__ void operator()(int, float (&y)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = fmaxf(y[e], 0.0f);
  }
};

// out = relu(bn3(y2 w3) + bnp(x wp)): both products accumulate in fp32,
// are combined in wgmma's register layout (store_tile's: accumulators
// 4 j .. 4 j + 3 of a lane are columns 8 j + 2 (lane % 4) and the next,
// rows r and r + 8) and rounded once to bf16.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    pair_kernel(PairSrc<BN> src, TwoAffines aff, bf16* out, int tiles,
                const __grid_constant__ CUtensorMap ymap,
                const __grid_constant__ CUtensorMap w3map,
                const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wpmap) {
  __shared__ alignas(8) uint64_t bars[kPairStages];
  src.a.xmap = &ymap;
  src.a.wmap = &w3map;
  src.b.xmap = &xmap;
  src.b.wmap = &wpmap;
  if (threadIdx.x == 0) {
    tma_prefetch(&ymap);
    tma_prefetch(&w3map);
    if (src.b.stride == 1) tma_prefetch(&xmap);
    tma_prefetch(&wpmap);
  }
  uint8_t* sm = aligned_smem();
  using ML = Mainloop<BN, kPairStages, 0, PairSrc<BN>>;
  uint8_t* stg = sm + ML::kRingBytes + (threadIdx.x >> 5) * 1024;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  const int ntn = src.a.ntn;
  ML ml(sm, bars, src, mine, src.a.ktiles + src.b.ktiles);
  float acc[BN / 2], acc2[BN / 2];
  for (int i = 0; i < mine; ++i) {
    ml.tile2(acc, acc2, src.a.ktiles);
    const int tg = blockIdx.x + i * gridDim.x;
    const int n0 = (tg % ntn) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (threadIdx.x & 3);
      const float2 s3 = __ldg(reinterpret_cast<const float2*>(aff.s3 + col));
      const float2 b3 = __ldg(reinterpret_cast<const float2*>(aff.b3 + col));
      const float2 sp = __ldg(reinterpret_cast<const float2*>(aff.sp + col));
      const float2 bp = __ldg(reinterpret_cast<const float2*>(aff.bp + col));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        acc[4 * j + e] =
            fmaf(acc[4 * j + e], odd ? s3.y : s3.x, odd ? b3.y : b3.x) +
            fmaf(acc2[4 * j + e], odd ? sp.y : sp.x, odd ? bp.y : bp.x);
      }
    }
    store_tile<BN>(stg, acc, Relu{}, out, src.a.nout,
                   (tg / ntn) * kBM + (threadIdx.x >> 5) * 16, src.a.m, n0,
                   nullptr, nullptr);
  }
  ml.finish();
}

template <int BN>
int launch_pair(PairSrc<BN> src, const TwoAffines& aff, bf16* out,
                const bf16* w3, const bf16* wp, cudaStream_t st) {
  CUtensorMap ymap{}, w3map{}, xmap{}, wpmap{};
  cudaError_t e = tensor_map(&ymap, src.a.x, src.a.m, src.a.c, kBM);
  if (e == cudaSuccess)
    e = tensor_map(&w3map, w3, src.a.c, src.a.nout, kHBK);
  if (e == cudaSuccess && src.b.stride == 1)
    e = tensor_map(&xmap, src.b.x, src.b.m, src.b.c, kBM);
  if (e == cudaSuccess)
    e = tensor_map(&wpmap, wp, src.b.c, src.b.nout, kHBK);
  int held = 0;
  if (e == cudaSuccess) e = resident<pair_kernel<BN>>(pair_smem<BN>(), &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (src.a.m + kBM - 1) / kBM * src.a.ntn;
  const int grid = std::max(1, std::min(tiles, held));
  pair_kernel<BN><<<grid, kThreads, pair_smem<BN>(), st>>>(
      src, aff, out, tiles, ymap, w3map, xmap, wpmap);
  return static_cast<int>(cudaGetLastError());
}

// out = relu(bn3(conv1x1(y2)) + bnp(conv1x1(x, stride))): y2 [n, ho, wo,
// f], x [n, h, w, c], at conv3's tile width
int conv3_proj(const void* y2, const void* x, const void* w3, const void* wp,
               const TwoAffines& aff, void* out, int n, int h, int wd, int c,
               int f, int cout, int stride, int sms, cudaStream_t st) {
  const bf16* yb = static_cast<const bf16*>(y2);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w3b = static_cast<const bf16*>(w3);
  const bf16* wpb = static_cast<const bf16*>(wp);
  bf16* ob = static_cast<bf16*>(out);
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  if (conv_bn(n * ho * wo, cout, sms, true) == 128)
    return launch_pair(
        PairSrc<128>{conv_src<128, false>(yb, n, ho, wo, f, 1, 1, cout),
                     conv_src<128, false>(xb, n, h, wd, c, 1, stride, cout)},
        aff, ob, w3b, wpb, st);
  return launch_pair(
      PairSrc<64>{conv_src<64, false>(yb, n, ho, wo, f, 1, 1, cout),
                  conv_src<64, false>(xb, n, h, wd, c, 1, stride, cout)},
      aff, ob, w3b, wpb, st);
}

template <int BN, bool kRes>
int launch(ConvSrc<BN, kRes> src, const ScaleBias& aff, bf16* out,
           const bf16* w, const bf16* res, cudaStream_t st) {
  CUtensorMap xmap{}, wmap{}, rmap{};
  cudaError_t e = cudaSuccess;
  if (src.stride == 1)
    e = tensor_map(&xmap, src.x,
                   static_cast<uint64_t>(src.m), src.c, kBM);
  if (e == cudaSuccess)
    e = tensor_map(&wmap, w, src.ktiles * kHBK, src.nout, kHBK);
  if (e == cudaSuccess && kRes)
    e = tensor_map(&rmap, res, src.m, src.nout, kBM);
  int held = 0;
  if (e == cudaSuccess)
    e = resident<conv_kernel<BN, kRes>>(conv_smem<BN, kRes>(), &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (src.m + kBM - 1) / kBM * src.ntn;
  const int grid = std::max(1, std::min(tiles, held));
  conv_kernel<BN, kRes><<<grid, kThreads, conv_smem<BN, kRes>(), st>>>(
      src, aff, out, tiles, xmap, wmap, rmap);
  return static_cast<int>(cudaGetLastError());
}

// out [m][nout] = act(conv(x) * scale + bias [+ res]) over x [n, h, w, c],
// ks 1 or 3 (pad ks / 2), at the tile width of conv_bn.
int conv(const void* x, const void* w, const void* scale, const void* bias,
         const void* res, void* out, int n, int h, int wd, int c, int ks,
         int stride, int nout, int relu, int sms, cudaStream_t st) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* rb = static_cast<const bf16*>(res);
  bf16* ob = static_cast<bf16*>(out);
  const ScaleBias aff{static_cast<const float*>(scale),
                      static_cast<const float*>(bias), relu};
  const int m = n * ((h - 1) / stride + 1) * ((wd - 1) / stride + 1);
  const bool with_res = res != nullptr;
  switch (conv_bn(m, nout, sms, with_res)) {
    case 256:
      return launch(conv_src<256, false>(xb, n, h, wd, c, ks, stride, nout),
                    aff, ob, wb, nullptr, st);
    case 128:
      if (with_res)
        return launch(conv_src<128, true>(xb, n, h, wd, c, ks, stride, nout),
                      aff, ob, wb, rb, st);
      return launch(conv_src<128, false>(xb, n, h, wd, c, ks, stride, nout),
                    aff, ob, wb, nullptr, st);
    default:
      if (with_res)
        return launch(conv_src<64, true>(xb, n, h, wd, c, ks, stride, nout),
                      aff, ob, wb, rb, st);
      return launch(conv_src<64, false>(xb, n, h, wd, c, ks, stride, nout),
                    aff, ob, wb, nullptr, st);
  }
}

int run_bottleneck(const void* y1, const void* x, const void* w2,
                   const void* w3, const void* wp, const void* s2,
                   const void* b2, const void* s3, const void* b3,
                   const void* sp, const void* bp, void* y2, void* r,
                   void* out, int n, int h, int w, int c, int f, int cout,
                   int stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ho = (h - 1) / stride + 1;
  const int wo = (w - 1) / stride + 1;
  int rc = conv(y1, w2, s2, b2, nullptr, y2, n, h, w, f, 3, stride, f, 1, sms,
                st);
  if (rc != 0) return rc;
  if (wp == nullptr)
    return conv(y2, w3, s3, b3, x, out, n, ho, wo, f, 1, 1, cout, 1, sms, st);
  if (stride == 2) {
    rc = conv(x, wp, sp, bp, nullptr, r, n, h, w, c, 1, 2, cout, 0, sms, st);
    if (rc != 0) return rc;
    return conv(y2, w3, s3, b3, r, out, n, ho, wo, f, 1, 1, cout, 1, sms, st);
  }
  const TwoAffines aff{static_cast<const float*>(s3),
                       static_cast<const float*>(b3),
                       static_cast<const float*>(sp),
                       static_cast<const float*>(bp)};
  return conv3_proj(y2, x, w3, wp, aff, out, n, h, w, c, f, cout, stride, sms,
                    st);
}

}  // namespace
}  // namespace vcg

// The block after its conv1: y1 [n, h, w, f] = relu(bn1(conv1x1(shift(x))))
// (K5's launch), x [n, h, w, c]; w2 [3, 3, f, f] HWIO, w3 [f, cout],
// wp [c, cout] or null (then the residual is x: stride 1, cout == c); the
// BN scales and biases [f] / [cout] float32, 8-byte aligned; scratch y2
// [n, ho, wo, f]; out [n, ho, wo, cout] bf16. c, f and cout % 64 == 0;
// the caller checks.
extern "C" int vcg_tsm_bottleneck_s1(
    const void* y1, const void* x, const void* w2, const void* w3,
    const void* wp, const void* s2, const void* b2, const void* s3,
    const void* b3, const void* sp, const void* bp, void* y2, void* r,
    void* out, int n, int h, int w, int c, int f, int cout, void* stream) {
  return vcg::run_bottleneck(y1, x, w2, w3, wp, s2, b2, s3, b3, sp, bp, y2,
                             r, out, n, h, w, c, f, cout, 1, stream);
}

extern "C" int vcg_tsm_bottleneck_s2(
    const void* y1, const void* x, const void* w2, const void* w3,
    const void* wp, const void* s2, const void* b2, const void* s3,
    const void* b3, const void* sp, const void* bp, void* y2, void* r,
    void* out, int n, int h, int w, int c, int f, int cout, void* stream) {
  return vcg::run_bottleneck(y1, x, w2, w3, wp, s2, b2, s3, b3, sp, bp, y2,
                             r, out, n, h, w, c, f, cout, 2, stream);
}
