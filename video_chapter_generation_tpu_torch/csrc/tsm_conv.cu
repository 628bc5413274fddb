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
// (store_tile).
#include <algorithm>

#include "hopper_gemm.cuh"

namespace vcg {
namespace {

using namespace hop;

constexpr int kConvStages = 4;


// The operands of K5: A = shift(x) rows [m0, m0 + 128) as the K-major A
// tile, B = w [C][F], both 128-byte-swizzled. W always comes by TMA. A
// stage of A whose 64 channels all come from one frame offset (none, +1
// or -1 frame: every stage when fold % 64 == 0) is one TMA box of x
// viewed as [M][C] at row m0 + offset; rows past x read zeros, and
// xform zeroes the rows whose shift leaves their clip. A stage that
// mixes offsets (C = 64 or 256: fold < 64) is copied by cp.async, thread
// i taking chunk i % 8 of rows i / 8 + 32 j, zero-filled where the shift
// leaves the clip.
template <int BN>
struct ShiftSrc {
  static constexpr int kStageBytes = kATile + BN * 128;
  static constexpr bool kTma = true;
  const bf16* x;
  const CUtensorMap* xmap;  // x as [M][C], boxes 128 rows x 64 channels
  const CUtensorMap* wmap;  // w as [C][F], boxes 64 x 64
  int m, c, f, plane, t, fold, ntn;  // ntn: column tiles

  // the frame offset of every channel of the stage from k0 (0, +1 or -1
  // frame: region 0, 1, 2), or -1 where the stage mixes them
  __device__ int region(int k0) const {
    if (fold == 0 || k0 >= 2 * fold) return 0;
    if (fold % kHBK) return -1;
    return k0 < fold ? 1 : 2;
  }

  __device__ int row0(int tile) const {
    return (static_cast<int>(blockIdx.x + tile * gridDim.x) / ntn) * kBM;
  }

  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    const int k0 = kt * kHBK;
    const int m0 = row0(tile);
    const int n0 = ((blockIdx.x + tile * gridDim.x) % ntn) * BN;
    const int reg = region(k0);
    if (threadIdx.x == 0) {
      mbar_expect(bar, BN * 128 + (reg >= 0 ? kATile : 0));
      if (reg >= 0)
        tma_load(st, xmap, k0, m0 + (reg == 1 ? plane : reg == 2 ? -plane : 0),
                 bar);
    }
    tma_w<BN>(st + kATile, wmap, k0, n0, bar, 1);
    if (reg >= 0) return;
    const int kc = threadIdx.x & 7;
    const int ch = k0 + kc * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (threadIdx.x >> 3) + 32 * j;
      int src = m0 + r;
      bool ok = src < m && ch < c;
      if (ch < 2 * fold) {
        const int tt = (src / plane) % t;
        const bool fwd = ch < fold;
        ok = ok && (fwd ? tt < t - 1 : tt > 0);
        src += fwd ? plane : -plane;
      }
      cp_async16(st + swz(r, kc),
                 ok ? x + static_cast<size_t>(src) * c + ch : x, ok);
    }
  }

  // A stage that came by TMA from a shifted offset: zero the rows whose
  // frame t + 1 (region 1) or t - 1 (region 2) lies outside their clip.
  __device__ void xform(uint8_t* st, int tile, int kt) const {
    const int reg = region(kt * kHBK);
    if (reg <= 0) return;
    const int m0 = row0(tile);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (threadIdx.x >> 3) + 32 * j;
      const int tt = ((m0 + r) / plane) % t;
      if (tt == (reg == 1 ? t - 1 : 0))
        *reinterpret_cast<uint4*>(st + swz(r, threadIdx.x & 7)) =
            make_uint4(0, 0, 0, 0);
    }
  }
};

// The epilogue: y = v * scale + bias, then the ReLU (store_tile's
// affine; scale and bias 8-byte aligned).
struct ScaleBias {
  const float* scale;
  const float* bias;
  int relu;
  __device__ void operator()(int c, float (&y)[4]) const {
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    y[0] = fmaf(y[0], s.x, b.x);
    y[1] = fmaf(y[1], s.y, b.y);
    y[2] = fmaf(y[2], s.x, b.x);
    y[3] = fmaf(y[3], s.y, b.y);
    if (relu)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = fmaxf(y[e], 0.0f);
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    tsm_conv1x1_kernel(ShiftSrc<BN> src, ScaleBias aff, bf16* out, int tiles,
                       const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap) {
  __shared__ alignas(8) uint64_t bars[kConvStages];
  uint8_t* sm = aligned_smem();
  using ML = Mainloop<BN, kConvStages, 0, ShiftSrc<BN>, true>;
  uint8_t* stg = sm + ML::kRingBytes + (threadIdx.x >> 5) * 1024;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  src.xmap = &xmap;
  src.wmap = &wmap;
  if (threadIdx.x == 0) {
    tma_prefetch(&xmap);
    tma_prefetch(&wmap);
  }
  ML ml(sm, bars, src, mine, (src.c + kHBK - 1) / kHBK);
  float acc[BN / 2];
  for (int i = 0; i < mine; ++i) {
    ml.tile(acc);
    const int tg = blockIdx.x + i * gridDim.x;
    store_tile<BN>(stg, acc, aff, out, src.f,
                   (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16, src.m,
                   (tg % src.ntn) * BN, nullptr, nullptr);
  }
  ml.finish();
}

template <int BN>
int launch(const ShiftSrc<BN>& src, const ScaleBias& aff, bf16* out,
           const bf16* w, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  cudaError_t e = tensor_map(&xmap, src.x, src.m, src.c, kBM);
  if (e == cudaSuccess) e = tensor_map(&wmap, w, src.c, src.f, kHBK);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = tsm_conv1x1_kernel<BN>;
  const int smem = kConvStages * ShiftSrc<BN>::kStageBytes + kStoreBytes +
                   kAlignSlack;
  // the blocks the card holds at once, found on the first launch on a
  // device (the attribute and the occupancy query cost host time)
  static int known_dev = -1, resident = 0;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != known_dev) {
    int sms = 0, per_sm = 0;
    e = allow_smem<tsm_conv1x1_kernel<BN>>(smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    resident = per_sm * sms;
    known_dev = dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (src.m + kBM - 1) / kBM * src.ntn;
  const int grid = std::max(1, std::min(tiles, resident));
  kernel<<<grid, kThreads, smem, st>>>(src, aff, out, tiles, xmap, wmap);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int run(const void* x, const void* w, const float* scale, const float* bias,
        void* out, int n, int h, int wd, int c, int f, int t, int fold,
        int relu, cudaStream_t st) {
  ShiftSrc<BN> src{};
  src.x = static_cast<const bf16*>(x);
  src.m = n * h * wd;
  src.c = c;
  src.f = f;
  src.plane = h * wd;
  src.t = t;
  src.fold = fold;
  src.ntn = f / BN;
  return launch<BN>(src, ScaleBias{scale, bias, relu},
                    static_cast<bf16*>(out), static_cast<const bf16*>(w), st);
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
  if (f % 256 == 0)
    return vcg::run<256>(x, w, s, b, out, n, h, wd, c, f, t, fold, relu, st);
  if (f % 128 == 0)
    return vcg::run<128>(x, w, s, b, out, n, h, wd, c, f, t, fold, relu, st);
  return vcg::run<64>(x, w, s, b, out, n, h, wd, c, f, t, fold, relu, st);
}
