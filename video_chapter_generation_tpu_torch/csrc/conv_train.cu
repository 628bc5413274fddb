// Training-mode TSM bottleneck for Hopper (sm_90a), forward and backward,
// stride 1 and stride 2, with or without the projection residual, and
// the links that fuse one block of the training trunk into the next.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_train_pallas.py:
//   tsm_bottleneck_train, tsm_bottleneck_proj_train and
//   tsm_bottleneck_s2_train (the FK1/FK2/FK3 forward kernels and the
//   BK3/BK2/BK1 backward kernels of _forward, _forward_s2, _backward and
//   _backward_s2), and the cross-block fusion of tsm_trunk_train_pallas.py
//   (FK1 and BK1/BK1_s2 with prev).
//
// Forward of a block (vcg_block_train_fwd, 4-7 launches on the caller's
// stream):
//   u  = conv1x1(shift(x))                + moments of u       (FK1)
//   pr = conv1x1(x, stride)               + moments of pr      (projection)
//   z  = conv3x3(relu(bn1(u)), stride)    + moments of z       (FK2)
//   p  = conv1x1(relu(bn2(z)))            + moments of p       (FK3)
// with the batch statistics finalized between the GEMMs on the device,
// then the finale y = relu(bn3(p) + (x or bnp(pr))) (vcg_finale_fwd).
// Backward: the finale's relu mask and the BN3/BNp backward moments
// (vcg_finale_bwd), then (vcg_block_train_bwd) per conv a weight-gradient
// GEMM (split over pixels, float32 partial sums) and a data-gradient GEMM
// whose epilogue applies the next ReLU mask and takes the next BN's
// backward moments; conv1's data gradient undoes the shift in its
// epilogue and adds the residual gradient. Every BN backward is applied
// on load (GradXf).
//
// The trunk (ops/tsm_trunk_train.py) runs the finale of block N-1 inside
// block N's conv1 instead (vcg_trunk_link_fwd: the loader computes x_N
// from p and r of block N-1 and writes it once), and block N's conv1 data
// gradient finishes block N-1's finale backward in its epilogue
// (vcg_trunk_link_bwd: relu mask of x_N, dq of block N-1 and its BN3/BNp
// moments), so only the top block launches the two finale kernels.
//
// Design (Hopper): the forward, data-gradient and weight-gradient GEMMs
// run on hopper_gemm.cuh's mainloop, wgmma m64nBNk16 from 128-byte-
// swizzled shared memory. Every operand arrives raw (x; p and r for the
// link; da and v for a gradient) and is transformed on the arrived stage
// just before the product (BN + ReLU, the finale, the BN backward ga * da
// + ge * v + gf). Weights, and operands that are plain [rows][channels]
// tiles (1x1 stride-1 convs of an unshifted input, the stride-2
// projection's gradient, every weight gradient's G), come as TMA boxes;
// gathers (3x3 taps, the shift, the link) by cp.async. Forward and
// data-gradient blocks own one 128-row tile (BN 64 or 128 columns), so
// their per-block moment rows and reduce_rows are as before; the forward
// stores and takes its moments straight from the accumulator registers
// (store_tile). A stride-2 data gradient skips the products that are zero
// by construction: the 1x1 projection's runs over the output pixels, the
// 3x3's over one parity class of input pixels a blockIdx.z with only the
// taps that reach it (a quarter of the work each). The weight gradient
// reads both operands MN-major (pixels, the reduction, are the rows of
// both), split over pixel ranges into float32 slices summed in order; the
// moment sums run in a fixed order too: no float atomics anywhere.
//
// What bounds it on the H100: bytes. A block's forward does 2 * M * (C*F
// + 9*F*F + F*4F [+ C*4F]) flops and twice that backward; at layer 1 and
// 128 frames that is ~56 GFLOP against ~0.72 GB read and written once (x
// in; u, z, p and y out), ~78 flop/byte, below the card's ~295 flop/byte
// ridge. Each deeper layer halves the activation bytes for the same flops
// (layer 4 is above the ridge), and a whole step, summed as chip_smoke.py
// counts it, is bound by bytes.
#include <algorithm>
#include <initializer_list>

#include "hopper_gemm.cuh"
#include "train_gemm.cuh"

namespace vcg {

using namespace hop;

// Ring depths: the forward keeps two blocks an SM at three stages; the
// gradients stage twice the bytes (a raw operand beside each tile), so
// two stages keep two blocks an SM.
constexpr int kFwdStages = 3;
constexpr int kGradStages = 2;

// ---------------------------------------------------------------------------
// Operand sources of the mainloop (hopper_gemm.cuh). Each block owns one
// 128-row tile; thread i copies chunk i % 8 of tile rows i / 8 + 32 j,
// j < 4, of every A stage, and recomputes where a chunk came from when it
// transforms it (at(): false where the operand is zero).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int a_row(int j) {
  return (threadIdx.x >> 3) + 32 * j;
}

__device__ __forceinline__ uint4& chunk_at(uint8_t* tile, int j) {
  return *reinterpret_cast<uint4*>(tile + swz(a_row(j), threadIdx.x & 7));
}

// Forward A: an activation (ActXf: the shift, or the previous BN + ReLU),
// rows the output pixels of g, k = (kh, kw, c). Padding is zero after
// the transform, as in the reference.
struct ActPart {
  static constexpr int kAux = 0;
  static constexpr bool kGrad = false;
  ActXf a;
  ConvGeo g;
  const CUtensorMap* amap;  // a.x as [n h w][c], boxes 128 x 64
  int m0;
  int rn[4], roh[4], row_[4];
  bool rok[4];

  // A 1x1 stride-1 conv of an unshifted x reads a dense [M][C] tile: one
  // TMA box (rows past M read zeros and are not transformed)
  __device__ bool dense() const {
    return g.ks == 1 && g.stride == 1 && g.pad == 0 && a.fold == 0;
  }
  __device__ int tma_bytes() const { return dense() ? kATile : 0; }
  __device__ void tma(uint8_t* st, uint8_t*, int k0, uint64_t* bar) const {
    if (tma_lane(2, 0)) tma_load(st, amap, k0, m0, bar);
  }
  __device__ void use_map(const CUtensorMap* m) { amap = m; }

  __device__ void init(int m0_) {
    m0 = m0_;
    const int plane = g.ho * g.wo;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0_ + a_row(j);
      rok[j] = m < g.m;
      const int mm = rok[j] ? m : 0;
      rn[j] = mm / plane;
      const int rem = mm - rn[j] * plane;
      roh[j] = rem / g.wo;
      row_[j] = rem - roh[j] * g.wo;
    }
  }

  // The tap (kh, kw) and channel of this thread's chunk at k0.
  __device__ bool tap(int k0, int& kh, int& kw, int& ch) const {
    const int k = k0 + (threadIdx.x & 7) * 8;
    if (k >= g.k) return false;
    const int t = k / g.c;
    ch = k - t * g.c;
    kh = t / g.ks;
    kw = t - kh * g.ks;
    return true;
  }

  __device__ bool at(int j, int kh, int kw, int ch, size_t& off) const {
    if (!rok[j]) return false;
    const int ih = roh[j] * g.stride - g.pad + kh;
    const int iw = row_[j] * g.stride - g.pad + kw;
    if (ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return false;
    int nn = rn[j];
    if (a.fold && ch < 2 * a.fold) {
      const int tt = nn % a.t;
      if (ch < a.fold) {
        if (tt == a.t - 1) return false;
        ++nn;
      } else {
        if (tt == 0) return false;
        --nn;
      }
    }
    off = ((static_cast<size_t>(nn) * g.h + ih) * g.w + iw) * g.c + ch;
    return true;
  }

  __device__ int w_row(int k0) const { return k0; }

  // The cp.async copies of this thread's chunks (none for a dense stage,
  // which comes by TMA).
  __device__ void load(uint8_t* st, uint8_t*, int k0) const {
    int kh = 0, kw = 0, ch = 0;
    const bool kok = tap(k0, kh, kw, ch);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      size_t off = 0;
      const bool ok = kok && at(j, kh, kw, ch, off);
      cp_async16(&chunk_at(st, j), a.x + off, ok);
    }
  }

  __device__ void xform(uint8_t* st, uint8_t*, int k0) const {
    int kh, kw, ch;
    if (a.sa == nullptr || !tap(k0, kh, kw, ch)) return;
    float sa[8], sb[8];
    vec8(a.sa + ch, sa);
    vec8(a.sb + ch, sb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      size_t off;
      if (!at(j, kh, kw, ch, off)) continue;
      float v[8];
      unpack8(chunk_at(st, j), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(fmaf(v[e], sa[e], sb[e]), 0.0f);
      chunk_at(st, j) = pack8(v);
    }
  }
};

// The trunk's forward link (tsm_trunk_train_pallas.py: _fk1 with prev):
// the A operand of block N's conv1 is shift(x) with x = block N-1's
// finale of (p, r); p and r arrive raw (r beside the A tile) and the
// finale runs on the arrived stage. x itself is written to x_out once, by
// the blocks of column tile 0. The chunk of row m at channel ch reads
// frame src = the frame the shift takes it from; at a clip edge, where
// the shift reads zero, src wraps to the clip's other end and the value
// is written to x_out but not used. The map (row, ch) -> (src, ch) is one
// to one, so every element of x_out is written exactly once.
struct LinkPart {
  static constexpr int kAux = kATile;
  static constexpr bool kGrad = false;
  __device__ bool dense() const { return false; }
  __device__ int tma_bytes() const { return 0; }
  __device__ void tma(uint8_t*, uint8_t*, int, uint64_t*) const {}
  __device__ void use_map(const CUtensorMap*) {}
  LinkXf a;
  ConvGeo g;
  int rn[4], rpix[4];
  bool rok[4];

  __device__ void init(int m0) {
    const int plane = g.h * g.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + a_row(j);
      rok[j] = m < g.m;
      const int mm = rok[j] ? m : 0;
      rn[j] = mm / plane;
      rpix[j] = mm - rn[j] * plane;
    }
  }

  __device__ bool at(int j, int k0, size_t& off, int& ch, bool& use) const {
    ch = k0 + (threadIdx.x & 7) * 8;
    if (!rok[j] || ch >= g.c) return false;
    int nn = rn[j];
    use = true;
    if (a.fold && ch < 2 * a.fold) {
      const int tt = nn % a.t;
      if (ch < a.fold) {
        use = tt < a.t - 1;
        nn += use ? 1 : 1 - a.t;
      } else {
        use = tt > 0;
        nn += use ? -1 : a.t - 1;
      }
    }
    off = (static_cast<size_t>(nn) * g.h * g.w + rpix[j]) * g.c + ch;
    return true;
  }

  __device__ int w_row(int k0) const { return k0; }

  __device__ void load(uint8_t* st, uint8_t* aux, int k0) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      size_t off = 0;
      int ch;
      bool use;
      const bool ok = at(j, k0, off, ch, use);
      cp_async16(&chunk_at(st, j), a.p + off, ok);
      cp_async16(&chunk_at(aux, j), a.r + off, ok);
    }
  }

  __device__ void xform(uint8_t* st, uint8_t* aux, int k0) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      size_t off;
      int ch;
      bool use;
      if (!at(j, k0, off, ch, use)) continue;
      const uint4 xv = finale8(chunk_at(st, j), chunk_at(aux, j), a.sa3, a.sb3,
                               a.sap, a.sbp, ch);
      if (blockIdx.y == 0) *reinterpret_cast<uint4*>(a.x_out + off) = xv;
      chunk_at(st, j) = use ? xv : make_uint4(0, 0, 0, 0);
    }
  }
};

// Data-gradient A: rows are INPUT pixels of the forward conv g, k = (kh,
// kw, f) over the output-gradient channels; da and v arrive raw (v beside
// the A tile) and the BN backward runs on the arrived stage. Input pixel
// ih receives output row oh = (ih + pad - kh) / stride where that divides
// and is in range. A stride-2 conv skips the products that are zero by
// construction: a 1x1 one (kSub) runs over the output pixels, each
// writing the input pixel (2 oh, 2 ow) (the caller zeroes the others),
// and a 3x3 one (kParity) runs one launch row of blocks per parity class
// (blockIdx.z = 2 a + b: input pixels (2 i + a, 2 j + b)) over that
// class's taps only (kh = 1 for a = 0, kh = 0 and 2 for a = 1; kw alike).
enum { kRows = 0, kSub = 1, kParity = 2 };

struct GradPart {
  static constexpr int kAux = kATile;
  static constexpr bool kGrad = true;
  GradXf gx;
  ConvGeo g;
  int mode;
  int a, b;  // kParity: this block's class
  const CUtensorMap* dmap;  // da and v as [n ho wo][nout], boxes 128 x 64
  const CUtensorMap* vmap;
  int m0;
  int rn[4], rih[4], riw[4];
  bool rok[4];

  // A 1x1 stride-1 conv (rows: its pixels) and kSub (rows: the output
  // pixels) read dense [M][nout] tiles of da and v: one TMA box each
  __device__ bool dense() const {
    return mode == kSub || (mode == kRows && g.ks == 1 && g.stride == 1);
  }
  __device__ int tma_bytes() const { return dense() ? 2 * kATile : 0; }
  __device__ void tma(uint8_t* st, uint8_t* aux, int k0,
                      uint64_t* bar) const {
    if (tma_lane(2, 0)) tma_load(st, dmap, k0, m0, bar);
    if (tma_lane(2, 1)) tma_load(aux, vmap, k0, m0, bar);
  }

  __host__ __device__ static int mode_of(const ConvGeo& g) {
    if (g.stride == 2 && g.ks == 1 && g.pad == 0) return kSub;
    if (g.stride == 2 && g.ks == 3 && g.pad == 1) return kParity;
    return kRows;
  }

  // rows of this block's class
  __host__ __device__ int rows(int a_, int b_) const {
    if (mode == kSub) return g.n * g.ho * g.wo;
    if (mode == kParity) return g.n * ((g.h - a_ + 1) / 2) * ((g.w - b_ + 1) / 2);
    return g.n * g.h * g.w;
  }

  __device__ int ncols() const { return mode == kParity ? (g.w - b + 1) / 2 : g.w; }

  __device__ int k_total() const {
    if (mode == kSub) return g.nout;
    if (mode == kParity) return (a ? 2 : 1) * (b ? 2 : 1) * g.nout;
    return g.ks * g.ks * g.nout;
  }

  __device__ void init(int m0_) {
    m0 = m0_;
    const int w = ncols();
    const int plane = (mode == kParity ? (g.h - a + 1) / 2 : g.h) * w;
    const int total = rows(a, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0_ + a_row(j);
      rok[j] = m < total;
      const int mm = rok[j] ? m : 0;
      rn[j] = mode == kSub ? mm : mm / plane;
      const int rem = mm - rn[j] * plane;
      rih[j] = rem / w;
      riw[j] = rem - rih[j] * w;
      if (mode == kParity) {
        rih[j] = 2 * rih[j] + a;
        riw[j] = 2 * riw[j] + b;
      }
    }
  }

  // The tap (kh, kw) and channel of this thread's chunk at k0.
  __device__ bool tap(int k0, int& kh, int& kw, int& ch) const {
    const int k = k0 + (threadIdx.x & 7) * 8;
    if (k >= k_total()) return false;
    const int t = k / g.nout;
    ch = k - t * g.nout;
    if (mode == kParity) {
      const int nkw = b ? 2 : 1;
      const int ti = t / nkw;
      kh = a ? 2 * ti : 1;
      kw = b ? 2 * (t - ti * nkw) : 1;
    } else {
      kh = t / g.ks;
      kw = t - kh * g.ks;
    }
    return true;
  }

  // The row of the weight's transpose [ks ks nout][C] that stage k0 reads.
  __device__ int w_row(int k0) const {
    if (mode != kParity) return k0;
    int kh, kw, ch;
    const int t = k0 / g.nout;
    const int nkw = b ? 2 : 1;
    kh = a ? 2 * (t / nkw) : 1;
    kw = b ? 2 * (t % nkw) : 1;
    ch = k0 - t * g.nout;
    return (kh * g.ks + kw) * g.nout + ch;
  }

  __device__ bool at(int j, int kh, int kw, int ch, size_t& off) const {
    if (!rok[j]) return false;
    if (mode == kSub) {
      off = static_cast<size_t>(rn[j]) * gx.c + ch;
      return true;
    }
    int oh = rih[j] + g.pad - kh;
    int ow = riw[j] + g.pad - kw;
    if (oh < 0 || ow < 0) return false;
    if (g.stride == 2) {
      if ((oh & 1) || (ow & 1)) return false;
      oh >>= 1;
      ow >>= 1;
    }
    if (oh >= g.ho || ow >= g.wo) return false;
    off = ((static_cast<size_t>(rn[j]) * g.ho + oh) * g.wo + ow) * gx.c + ch;
    return true;
  }

  // The row of dX that tile row gm (< rows) computes.
  __device__ size_t dest(int gm) const {
    if (mode == kRows) return gm;
    const int w = mode == kSub ? g.wo : ncols();
    const int plane = (mode == kSub ? g.ho : (g.h - a + 1) / 2) * w;
    const int n = gm / plane;
    const int rem = gm - n * plane;
    const int i = rem / w;
    const int jj = rem - i * w;
    const int ih = mode == kSub ? 2 * i : 2 * i + a;
    const int iw = mode == kSub ? 2 * jj : 2 * jj + b;
    return (static_cast<size_t>(n) * g.h + ih) * g.w + iw;
  }

  // As ActPart::load, da into the A tile and v beside it.
  __device__ void load(uint8_t* st, uint8_t* aux, int k0) const {
    int kh = 0, kw = 0, ch = 0;
    const bool kok = tap(k0, kh, kw, ch);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      size_t off = 0;
      const bool ok = kok && at(j, kh, kw, ch, off);
      cp_async16(&chunk_at(st, j), gx.da + off, ok);
      cp_async16(&chunk_at(aux, j), gx.v + off, ok);
    }
  }

  __device__ void xform(uint8_t* st, uint8_t* aux, int k0) const {
    int kh, kw, ch;
    if (!tap(k0, kh, kw, ch)) return;
    float ga[8], ge[8], gf[8];
    vec8(gx.ga + ch, ga);
    vec8(gx.ge + ch, ge);
    vec8(gx.gf + ch, gf);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      size_t off;
      if (!at(j, kh, kw, ch, off)) continue;
      float d[8], v[8];
      unpack8(chunk_at(st, j), d);
      unpack8(chunk_at(aux, j), v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = fmaf(ga[e], d[e], fmaf(ge[e], v[e], gf[e]));
      chunk_at(st, j) = pack8(d);
    }
  }
};

// A forward or data-gradient product: A from Part, B = columns n0.. of a
// weight [k_total][n] by TMA (wmap). Stage: A tile, B tile, Part's raw
// staging.
template <int BN, class Part>
struct WeightSrc {
  static constexpr int kStageBytes = kATile + BN * 128 + Part::kAux;
  static constexpr bool kTma = true;
  Part part;
  const CUtensorMap* wmap;
  int n0;

  __device__ void load(uint8_t* st, uint64_t* bar, int, int kt) {
    uint8_t* aux = st + kATile + BN * 128;
    const bool dense = part.dense();
    if (!dense) part.load(st, aux, kt * kHBK);
    if (threadIdx.x == 0) mbar_expect(bar, BN * 128 + part.tma_bytes());
    tma_w<BN>(st + kATile, wmap, part.w_row(kt * kHBK), n0, bar, 0);
    if (dense) part.tma(st, aux, kt * kHBK, bar);
  }
  __device__ void xform(uint8_t* st, int, int kt) {
    part.xform(st, st + kATile + BN * 128, kt * kHBK);
  }
};

// Ring depth of a forward or data-gradient product.
template <class Part>
__host__ __device__ constexpr int stages_of() {
  return Part::kGrad ? kGradStages : kFwdStages;
}

template <int BN, class Part>
constexpr int weight_smem() {
  return stages_of<Part>() * WeightSrc<BN, Part>::kStageBytes + kAlignSlack;
}

// The K loop of this block's tile; then the ring is free for the
// epilogue's staging and moment slots.
template <int BN, class Part>
__device__ void weight_gemm(uint8_t* sm, const Part& part,
                            const CUtensorMap* wmap, int n0, int k_total,
                            float (&acc)[BN / 2]) {
  constexpr int S = stages_of<Part>();
  __shared__ alignas(8) uint64_t bars[S];
  WeightSrc<BN, Part> src{part, wmap, n0};
  if (threadIdx.x == 0) tma_prefetch(wmap);
  Mainloop<BN, S, 0, WeightSrc<BN, Part>> ml(sm, bars, src, 1,
                                              (k_total + kHBK - 1) / kHBK);
  ml.tile(acc);
  ml.finish();
}

template <int BN>
using WarpMoments = MomSlots<BN, 2, 8>;

template <int BN, class Part>
__global__ void __launch_bounds__(kThreads, 2)
    conv_fwd_kernel(Part pa, ConvGeo g, bf16* out, float* part,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap amap) {
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  pa.init(m0);
  pa.use_map(&amap);
  float acc[BN / 2];
  weight_gemm<BN>(sm, pa, &wmap, n0, g.k, acc);
  // the ring is free: this warp's store staging, then the moment slots
  WarpMoments<BN>& ms = *reinterpret_cast<WarpMoments<BN>*>(sm + kStoreBytes);
  ms.zero();
  __syncthreads();
  store_tile<BN>(sm + (threadIdx.x >> 5) * 1024, acc, Identity{}, out, g.nout,
                 m0 + (threadIdx.x >> 5) * 16, g.m, n0, ms.s0(), ms.s1());
  __syncthreads();
  ms.store(part, g.nout, n0);
}

// Weight gradient: dW[K, N] = A^T G over a range of pixels, both operands
// MN-major (the pixels, the reduction, are their rows). Stage: A^T as two
// panels [64 pixels][64 k] (tile rows k 0-63 and 64-127), G [64 pixels]
// [BN] (da arrives there, v beside it; the BN backward runs on the
// arrived stage). Thread i copies chunk i % 16 of the tile's 128 k for
// pixels i / 16 + 16 j, j < 4, and G chunk i % (BN / 8) of pixels
// i / (BN / 8) + (256 / (BN / 8)) j.
template <int BN>
struct WgradSrc {
  // A^T, G, v, then one byte a thread: which of its A^T chunks hold data
  static constexpr int kMaskAt = kATile + 2 * BN * 128;
  static constexpr int kStageBytes = kMaskAt + 1024;
  static constexpr bool kTma = true;
  static constexpr int kCpr = BN / 8;
  static constexpr int kGRows = kThreads / kCpr;
  ActXf a;
  ConvGeo g;
  GradXf gx;
  // G's da and v as [m][nout], and (dense()) x as [n h w][c], as TMA
  // boxes of 64 pixels x 64: chunks split at multiples of 64 pixels, so a
  // stage's boxes end inside the split or at the tensor's end, where TMA
  // reads zeros
  const CUtensorMap* amap;
  const CUtensorMap* gmap;
  const CUtensorMap* vmap;
  int m_begin, m_end, n0;
  int ch, kh, kw;  // this thread's k chunk
  bool kok;
  // the output pixel (n, oh, ow) of each of this thread's A^T rows in the
  // next stage to load, advanced 64 pixels a stage without dividing
  int pn[4], poh[4], pow_[4];
  int step_h, step_w;
  // the BN vectors of the block's A rows (sa, sb: 2 x 128) and G columns
  // (ga, ge, gf: 3 x BN), in shared memory
  float* vecs;

  // After init and a __syncthreads, vecs holds the block's vectors.
  __device__ void init(int k0, float* vecs_) {
    vecs = vecs_;
    const int plane = g.ho * g.wo;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m_begin + a_pix(j);
      pn[j] = m / plane;
      const int rem = m - pn[j] * plane;
      poh[j] = rem / g.wo;
      pow_[j] = rem - poh[j] * g.wo;
    }
    step_h = kHBK / g.wo;
    step_w = kHBK - step_h * g.wo;
    const int k = k0 + (threadIdx.x & 15) * 8;
    kok = k < g.k;
    const int tap = (kok ? k : 0) / g.c;
    ch = (kok ? k : 0) - tap * g.c;
    kh = tap / g.ks;
    kw = tap - kh * g.ks;
    for (int i = threadIdx.x; i < kBM; i += kThreads) {
      const int kr = k0 + i;
      const int c = kr < g.k ? kr % g.c : 0;
      vecs[i] = a.sa != nullptr ? a.sa[c] : 0.0f;
      vecs[kBM + i] = a.sa != nullptr ? a.sb[c] : 0.0f;
    }
    for (int i = threadIdx.x; i < BN; i += kThreads) {
      vecs[2 * kBM + i] = gx.ga[n0 + i];
      vecs[2 * kBM + BN + i] = gx.ge[n0 + i];
      vecs[2 * kBM + 2 * BN + i] = gx.gf[n0 + i];
    }
  }

  __device__ void vecs8(int at, float (&o)[8]) const {
    const float4 lo = *reinterpret_cast<const float4*>(vecs + at);
    const float4 hi = *reinterpret_cast<const float4*>(vecs + at + 4);
    o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
    o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
  }

  __device__ int a_pix(int j) const { return (threadIdx.x >> 4) + 16 * j; }
  __device__ int g_pix(int j) const {
    return threadIdx.x / kCpr + kGRows * j;
  }

  // Row j of the stage being loaded (kt): where its chunk comes from.
  __device__ bool a_at(int j, int kt, size_t& off) const {
    if (!kok || m_begin + kt * kHBK + a_pix(j) >= m_end) return false;
    int nn = pn[j];
    const int ih = poh[j] * g.stride - g.pad + kh;
    const int iw = pow_[j] * g.stride - g.pad + kw;
    if (ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return false;
    if (a.fold && ch < 2 * a.fold) {
      const int tt = nn % a.t;
      if (ch < a.fold) {
        if (tt == a.t - 1) return false;
        ++nn;
      } else {
        if (tt == 0) return false;
        --nn;
      }
    }
    off = ((static_cast<size_t>(nn) * g.h + ih) * g.w + iw) * g.c + ch;
    return true;
  }

  // Move every row 64 pixels on (after loading a stage).
  __device__ void advance() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      poh[j] += step_h;
      pow_[j] += step_w;
      if (pow_[j] >= g.wo) {
        pow_[j] -= g.wo;
        ++poh[j];
      }
      while (poh[j] >= g.ho) {
        poh[j] -= g.ho;
        ++pn[j];
      }
    }
  }

  __device__ bool g_at(int j, int kt, size_t& off) const {
    const int m = m_begin + kt * kHBK + g_pix(j);
    off = static_cast<size_t>(m) * gx.c + n0 + (threadIdx.x % kCpr) * 8;
    return m < m_end;
  }

  __device__ uint4& a_chunk(uint8_t* st, int j) const {
    return *reinterpret_cast<uint4*>(st + mn_off(a_pix(j), threadIdx.x & 15));
  }
  __device__ uint4& g_chunk(uint8_t* buf, int j) const {
    return *reinterpret_cast<uint4*>(
        buf + mn_off(g_pix(j), threadIdx.x % kCpr));
  }

  // A 1x1 stride-1 conv of an unshifted x: A^T is a dense [M][C] tile
  __device__ bool dense() const {
    return g.ks == 1 && g.stride == 1 && g.pad == 0 && a.fold == 0;
  }

  __device__ void load(uint8_t* st, uint64_t* bar, int, int kt) {
    const int p0 = m_begin + kt * kHBK;
    const bool dn = dense();
    if (threadIdx.x == 0) mbar_expect(bar, 2 * BN * 128 + (dn ? kATile : 0));
#pragma unroll
    for (int p = 0; p < BN / 64; ++p) {
      if (tma_lane(0, p))
        tma_load(st + kATile + p * kPanel, gmap, n0 + 64 * p, p0, bar);
      if (tma_lane(2, p))
        tma_load(st + kATile + BN * 128 + p * kPanel, vmap, n0 + 64 * p, p0,
                 bar);
    }
    if (dn) {
      const int k0 = blockIdx.x * kBM;
      if (tma_lane(4, 0)) tma_load(st, amap, k0, p0, bar);
      if (tma_lane(4, 1)) tma_load(st + kPanel, amap, k0 + 64, p0, bar);
    }
    uint32_t mask = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (dn) {
        mask |= (kok && p0 + a_pix(j) < m_end) << j;
        continue;
      }
      size_t off = 0;
      const bool ok = a_at(j, kt, off);
      mask |= ok << j;
      cp_async16(&a_chunk(st, j), a.x + (ok ? off : 0), ok);
    }
    st[kMaskAt + threadIdx.x] = static_cast<uint8_t>(mask);
    advance();
  }

  __device__ void xform(uint8_t* st, int, int kt) {
    if (a.sa != nullptr) {
      float sa[8], sb[8];
      vecs8((threadIdx.x & 15) * 8, sa);
      vecs8(kBM + (threadIdx.x & 15) * 8, sb);
      const uint32_t mask = st[kMaskAt + threadIdx.x];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((mask >> j) & 1)) continue;
        float v[8];
        unpack8(a_chunk(st, j), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = fmaxf(fmaf(v[e], sa[e], sb[e]), 0.0f);
        a_chunk(st, j) = pack8(v);
      }
    }
    const int gc = (threadIdx.x % kCpr) * 8;
    float ga[8], ge[8], gf[8];
    vecs8(2 * kBM + gc, ga);
    vecs8(2 * kBM + BN + gc, ge);
    vecs8(2 * kBM + 2 * BN + gc, gf);
#pragma unroll
    for (int j = 0; j < kHBK / kGRows; ++j) {
      size_t off;
      if (!g_at(j, kt, off)) continue;
      float d[8], v[8];
      unpack8(g_chunk(st + kATile, j), d);
      unpack8(g_chunk(st + kATile + BN * 128, j), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = fmaf(ga[e], d[e], fmaf(ge[e], v[e], gf[e]));
      g_chunk(st + kATile, j) = pack8(d);
    }
  }
};

// One 128 x BN tile of dW over pixels [m_begin, m_end); grid (k tiles, n
// tiles, pixel splits); split z stores its float32 partial sums into
// slice z of dw [splits][k][nout] (no atomics: the caller sums the
// slices in order).
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    conv_wgrad_kernel(WgradSrc<BN> src, int chunk, float* dw,
                      const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap vmap) {
  __shared__ alignas(8) uint64_t bars[kGradStages];
  uint8_t* sm = aligned_smem();
  src.amap = &amap;
  src.gmap = &gmap;
  src.vmap = &vmap;
  const ConvGeo& g = src.g;
  const int k0 = blockIdx.x * kBM;
  src.n0 = blockIdx.y * BN;
  src.m_begin = blockIdx.z * chunk;
  src.m_end = min(g.m, src.m_begin + chunk);
  if (src.m_begin >= src.m_end) return;
  __shared__ alignas(16) float vecs[2 * kBM + 3 * BN];
  src.init(k0, vecs);
  __syncthreads();
  float acc[BN / 2];
  {
    Mainloop<BN, kGradStages, 1, WgradSrc<BN>> ml(
        sm, bars, src, 1, (src.m_end - src.m_begin + kHBK - 1) / kHBK);
    ml.tile(acc);
    ml.finish();
  }
  float* ep = reinterpret_cast<float*>(sm) + (threadIdx.x >> 5) * 16 * kEpiLd;
  float* slice = dw + static_cast<size_t>(blockIdx.z) * g.k * g.nout;
  hop::epilogue<BN>(ep, acc, [&](int r, int c, float(&v)[8]) {
    const int k = k0 + r;
    if (k < g.k) {
      float* dst = slice + static_cast<size_t>(k) * g.nout + src.n0 + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = v[e];
    }
  });
}

// Halve the N values of every lane over the lanes that differ in bit
// `off` (xor shuffles): the lane with the bit set keeps and sums the upper
// half, the other the lower.
template <int N>
__device__ __forceinline__ void halve(float* v, int off) {
  const bool up = threadIdx.x & off;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Column sums over the 16 lanes of one parity (the 16 rows epilogue() hands
// them) of N values a lane, in a fixed order: four halvings (lane bits 1-4)
// leave lane l the sums of values idx .. idx + N / 16 - 1, idx = (N / 2)
// b1 + (N / 4) b2 + (N / 8) b3 + (N / 16) b4, b = l's bits. 15 (N = 16)
// or 30 (N = 32) shuffles where summing each value alone takes 4 N.
template <int N>
__device__ __forceinline__ int sum_rows(float (&v)[N]) {
  halve<N>(v, 2);
  halve<N / 2>(v, 4);
  halve<N / 4>(v, 8);
  halve<N / 8>(v, 16);
  const int l = threadIdx.x;
  return (N / 2) * ((l >> 1) & 1) + (N / 4) * ((l >> 2) & 1) +
         (N / 8) * ((l >> 3) & 1) + (N / 16) * ((l >> 4) & 1);
}

// What the data-gradient epilogue does with dX[Mi, C] (C = g.c):
//   kStore:   out = dX
//   kMask:    out = da = dX * (sa * v + sb > 0), plus the moments
//             (sum da, sum da * (v - mu)) of the BN whose output fed it
//   kUnshift: out[dest] = dX + res[dest], dest = the frame the shift read
//             from; the clip-edge rows that no frame feeds get res alone
//   kLink:    as kUnshift, then dq = out * (x[dest] > 0) (the finale's
//             relu mask of the block below) and that block's BN3/BNp
//             backward moments (sum dq, sum dq * (v - mu), sum dq * (pr -
//             mup)); out = dq
// In kUnshift and kLink the edge row of one clip end takes the place of
// the row the shift drops at the other end, so (row, channel) -> dest is
// one to one: every element of out is written once, by one thread, which
// also reads res there (res may be out itself).
enum { kStore = 0, kMask = 1, kUnshift = 2, kLink = 3 };

struct DgradEpi {
  int mode;
  bf16* out;
  const bf16* v;     // kMask: the BN's input; kLink: p of the block below
  const float* sa;   // kMask
  const float* sb;
  const float* mu;   // kMask, kLink: the mean of v's BN
  const bf16* res;   // kUnshift, kLink: the residual gradient
  const bf16* x;     // kLink: the block's input (the finale's relu output)
  const bf16* pr;    // kLink: pr of the block below, or null
  const float* mup;
  float* part;       // kMask, kLink: per-block partial moments
  int t, fold;
};

static DgradEpi epi_store(void* out) {
  DgradEpi e{};
  e.mode = kStore;
  e.out = static_cast<bf16*>(out);
  return e;
}

static DgradEpi epi_mask(void* out, const void* v, const float* sa,
                         const float* sb, const float* mu, float* part) {
  DgradEpi e{};
  e.mode = kMask;
  e.out = static_cast<bf16*>(out);
  e.v = static_cast<const bf16*>(v);
  e.sa = sa; e.sb = sb; e.mu = mu; e.part = part;
  return e;
}

static DgradEpi epi_unshift(void* out, const void* res, int t, int fold) {
  DgradEpi e{};
  e.mode = kUnshift;
  e.out = static_cast<bf16*>(out);
  e.res = static_cast<const bf16*>(res);
  e.t = t; e.fold = fold;
  return e;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    conv_dgrad_kernel(GradXf gx, ConvGeo g, DgradEpi ep,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap vmap) {
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int plane = g.h * g.w;
  GradPart pa{gx, g, GradPart::mode_of(g), static_cast<int>(blockIdx.z >> 1),
              static_cast<int>(blockIdx.z & 1), &dmap, &vmap};
  const int mi = pa.rows(pa.a, pa.b);
  pa.init(m0);
  float acc[BN / 2];
  weight_gemm<BN>(sm, pa, &wmap, n0, pa.k_total(), acc);
  float* epi = reinterpret_cast<float*>(sm) + (threadIdx.x >> 5) * 16 * kEpiLd;
  MomSlots<BN, 3, 8>& ms = *reinterpret_cast<MomSlots<BN, 3, 8>*>(
      sm + kEpiBytes);
  ms.zero();
  __syncthreads();
  hop::epilogue<BN>(epi, acc, [&](int r, int c, float(&v)[8]) {
    const int gm = m0 + r;
    const bool valid = gm < mi;
    const int col = n0 + c;
    if (ep.mode == kMask) {
      const size_t row = valid ? pa.dest(gm) : 0;
      float lv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (valid) unpack8(ldg16(ep.v + row * g.c + col), lv);
      alignas(16) bf16 o[8];
      float s[8], q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool on = fmaf(lv[e], ep.sa[col + e], ep.sb[col + e]) > 0.0f;
        o[e] = __float2bfloat16_rn(on ? v[e] : 0.0f);
        const float d = valid ? __bfloat162float(o[e]) : 0.0f;
        s[e] = d;
        q[e] = d * (lv[e] - ep.mu[col + e]);
      }
      if (valid)
        *reinterpret_cast<uint4*>(ep.out + row * g.c + col) =
            *reinterpret_cast<const uint4*>(o);
      float m[16];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        m[e] = s[e];
        m[8 + e] = q[e];
      }
      const int idx = sum_rows(m);
      ms.slot(idx >> 3)[c + (idx & 7)] += m[0];
    } else if (ep.mode == kStore) {
      if (valid)
        *reinterpret_cast<uint4*>(ep.out + pa.dest(gm) * g.c + col) = pack8(v);
    } else {  // 1x1 stride 1 (kRows): tile row gm is dX row gm
      float mom[3][8] = {};
      if (valid) {
        int dest = gm;
        bool keep = true;
        if (ep.fold) {
          const int tt = (gm / plane) % ep.t;
          if (col < ep.fold) {
            keep = tt < ep.t - 1;
            dest += keep ? plane : (1 - ep.t) * plane;
          } else if (col < 2 * ep.fold) {
            keep = tt > 0;
            dest += keep ? -plane : (ep.t - 1) * plane;
          }
        }
        const size_t off = static_cast<size_t>(dest) * g.c + col;
        float o[8];
        unpack8(ldg16(ep.res + off), o);
        if (keep) {
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = v[e] + o[e];
        }
        if (ep.mode == kLink) {
          float xv[8], pv[8], rv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          unpack8(ldg16(ep.x + off), xv);
          unpack8(ldg16(ep.v + off), pv);
          if (ep.pr != nullptr) unpack8(ldg16(ep.pr + off), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float dx = __bfloat162float(__float2bfloat16_rn(o[e]));
            const float d = xv[e] > 0.0f ? dx : 0.0f;
            o[e] = d;
            mom[0][e] = d;
            mom[1][e] = d * (pv[e] - ep.mu[col + e]);
            mom[2][e] = ep.pr != nullptr ? d * (rv[e] - ep.mup[col + e])
                                         : 0.0f;
          }
        }
        *reinterpret_cast<uint4*>(ep.out + off) = pack8(o);
      }
      if (ep.mode == kLink) {
        float m[32];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          m[e] = mom[0][e];
          m[8 + e] = mom[1][e];
          m[16 + e] = mom[2][e];
          m[24 + e] = 0.0f;
        }
        const int idx = sum_rows(m);
        if (idx < 24) {
          ms.slot(idx >> 3)[c + (idx & 7)] += m[0];
          ms.slot(idx >> 3)[c + (idx & 7) + 1] += m[1];
        }
      }
    }
  });
  if (ep.mode == kMask || ep.mode == kLink) {
    __syncthreads();
    ms.store(ep.part, g.c, n0, ep.mode == kLink ? 3 : 2,
             blockIdx.z * gridDim.x + blockIdx.x);
  }
}

// y = relu(bf16(sa3 * p + sb3) + r'), r' = r (identity) or
// bf16(sap * r + sbp) (projection); 8 channels per thread.
__global__ void finale_fwd_kernel(const bf16* p, const bf16* r,
                                  const float* sa3, const float* sb3,
                                  const float* sap, const float* sbp, bf16* y,
                                  size_t chunks, int c) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  int ch = static_cast<int>((i * 8) % c);
  const int step = static_cast<int>((stride * 8) % c);
  for (; i < chunks; i += stride) {
    *reinterpret_cast<uint4*>(y + i * 8) =
        finale8(ldg16(p + i * 8), ldg16(r + i * 8), sa3, sb3, sap, sbp, ch);
    ch += step;
    if (ch >= c) ch -= c;
  }
}

// dq = dy * (y > 0), and per channel over all pixels: sum dq, sum dq *
// (p - mu3) and sum dq * (pr - mup) (projection), as one row [3][c] of
// partial sums per block in part. Thread: one 8-channel chunk, rows
// strided over the grid; the block's rows are summed in a fixed order.
// c / 8 must divide the block size.
__global__ void __launch_bounds__(kThreads)
    finale_bwd_kernel(const bf16* dy, const bf16* y, const bf16* p,
                      const bf16* pr, const float* mu3, const float* mup,
                      bf16* dq, float* part, int m, int c) {
  __shared__ float red[kThreads * 8 * 3];
  const int cpr = c / 8;
  const int rows = kThreads / cpr;
  const int cc = threadIdx.x % cpr;
  const int rsub = threadIdx.x / cpr;
  const int ch = cc * 8;
  float s0[8] = {0}, s1[8] = {0}, s2[8] = {0}, m3[8], mp[8];
  vec8(mu3 + ch, m3);
  if (pr != nullptr) vec8(mup + ch, mp);
  for (int row = blockIdx.x * rows + rsub; row < m; row += gridDim.x * rows) {
    const size_t off = static_cast<size_t>(row) * c + ch;
    float d[8], yv[8], pv[8], rv[8];
    unpack8(ldg16(dy + off), d);
    unpack8(ldg16(y + off), yv);
    unpack8(ldg16(p + off), pv);
    if (pr != nullptr) unpack8(ldg16(pr + off), rv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      d[e] = __bfloat162float(__float2bfloat16_rn(yv[e] > 0.0f ? d[e] : 0.0f));
      s0[e] += d[e];
      s1[e] += d[e] * (pv[e] - m3[e]);
      if (pr != nullptr) s2[e] += d[e] * (rv[e] - mp[e]);
    }
    *reinterpret_cast<uint4*>(dq + off) = pack8(d);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float* r = red + static_cast<size_t>(rsub) * 3 * c + ch + e;
    r[0] = s0[e];
    r[c] = s1[e];
    r[2 * c] = s2[e];
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * 3 * c;
  for (int j = threadIdx.x; j < 3 * c; j += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += red[static_cast<size_t>(r) * 3 * c + j];
    out[j] = acc;
  }
}

static ConvGeo geo(int n, int h, int w, int c, int ks, int stride, int pad,
                   int nout) {
  ConvGeo g;
  g.n = n; g.h = h; g.w = w; g.c = c;
  g.ks = ks; g.stride = stride; g.pad = pad; g.nout = nout;
  g.ho = (h + 2 * pad - ks) / stride + 1;
  g.wo = (w + 2 * pad - ks) / stride + 1;
  g.m = n * g.ho * g.wo;
  g.k = ks * ks * c;
  return g;
}

static ActXf act(const void* x, const float* sa, const float* sb, int t,
                 int fold) {
  ActXf a;
  a.x = static_cast<const bf16*>(x);
  a.sa = sa; a.sb = sb; a.t = t; a.fold = fold;
  return a;
}

static GradXf grad(const void* da, const void* v, const float* abc, int c) {
  GradXf g;
  g.da = static_cast<const bf16*>(da);
  g.v = static_cast<const bf16*>(v);
  g.ga = abc; g.ge = abc + c; g.gf = abc + 2 * c; g.c = c;
  return g;
}

static ActPart part_of(const ActXf& a, const ConvGeo& g) {
  return ActPart{a, g};
}

static LinkPart part_of(const LinkXf& a, const ConvGeo& g) {
  return LinkPart{a, g};
}

// The activation a dense forward A tile reads (ActPart; LinkPart reads
// none, its map is never used).
static const void* dense_src(const ActXf& a) { return a.x; }
static const void* dense_src(const LinkXf& a) { return a.p; }

template <int BN, class Part, class Xf>
static cudaError_t launch_fwd(const Part& pa, const Xf& a, const ConvGeo& g,
                              const void* w, void* out, float* part,
                              dim3 grid, cudaStream_t st) {
  constexpr int smem = weight_smem<BN, Part>();
  CUtensorMap wmap, amap;
  cudaError_t e = tensor_map(&wmap, w, g.k, g.nout, kHBK);
  if (e == cudaSuccess)
    e = tensor_map(&amap, dense_src(a), static_cast<uint64_t>(g.n) * g.h * g.w,
                   g.c, kBM);
  if (e == cudaSuccess) e = allow_smem<conv_fwd_kernel<BN, Part>>(smem);
  if (e != cudaSuccess) return e;
  conv_fwd_kernel<BN, Part><<<grid, kThreads, smem, st>>>(
      pa, g, static_cast<bf16*>(out), part, wmap, amap);
  return cudaGetLastError();
}

// The forward conv (A from Xf: ActXf for an activation, LinkXf for the
// trunk's link), then its moments [2][nout] from the blocks' partial rows
// (part holds mt * 2 * nout floats).
template <class Xf>
static cudaError_t conv_fwd(const Xf& a, const ConvGeo& g, const void* w,
                            void* out, float* mom, float* part,
                            cudaStream_t st) {
  const bool wide = g.nout % 128 == 0;
  const dim3 grid((g.m + kBM - 1) / kBM, wide ? g.nout / 128 : g.nout / 64);
  const auto pa = part_of(a, g);
  cudaError_t e = wide ? launch_fwd<128>(pa, a, g, w, out, part, grid, st)
                       : launch_fwd<64>(pa, a, g, w, out, part, grid, st);
  if (e != cudaSuccess) return e;
  return reduce_rows(part, grid.x, 2 * g.nout, mom, st);
}

template <int BN>
static cudaError_t launch_dgrad(const GradXf& gx, const ConvGeo& g,
                                const void* wt, const DgradEpi& ep, dim3 grid,
                                cudaStream_t st) {
  constexpr int smem = weight_smem<BN, GradPart>();
  const uint64_t mo = static_cast<uint64_t>(g.n) * g.ho * g.wo;
  CUtensorMap wmap, dmap, vmap;
  cudaError_t e = tensor_map(&wmap, wt, g.ks * g.ks * g.nout, g.c, kHBK);
  if (e == cudaSuccess) e = tensor_map(&dmap, gx.da, mo, g.nout, kBM);
  if (e == cudaSuccess) e = tensor_map(&vmap, gx.v, mo, g.nout, kBM);
  if (e == cudaSuccess) e = allow_smem<conv_dgrad_kernel<BN>>(smem);
  if (e != cudaSuccess) return e;
  conv_dgrad_kernel<BN><<<grid, kThreads, smem, st>>>(gx, g, ep, wmap, dmap,
                                                       vmap);
  return cudaGetLastError();
}

// Grid of a data-gradient conv: row tiles (of the largest parity class
// under kParity, one class a z), column tiles.
static dim3 dgrad_grid(const ConvGeo& g) {
  GradPart pa{};
  pa.g = g;
  pa.mode = GradPart::mode_of(g);
  const int rows = pa.rows(0, 0);
  return dim3((rows + kBM - 1) / kBM, g.c % 128 == 0 ? g.c / 128 : g.c / 64,
              pa.mode == kParity ? 4 : 1);
}

// The data-gradient conv; kMask (kLink) also reduces its moments into mom
// [2][C] ([3][C]); ep.part holds x * z * 2 (3) * C floats (dgrad_grid). A
// 1x1 stride-2 conv zeroes ep.out first: only every other row and column
// of dX receives a gradient.
static cudaError_t conv_dgrad(const GradXf& gx, const ConvGeo& g,
                              const void* wt, const DgradEpi& ep, float* mom,
                              cudaStream_t st) {
  const dim3 grid = dgrad_grid(g);
  cudaError_t e = cudaSuccess;
  if (GradPart::mode_of(g) == kSub)
    e = cudaMemsetAsync(ep.out, 0,
                        static_cast<size_t>(g.n) * g.h * g.w * g.c * 2, st);
  if (e == cudaSuccess)
    e = grid.y * 128 == static_cast<unsigned>(g.c)
            ? launch_dgrad<128>(gx, g, wt, ep, grid, st)
            : launch_dgrad<64>(gx, g, wt, ep, grid, st);
  if (e != cudaSuccess || (ep.mode != kMask && ep.mode != kLink)) return e;
  return reduce_rows(ep.part, grid.x * grid.z,
                     (ep.mode == kLink ? 3 : 2) * g.c, mom, st);
}

// Grid of the weight gradient: (k tiles, column tiles, pixel splits), with
// enough splits for about four waves of blocks on 132 SMs, each split at
// least 8 stages (512 pixels) and a whole number of stages.
static dim3 wgrad_hgrid(const ConvGeo& g, int bn, int* chunk) {
  const int kt = (g.k + kBM - 1) / kBM;
  const int nt = g.nout / bn;
  int z = std::max(1, (4 * 132) / (kt * nt));
  z = std::min(z, (g.m + 511) / 512);
  int c = (g.m + z - 1) / z;
  c = (c + kHBK - 1) / kHBK * kHBK;
  *chunk = c;
  return dim3(kt, nt, (g.m + c - 1) / c);
}

// Pixel splits of a weight gradient.
static int wgrad_splits(const ConvGeo& g) {
  int chunk = 0;
  return wgrad_hgrid(g, g.nout % 128 == 0 ? 128 : 64, &chunk).z;
}

template <int BN>
static cudaError_t launch_wgrad(const ActXf& a, const ConvGeo& g,
                                const GradXf& gx, float* dst, dim3* grid,
                                cudaStream_t st) {
  constexpr int smem = kGradStages * WgradSrc<BN>::kStageBytes + kAlignSlack;
  cudaError_t e = allow_smem<conv_wgrad_kernel<BN>>(smem);
  if (e != cudaSuccess) return e;
  CUtensorMap amap, gmap, vmap;
  e = tensor_map(&amap, a.x, static_cast<uint64_t>(g.n) * g.h * g.w, g.c,
                 kHBK);
  if (e == cudaSuccess) e = tensor_map(&gmap, gx.da, g.m, g.nout, kHBK);
  if (e == cudaSuccess) e = tensor_map(&vmap, gx.v, g.m, g.nout, kHBK);
  if (e != cudaSuccess) return e;
  int chunk = 0;
  *grid = wgrad_hgrid(g, BN, &chunk);
  WgradSrc<BN> src{a, g, gx};
  conv_wgrad_kernel<BN><<<*grid, kThreads, smem, st>>>(src, chunk, dst, amap,
                                                       gmap, vmap);
  return cudaGetLastError();
}

// dw [k, nout] f32 = the weight gradient; with more than one pixel split
// the splits' partial sums go to part (splits * k * nout floats) and are
// summed in split order.
static cudaError_t conv_wgrad(const ActXf& a, const ConvGeo& g,
                              const GradXf& gx, float* dw, float* part,
                              cudaStream_t st) {
  float* dst = wgrad_splits(g) > 1 ? part : dw;
  dim3 grid;
  cudaError_t e = g.nout % 128 == 0
                      ? launch_wgrad<128>(a, g, gx, dst, &grid, st)
                      : launch_wgrad<64>(a, g, gx, dst, &grid, st);
  if (e != cudaSuccess || grid.z == 1) return e;
  const size_t n = static_cast<size_t>(g.k) * g.nout;
  reduce_slices_kernel<<<static_cast<unsigned>(std::min<size_t>(
                             (n + 255) / 256, 4 * 132 * 8)),
                         256, 0, st>>>(part, grid.z, n, dw);
  return cudaGetLastError();
}

// The pixel count a BatchNorm divides by: the local count m times scale,
// the ratio of the moment group's count to this rank's (1 alone, so the
// product is exact and the single-card path keeps its bits).
static float site_count(int m, double scale) {
  return static_cast<float>(m) * static_cast<float>(scale);
}

static cudaError_t bn_stats(const float* mom, int n, float count,
                            const float* gamma, const float* beta, float eps,
                            float* mu, float* var, float* sa, float* sb,
                            cudaStream_t st) {
  bn_stats_kernel<<<(n + 255) / 256, 256, 0, st>>>(mom, n, count, gamma, beta,
                                                   eps, mu, var, sa, sb);
  return cudaGetLastError();
}

static cudaError_t bn_bwd(const float* s0, const float* s1, int n,
                          float count, const float* gamma, const float* mu,
                          const float* var, float eps, float* abc,
                          float* dgamma, float* dbeta, cudaStream_t st) {
  bn_bwd_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      s0, s1, n, count, gamma, mu, var, eps, abc, abc + n, abc + 2 * n,
      dgamma, dbeta);
  return cudaGetLastError();
}

static int finale_bwd_blocks(int m) {
  return std::max(1, std::min(4 * 132, m / 8));
}

// Floats of the scratch `part` one block's entries need: the largest of
// the per-block moment rows of each conv, the finale and the links whose
// conv1 is this block's, and the pixel-split partial weight gradients.
static size_t block_workspace(int n, int h, int w, int c, int f, int co,
                              int stride) {
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  const ConvGeo g2 = geo(n, h, w, f, 3, stride, 1, f);
  const ConvGeo g3 = geo(n, g2.ho, g2.wo, f, 1, 1, 0, co);
  const ConvGeo gp = geo(n, h, w, c, 1, stride, 0, co);
  auto rows = [](int m) { return static_cast<size_t>((m + kBM - 1) / kBM); };
  size_t need = 0;
  auto take = [&need](size_t v) { need = std::max(need, v); };
  take(rows(g1.m) * 2 * f);            // conv1 forward moments
  take(rows(gp.m) * 2 * co);           // projection forward moments
  take(rows(g2.m) * 2 * f);            // conv2
  take(rows(g3.m) * 2 * co);           // conv3
  take(static_cast<size_t>(finale_bwd_blocks(g3.m)) * 3 * co);
  take(rows(g3.m) * 2 * f);            // conv3 dgrad moments (rows of z)
  const dim3 d2 = dgrad_grid(g2);      // conv2 dgrad moments (rows of u)
  take(static_cast<size_t>(d2.x) * d2.z * 2 * f);
  take(rows(g1.m) * 3 * c);            // the backward link's moments
  for (const ConvGeo* g : {&g1, &g2, &g3, &gp}) {
    const size_t z = wgrad_splits(*g);
    if (z > 1) take(z * g->k * g->nout);
  }
  return need;
}

#define VCG_TRY(expr)                      \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return int(e_); \
  } while (0)

// Per-block float32 vectors, each of the layout
//   [v1 (F), v1' (F), v2 (F), v2' (F), v3 (Co), v3' (Co), vp (Co), vp' (Co)]
// stats: mu1 var1 mu2 var2 mu3 var3 mup varp; vec: sa1 sb1 ... sap sbp;
// the gamma/beta gradients in the same layout as stats.
struct Vec8 {
  float* base;
  int f, co;
  __host__ float* at(int i) const {
    return i < 4 ? base + i * f : base + 4 * f + (i - 4) * co;
  }
};

// The block's forward up to p (no finale). link: conv1 already ran as the
// trunk's link (trunk_link_fwd wrote x, u and the moments of u into mom).
// Its phases, each ending where a moment is complete, run from `from` up
// to (not including) `to`:
//   0  conv1 (unless link) and the projection: the moments of u and pr
//   1  BN1's statistics, conv2: the moments of z
//   2  BN2's statistics, conv3: the moments of p
//   3  BN3's (and BNp's) statistics
// Between two calls a caller may sum the moments in mom over ranks; scale
// makes each count the group's (site_count).
static int block_fwd(const void* x, const void* w1, const void* w2,
                     const void* w3, const void* wp, const float* gb,
                     void* u, void* z, void* p, void* pr, float* stats,
                     float* vec, float* mom, float* part, int n, int h,
                     int w, int c, int f, int co, int stride, int t, int fold,
                     float eps, int link, int from, int to, double scale,
                     cudaStream_t st) {
  // gb: gamma/beta in the stats layout (g1 be1 g2 be2 g3 be3 gp bep)
  const Vec8 S{stats, f, co}, V{vec, f, co}, G{const_cast<float*>(gb), f, co};
  const bool proj = wp != nullptr;
  // moments: m1 [2F] | m2 [2F] | m3 [2Co] | mp [2Co]
  float* m1 = mom;
  float* m2 = mom + 2 * f;
  float* m3 = mom + 4 * f;
  float* mp = mom + 4 * f + 2 * co;
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  const ConvGeo gp = geo(n, h, w, c, 1, stride, 0, co);
  const ConvGeo g2 = geo(n, h, w, f, 3, stride, 1, f);
  const ConvGeo g3 = geo(n, g2.ho, g2.wo, f, 1, 1, 0, co);
  if (from <= 0 && 0 < to) {
    if (!link)
      VCG_TRY(conv_fwd(act(x, nullptr, nullptr, t, fold), g1, w1, u, m1,
                       part, st));
    if (proj)
      VCG_TRY(conv_fwd(act(x, nullptr, nullptr, t, 0), gp, wp, pr, mp, part,
                       st));
  }
  if (from <= 1 && 1 < to) {
    VCG_TRY(bn_stats(m1, f, site_count(g1.m, scale), G.at(0), G.at(1), eps,
                     S.at(0), S.at(1), V.at(0), V.at(1), st));
    VCG_TRY(conv_fwd(act(u, V.at(0), V.at(1), t, 0), g2, w2, z, m2, part,
                     st));
  }
  if (from <= 2 && 2 < to) {
    VCG_TRY(bn_stats(m2, f, site_count(g2.m, scale), G.at(2), G.at(3), eps,
                     S.at(2), S.at(3), V.at(2), V.at(3), st));
    VCG_TRY(conv_fwd(act(z, V.at(2), V.at(3), t, 0), g3, w3, p, m3, part,
                     st));
  }
  if (from <= 3 && 3 < to) {
    VCG_TRY(bn_stats(m3, co, site_count(g3.m, scale), G.at(4), G.at(5), eps,
                     S.at(4), S.at(5), V.at(4), V.at(5), st));
    if (proj)
      VCG_TRY(bn_stats(mp, co, site_count(g3.m, scale), G.at(6), G.at(7),
                       eps, S.at(6), S.at(7), V.at(6), V.at(7), st));
  }
  return 0;
}

// The block's backward from dq (the finale's masked gradient) and its
// BN3/BNp backward moments mom3 [3Co] (sum dq, sum dq (p - mu3), sum dq
// (pr - mup)). link: stop before conv1's data gradient (the trunk's
// backward link does it); a projection block's residual gradient is then
// left in dx. Its phases, each ending where a moment is complete, run
// from `from` up to (not including) `to`:
//   0  BN3's (and BNp's) backward, conv3's gradients: the moments of da2
//      into work[0, 2F)
//   1  BN2's backward, conv2's gradients: the moments of da1 into
//      work[2F, 4F)
//   2  BN1's backward, conv1's (and the projection's) gradients
// Between two calls a caller may average those moments over ranks (mom3
// before phase 0); scale makes each count the group's mean count.
static int block_bwd(const void* dq, const float* mom3, const void* x,
                     const void* u, const void* z, const void* p,
                     const void* pr, const void* w1t, const void* w2t,
                     const void* w3t, const void* wpt, const float* gb,
                     const float* stats, const float* vec, void* dx,
                     float* dw1, float* dw2, float* dw3, float* dwp,
                     float* dgb, void* da2, void* da1, float* work,
                     float* part, int n, int h, int w, int c, int f, int co,
                     int stride, int t, int fold, float eps, int link,
                     int from, int to, double scale, cudaStream_t st) {
  const bool proj = wpt != nullptr;
  const Vec8 S{const_cast<float*>(stats), f, co};
  const Vec8 V{const_cast<float*>(vec), f, co};
  const Vec8 G{const_cast<float*>(gb), f, co};
  const Vec8 D{dgb, f, co};
  // work: mom2 [2F] | mom1 [2F] | abc3 [3Co] | abcp [3Co] | abc2 [3F] |
  //       abc1 [3F]
  float* mom2 = work;
  float* mom1 = mom2 + 2 * f;
  float* abc3 = mom1 + 2 * f;
  float* abcp = abc3 + 3 * co;
  float* abc2 = abcp + 3 * co;
  float* abc1 = abc2 + 3 * f;
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  const ConvGeo g2 = geo(n, h, w, f, 3, stride, 1, f);
  const ConvGeo g3 = geo(n, g2.ho, g2.wo, f, 1, 1, 0, co);
  const ConvGeo gp = geo(n, h, w, c, 1, stride, 0, co);
  const float m2 = site_count(g3.m, scale);
  const GradXf gx3 = grad(dq, p, abc3, co);
  if (from <= 0 && 0 < to) {
    VCG_TRY(bn_bwd(mom3, mom3 + co, co, m2, G.at(4), S.at(4), S.at(5), eps,
                   abc3, D.at(4), D.at(5), st));
    if (proj)
      VCG_TRY(bn_bwd(mom3, mom3 + 2 * co, co, m2, G.at(6), S.at(6), S.at(7),
                     eps, abcp, D.at(6), D.at(7), st));

    // conv3: dw3 = relu(bn2(z))^T dp; da2 = (dp w3^T) * relu'(bn2(z))
    VCG_TRY(conv_wgrad(act(z, V.at(2), V.at(3), t, 0), g3, gx3, dw3, part,
                       st));
    VCG_TRY(conv_dgrad(gx3, g3, w3t,
                       epi_mask(da2, z, V.at(2), V.at(3), S.at(2), part),
                       mom2, st));
  }

  // conv2 (3x3, stride): dw2 and da1 = conv2^T(dz) * relu'(bn1(u))
  const GradXf gx2 = grad(da2, z, abc2, f);
  if (from <= 1 && 1 < to) {
    VCG_TRY(bn_bwd(mom2, mom2 + f, f, m2, G.at(2), S.at(2), S.at(3), eps,
                   abc2, D.at(2), D.at(3), st));
    VCG_TRY(conv_wgrad(act(u, V.at(0), V.at(1), t, 0), g2, gx2, dw2, part,
                       st));
    VCG_TRY(conv_dgrad(gx2, g2, w2t,
                       epi_mask(da1, u, V.at(0), V.at(1), S.at(0), part),
                       mom1, st));
  }
  if (!(from <= 2 && 2 < to)) return 0;
  VCG_TRY(bn_bwd(mom1, mom1 + f, f, site_count(g1.m, scale), G.at(0),
                 S.at(0), S.at(1), eps, abc1, D.at(0), D.at(1), st));

  // conv1's weight gradient, the residual gradient, then (unless the
  // trunk's link takes it) conv1's data gradient unshifted onto it
  const GradXf gx1 = grad(da1, u, abc1, f);
  VCG_TRY(conv_wgrad(act(x, nullptr, nullptr, t, fold), g1, gx1, dw1, part,
                     st));
  if (proj) {
    const GradXf gxp = grad(dq, pr, abcp, co);
    VCG_TRY(conv_wgrad(act(x, nullptr, nullptr, t, 0), gp, gxp, dwp, part,
                       st));
    VCG_TRY(conv_dgrad(gxp, gp, wpt, epi_store(dx), nullptr, st));
  }
  if (link) return 0;
  VCG_TRY(conv_dgrad(gx1, g1, w1t, epi_unshift(dx, proj ? dx : dq, t, fold),
                     nullptr, st));
  return 0;
}

static int finale_fwd(const void* p, const void* r, const float* vec,
                      void* y, int m, int f, int co, int proj,
                      cudaStream_t st) {
  const Vec8 V{const_cast<float*>(vec), f, co};
  const size_t chunks = static_cast<size_t>(m) * co / 8;
  const int blocks = static_cast<int>(std::min<size_t>((chunks + 255) / 256,
                                                       4 * 132 * 8));
  finale_fwd_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(p), static_cast<const bf16*>(r), V.at(4),
      V.at(5), proj ? V.at(6) : nullptr, proj ? V.at(7) : nullptr,
      static_cast<bf16*>(y), chunks, co);
  return static_cast<int>(cudaGetLastError());
}

static int finale_bwd(const void* dy, const void* y, const void* p,
                      const void* pr, const float* stats, void* dq,
                      float* mom3, float* part, int m, int f, int co,
                      cudaStream_t st) {
  const Vec8 S{const_cast<float*>(stats), f, co};
  const int fb = finale_bwd_blocks(m);
  finale_bwd_kernel<<<fb, kThreads, 0, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
      static_cast<const bf16*>(p), static_cast<const bf16*>(pr), S.at(4),
      pr != nullptr ? S.at(6) : nullptr, static_cast<bf16*>(dq), part, m,
      co);
  VCG_TRY(cudaGetLastError());
  return static_cast<int>(reduce_rows(part, fb, 3 * co, mom3, st));
}

// Block N's conv1 with block N-1's finale on load (LinkPart); vprev is block
// N-1's vec (sa3 sb3 [sap sbp] at its [4F', ...) offsets, Co' = c).
static int link_fwd(const void* pp, const void* rp, const float* vprev,
                    const void* w1, void* x, void* u, float* mom1,
                    float* part, int n, int h, int w, int c, int f,
                    int fprev, int proj_prev, int t, int fold,
                    cudaStream_t st) {
  const Vec8 V{const_cast<float*>(vprev), fprev, c};
  LinkXf a;
  a.p = static_cast<const bf16*>(pp);
  a.r = static_cast<const bf16*>(rp);
  a.sa3 = V.at(4);
  a.sb3 = V.at(5);
  a.sap = proj_prev ? V.at(6) : nullptr;
  a.sbp = proj_prev ? V.at(7) : nullptr;
  a.x_out = static_cast<bf16*>(x);
  a.t = t;
  a.fold = fold;
  return static_cast<int>(conv_fwd(a, geo(n, h, w, c, 1, 1, 0, f), w1, u,
                                    mom1, part, st));
}

// Block N's conv1 data gradient (da1 through BN1's backward abc1 [3F])
// unshifted onto the residual gradient res, masked by x (block N's input)
// into block N-1's dq, with block N-1's BN3/BNp backward moments into
// mom3 [3C] (sprev: block N-1's stats, F' = fprev, Co' = c).
static int link_bwd(const void* da1, const void* u, const float* abc1,
                    const void* w1t, const void* res, const void* x,
                    const void* pp, const void* prp, const float* sprev,
                    void* dq, float* mom3, float* part, int n, int h, int w,
                    int c, int f, int fprev, int t, int fold,
                    cudaStream_t st) {
  const Vec8 S{const_cast<float*>(sprev), fprev, c};
  DgradEpi ep = epi_unshift(dq, res, t, fold);
  ep.mode = kLink;
  ep.x = static_cast<const bf16*>(x);
  ep.v = static_cast<const bf16*>(pp);
  ep.mu = S.at(4);
  ep.pr = static_cast<const bf16*>(prp);
  ep.mup = prp != nullptr ? S.at(6) : nullptr;
  ep.part = part;
  return static_cast<int>(conv_dgrad(grad(da1, u, abc1, f),
                                     geo(n, h, w, c, 1, 1, 0, f), w1t, ep,
                                     mom3, st));
}

}  // namespace vcg

// Weights (bf16): w1 [C, F], w2 [9F, F] (HWIO rows), w3 [F, Co], wp [C, Co]
// or null. gb (f32): gamma/beta as g1 be1 g2 be2 g3 be3 gp bep ([F] x 4,
// [Co] x 4). Outputs u [M1, F], z [M2, F], p [M2, Co], pr [M2, Co] (bf16);
// stats mu/var and vec sa/sb in the same layout (f32); scratch: mom 4F +
// 4Co floats, part vcg_block_train_workspace floats. link != 0: u and the
// moments mom[0, 2F) come from vcg_trunk_link_fwd, which wrote x. Phases
// [from, to) of block_fwd (0, 4: the whole forward); between calls mom
// holds m1 [2F] | m2 [2F] | m3 [2Co] | mp [2Co] (sums, sums of squares),
// and count_scale multiplies every pixel count (1 on one card).
extern "C" int vcg_block_train_fwd(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* wp, const void* gb, void* u, void* z, void* p, void* pr,
    void* stats, void* vec, void* mom, void* part, int n, int h, int w,
    int c, int f, int co, int stride, int t, int fold, int link, float eps,
    int from, int to, double count_scale, void* stream) {
  return vcg::block_fwd(x, w1, w2, w3, wp, static_cast<const float*>(gb), u,
                        z, p, pr, static_cast<float*>(stats),
                        static_cast<float*>(vec), static_cast<float*>(mom),
                        static_cast<float*>(part), n, h, w, c, f, co, stride,
                        t, fold, eps, link, from, to, count_scale,
                        static_cast<cudaStream_t>(stream));
}

// The finale y [M, Co] = relu(bn3(p) + (r or bnp(r))) from the block's vec
// (proj != 0: r is pr, else the block input x).
extern "C" int vcg_finale_fwd(const void* p, const void* r, const void* vec,
                              void* y, int m, int f, int co, int proj,
                              void* stream) {
  return vcg::finale_fwd(p, r, static_cast<const float*>(vec), y, m, f, co,
                         proj, static_cast<cudaStream_t>(stream));
}

// The finale's backward prologue: dq = dy * (y > 0) [M, Co] and mom3 [3Co]
// = (sum dq, sum dq (p - mu3), sum dq (pr - mup); 0 without pr) with mu3
// and mup from the block's stats. part: vcg_block_train_workspace floats.
extern "C" int vcg_finale_bwd(const void* dy, const void* y, const void* p,
                              const void* pr, const void* stats, void* dq,
                              void* mom3, void* part, int m, int f, int co,
                              void* stream) {
  return vcg::finale_bwd(dy, y, p, pr, static_cast<const float*>(stats), dq,
                         static_cast<float*>(mom3), static_cast<float*>(part),
                         m, f, co, static_cast<cudaStream_t>(stream));
}

// The trunk's forward link: block N's conv1 reading block N-1's p [M, C]
// and r [M, C] (its x, or its pr when proj_prev) with block N-1's vec
// (F' = fprev); writes block N's input x [M, C], u [M, F] and the moments
// of u into mom1 [2F]. part: block N's vcg_block_train_workspace floats.
extern "C" int vcg_trunk_link_fwd(const void* p_prev, const void* r_prev,
                                  const void* vec_prev, const void* w1,
                                  void* x, void* u, void* mom1, void* part,
                                  int n, int h, int w, int c, int f,
                                  int fprev, int proj_prev, int t, int fold,
                                  void* stream) {
  return vcg::link_fwd(p_prev, r_prev, static_cast<const float*>(vec_prev),
                       w1, x, u, static_cast<float*>(mom1),
                       static_cast<float*>(part), n, h, w, c, f, fprev,
                       proj_prev, t, fold, static_cast<cudaStream_t>(stream));
}

// The trunk's backward link: block N's conv1 data gradient from da1 [M, F],
// u and abc1 (the last 3F floats of block N's backward work), unshifted
// onto res [M, C] (block N's dq, or its projection's data gradient),
// masked by x (block N's input) into dq_prev [M, C], with mom3_prev [3C]
// from p_prev, pr_prev (or null) and block N-1's stats (F' = fprev).
// w1t [F, C]. part: block N's vcg_block_train_workspace floats.
extern "C" int vcg_trunk_link_bwd(
    const void* da1, const void* u, const void* abc1, const void* w1t,
    const void* res, const void* x, const void* p_prev, const void* pr_prev,
    const void* stats_prev, void* dq_prev, void* mom3_prev, void* part,
    int n, int h, int w, int c, int f, int fprev, int t, int fold,
    void* stream) {
  return vcg::link_bwd(da1, u, static_cast<const float*>(abc1), w1t, res, x,
                       p_prev, pr_prev, static_cast<const float*>(stats_prev),
                       dq_prev, static_cast<float*>(mom3_prev),
                       static_cast<float*>(part), n, h, w, c, f, fprev, t,
                       fold, static_cast<cudaStream_t>(stream));
}

// The trunk's recomputation (tsm_trunk_train_pallas.py:96-101): p =
// conv1x1(relu(bn2(z))) from the saved z [M2, F], w3 [F, Co] and the
// forward's vec, into p [M2, Co]. The same launch as the forward's FK3 on
// the same operands, so p comes back bit for bit; its moments go to the
// scratch mom [2Co] and are not used. part: vcg_block_train_workspace
// floats of the block.
extern "C" int vcg_block_train_recompute_p(const void* z, const void* w3,
                                           const void* vec, void* p,
                                           void* mom, void* part, int n,
                                           int ho, int wo, int f, int co,
                                           void* stream) {
  const float* v = static_cast<const float*>(vec);
  return static_cast<int>(vcg::conv_fwd(
      vcg::act(z, v + 2 * f, v + 3 * f, 1, 0),
      vcg::geo(n, ho, wo, f, 1, 1, 0, co), w3, p, static_cast<float*>(mom),
      static_cast<float*>(part), static_cast<cudaStream_t>(stream)));
}

// Floats of the `part` scratch the entries need for this block shape.
extern "C" long long vcg_block_train_workspace(int n, int h, int w, int c,
                                               int f, int co, int stride) {
  return static_cast<long long>(
      vcg::block_workspace(n, h, w, c, f, co, stride));
}

// From dq [M2, Co] and mom3 [3Co] (vcg_finale_bwd or the block above's
// vcg_trunk_link_bwd). Transposed weights (bf16): w1t [F, C], w2t [9F, F]
// with rows (kh, kw, f) and columns c (HWIO with I and O swapped), w3t
// [Co, F], wpt [Co, C] or null. Outputs: dx [M1, C] bf16 (link != 0: the
// projection's data gradient only, untouched without one), dw* f32 in the
// forward layouts, dgb f32 in the stats layout. Scratch: da2 [M2, F], da1
// [M1, F] bf16; work 10F + 6Co floats (its last 3F: BN1's backward
// vectors, which the link reads); part vcg_block_train_workspace floats.
// Phases [from, to) of block_bwd (0, 3: the whole backward); between
// calls work[0, 2F) and work[2F, 4F) hold the moments of da2 and da1, and
// count_scale multiplies every pixel count (1 on one card).
extern "C" int vcg_block_train_bwd(
    const void* dq, const void* mom3, const void* x, const void* u,
    const void* z, const void* p, const void* pr, const void* w1t,
    const void* w2t, const void* w3t, const void* wpt, const void* gb,
    const void* stats, const void* vec, void* dx, void* dw1, void* dw2,
    void* dw3, void* dwp, void* dgb, void* da2, void* da1, void* work,
    void* part, int n, int h, int w, int c, int f, int co, int stride,
    int t, int fold, int link, float eps, int from, int to,
    double count_scale, void* stream) {
  return vcg::block_bwd(
      dq, static_cast<const float*>(mom3), x, u, z, p, pr, w1t, w2t, w3t,
      wpt, static_cast<const float*>(gb), static_cast<const float*>(stats),
      static_cast<const float*>(vec), dx, static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(dw3),
      static_cast<float*>(dwp), static_cast<float*>(dgb), da2, da1,
      static_cast<float*>(work), static_cast<float*>(part), n, h, w, c, f,
      co, stride, t, fold, eps, link, from, to, count_scale,
      static_cast<cudaStream_t>(stream));
}
