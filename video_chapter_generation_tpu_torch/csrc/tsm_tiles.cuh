// The convolution tiles of the serving TSM bottleneck on hopper_gemm.cuh's
// wgmma mainloop, shared by K5 (tsm_conv.cu), K2-K4 (tsm_bottleneck.cu)
// and K15 (tsm_chain.cu), so that a conv phase of the chain computes each
// output tile with the same instructions as the per-block launches.
//
// Every conv is a persistent walk over [M / 128] x [N / BN] output tiles
// (walk_tiles: tile blockIdx.x + i gridDim.x, row tile = tile / (N / BN)),
// loads streaming two stages ahead across tile boundaries, the epilogue
// from the accumulator registers (store_tile):
//   - ShiftSrc: the shift + 1x1 conv of K5 (conv1 of every block);
//   - ConvSrc: a 3x3 (pad 1) or 1x1 conv at stride 1 or 2, optionally
//     with a residual tile added before the ReLU (conv2, conv3, the
//     projection).
#pragma once

#include "hopper_gemm.cuh"

namespace vcg {
namespace hop {

// K5's ring: two stages ahead with a product in flight.
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

// A conv's ring. A stage's product is short next to what a stage costs
// besides (its barrier, waits and copies), and a deeper ring alone did
// not hide that; a second block on the SM does, where two fit: at BN 64
// (four stages, a product in flight) and BN 128 (three stages, products
// waited). BN 256 keeps K5's four stages, one block. A residual tile
// rides in the slot of a tile's last stage until the epilogue, so there
// each product is waited before the next copies. (Two 64-deep k-blocks
// a stage, halving the barriers a product, ran no faster.)
template <int BN, bool kRes>
struct ConvRing {
  static constexpr int kStages = (kRes || BN == 128) ? 3 : 4;
  static constexpr bool kOverlap = !kRes && BN != 128;
  static constexpr int kBlocks = (!kRes && BN <= 128) ? 2 : 1;  // an SM
};
constexpr int kMaxStages = 4;

// The operands of a conv over an NHWC activation x [n, h, w, c] (c % 64
// == 0, so a 64-deep stage lies inside one tap): A rows are the output
// pixels m0.. of a 3x3 (pad 1) or 1x1 conv at stride 1 or 2, k = (kh, kw,
// c); B = w [ks ks c][nout] by TMA. At stride 1 a stage of A is the dense
// [M][c] view of x shifted by the tap, dh w + dw rows: one TMA box (rows
// past x read zeros), after which xform zeroes the rows whose tap leaves
// the image (the padding: x arrives already activated, so a zero row is
// a zero). At stride 2 the rows are strided: cp.async, thread i copying
// chunk i % 8 of rows i / 8 + 32 j, their pixels decoded once a tile and
// the tap once a stage, zero-filled outside the image. With kRes the
// last stage of a tile also brings the residual tile [128][BN] of res
// (as BN / 64 TMA boxes) into the slot, after the A and B tiles.
template <int BN, bool kRes>
struct ConvSrc {
  static_assert(!kRes || BN <= 128, "a residual tile fits at BN <= 128");
  static constexpr int kResBytes = kRes ? BN * 256 : 0;
  static constexpr int kResAt = kATile + BN * 128;
  static constexpr int kStageBytes = kResAt + kResBytes;
  static constexpr bool kTma = true;
  const bf16* x;
  const CUtensorMap* xmap;  // x as [n h w][c], boxes 128 x 64 (stride 1)
  const CUtensorMap* wmap;  // w as [ks ks c][nout], boxes 64 x 64
  const CUtensorMap* rmap;  // kRes: res as [m][nout], boxes 128 x 64
  int m, c, nout, h, w, ho, wo, ks, stride, ntn;
  int cpt, ktiles;  // stages a tap, stages
  // the tiles whose rows are decoded below, for load (lt) and xform (xt)
  int lt, xt;
  int lih[4], liw[4], lpix[4];  // stride 2: input pixel of the (0, 0) tap
  int xoh[4], xow[4];           // stride 1, 3x3: output pixel

  __device__ int tile_of(int tile) const {
    return static_cast<int>(blockIdx.x + tile * gridDim.x);
  }

  // decode output row m into (image, oh, ow)
  __device__ void pixel(int mm, int& n, int& oh, int& ow) const {
    const int plane = ho * wo;
    n = mm / plane;
    const int rem = mm - n * plane;
    oh = rem / wo;
    ow = rem - oh * wo;
  }

  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    const int tg = tile_of(tile);
    const int m0 = (tg / ntn) * kBM;
    const int n0 = (tg % ntn) * BN;
    const int tap = kt / cpt;
    const int ch = (kt - tap * cpt) * kHBK;
    const int kh = tap / ks;
    const int kw = tap - kh * ks;
    const int pad = ks / 2;
    const bool gather = stride != 1;
    const bool res = kRes && kt == ktiles - 1;
    if (threadIdx.x == 0) {
      mbar_expect(bar, BN * 128 + (gather ? 0 : kATile) +
                           (res ? kResBytes : 0));
      if (!gather)
        tma_load(st, xmap, ch, m0 + (kh - pad) * w + (kw - pad), bar);
    }
    tma_w<BN>(st + kATile, wmap, kt * kHBK, n0, bar, 1);
    if (res) {
#pragma unroll
      for (int p = 0; p < BN / 64; ++p)
        if (tma_lane(1 + BN / 64, p))
          tma_load(st + kResAt + p * kATile, rmap, n0 + 64 * p, m0, bar);
    }
    if (!gather) return;
    if (tile != lt) {
      lt = tile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = m0 + (threadIdx.x >> 3) + 32 * j;
        int n, oh, ow;
        pixel(mm < m ? mm : 0, n, oh, ow);
        // a row past m gets a pixel no tap reaches
        lih[j] = mm < m ? oh * stride - pad : -4;
        liw[j] = ow * stride - pad;
        lpix[j] = (n * h + lih[j]) * w + liw[j];
      }
    }
    const int kc = threadIdx.x & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (threadIdx.x >> 3) + 32 * j;
      const bool ok =
          static_cast<unsigned>(lih[j] + kh) < static_cast<unsigned>(h) &&
          static_cast<unsigned>(liw[j] + kw) < static_cast<unsigned>(w);
      const size_t off =
          static_cast<size_t>(lpix[j] + kh * w + kw) * c + ch + kc * 8;
      cp_async16(st + swz(r, kc), ok ? x + off : x, ok);
    }
  }

  // stride 1, 3x3: zero the rows whose tap leaves the image
  __device__ void xform(uint8_t* st, int tile, int kt) {
    if (ks != 3 || stride != 1) return;
    const int tap = kt / cpt;
    const int dh = tap / 3 - 1;
    const int dw = tap - 3 * (tap / 3) - 1;
    if (dh == 0 && dw == 0) return;
    if (tile != xt) {
      xt = tile;
      const int m0 = (tile_of(tile) / ntn) * kBM;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = m0 + (threadIdx.x >> 3) + 32 * j;
        int n;
        pixel(mm < m ? mm : 0, n, xoh[j], xow[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (static_cast<unsigned>(xoh[j] + dh) >= static_cast<unsigned>(h) ||
          static_cast<unsigned>(xow[j] + dw) >= static_cast<unsigned>(w))
        *reinterpret_cast<uint4*>(
            st + swz((threadIdx.x >> 3) + 32 * j, threadIdx.x & 7)) =
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

// conv3's epilogue: relu(v * scale + bias + res), res read from the
// residual tile in shared memory (BN / 64 swizzled [128][64] panels) at
// the lane's rows of store_tile (16 w + lane / 4, and 8 more).
struct ResAff {
  const float* scale;
  const float* bias;
  const uint8_t* res;
  int n0;
  __device__ void operator()(int c, float (&y)[4]) const {
    const float2 s = __ldg(reinterpret_cast<const float2*>(scale + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
    const int tc = c - n0;
    const int r = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
    const uint8_t* p = res + (tc >> 6) * kATile + 2 * (tc & 7);
    const float2 ra = unpack2(*reinterpret_cast<const uint32_t*>(
        p + swz(r, (tc & 63) >> 3)));
    const float2 rb = unpack2(*reinterpret_cast<const uint32_t*>(
        p + swz(r + 8, (tc & 63) >> 3)));
    y[0] = fmaxf(fmaf(y[0], s.x, b.x) + ra.x, 0.0f);
    y[1] = fmaxf(fmaf(y[1], s.y, b.y) + ra.y, 0.0f);
    y[2] = fmaxf(fmaf(y[2], s.x, b.x) + rb.x, 0.0f);
    y[3] = fmaxf(fmaf(y[3], s.y, b.y) + rb.y, 0.0f);
  }
};

// This block's tiles of a persistent grid over `tiles` output tiles:
// tile blockIdx.x + i gridDim.x for i = 0, 1, ...; epi(stg, acc, i, tile)
// after each (stg: this warp's 1 KB of store staging after the ring).
template <int BN, int S, bool kOverlap, class Src, class Epi>
__device__ void walk_tiles(uint8_t* sm, uint64_t* bars, Src& src, int tiles,
                           int ktiles, Epi epi) {
  using ML = Mainloop<BN, S, 0, Src, kOverlap>;
  uint8_t* stg = sm + ML::kRingBytes + (threadIdx.x >> 5) * 1024;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  ML ml(sm, bars, src, mine, ktiles);
  float acc[BN / 2];
  for (int i = 0; i < mine; ++i) {
    ml.tile(acc);
    epi(stg, acc, i, static_cast<int>(blockIdx.x + i * gridDim.x));
  }
  ml.finish();
}

// Dynamic shared memory of the walks below.
template <int BN>
__host__ __device__ constexpr int shift_smem() {
  return kConvStages * ShiftSrc<BN>::kStageBytes + kStoreBytes + kAlignSlack;
}

template <int BN, bool kRes>
__host__ __device__ constexpr int conv_smem() {
  return ConvRing<BN, kRes>::kStages * ConvSrc<BN, kRes>::kStageBytes +
         kStoreBytes + kAlignSlack;
}

// K5's tiles: y = act(shift(x) @ w * scale + bias) into out [M][F].
template <int BN>
__device__ void shift_tiles(uint8_t* sm, uint64_t* bars, ShiftSrc<BN>& src,
                            const ScaleBias& aff, bf16* out, int tiles) {
  walk_tiles<BN, kConvStages, true>(
      sm, bars, src, tiles, (src.c + kHBK - 1) / kHBK,
      [&](uint8_t* stg, const float(&acc)[BN / 2], int, int tg) {
        store_tile<BN>(stg, acc, aff, out, src.f,
                       (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16, src.m,
                       (tg % src.ntn) * BN, nullptr, nullptr);
      });
}

// A conv's tiles: out [M][nout] = act(conv(x) * scale + bias [+ res]).
template <int BN, bool kRes>
__device__ void conv_tiles(uint8_t* sm, uint64_t* bars,
                           ConvSrc<BN, kRes>& src, const ScaleBias& aff,
                           bf16* out, int tiles) {
  using Ring = ConvRing<BN, kRes>;
  constexpr int S = Ring::kStages;
  walk_tiles<BN, S, Ring::kOverlap>(
      sm, bars, src, tiles, src.ktiles,
      [&](uint8_t* stg, const float(&acc)[BN / 2], int i, int tg) {
        const int n0 = (tg % src.ntn) * BN;
        const int row0 = (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16;
        if constexpr (kRes) {
          // the residual rode in the slot of this tile's last stage, which
          // is reloaded only after the next stage's barrier
          const int q = (i + 1) * src.ktiles - 1;
          const uint8_t* res = sm + (q % S) * ConvSrc<BN, kRes>::kStageBytes +
                               ConvSrc<BN, kRes>::kResAt;
          store_tile<BN>(stg, acc, ResAff{aff.scale, aff.bias, res, n0}, out,
                         src.nout, row0, src.m, n0, nullptr, nullptr);
        } else {
          store_tile<BN>(stg, acc, aff, out, src.nout, row0, src.m, n0,
                         nullptr, nullptr);
        }
      });
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// K5's tile width: BN = 256 where F allows it (reads x fewer times).
__host__ __device__ inline int shift_bn(int f) {
  return f % 256 == 0 ? 256 : f % 128 == 0 ? 128 : 64;
}

// A conv's tile width: the widest BN (at most 128 with a residual tile)
// dividing nout, unless its tiles run more than one wave over the card's
// SMs and fill less than 90% of their waves; else 64. Layer 4's conv2
// (98 row tiles) takes 128: BN 256 would leave a second wave 48% full.
// (Counting two blocks an SM at BN 128 would send it to BN 64, which
// timed slower.)
inline int conv_bn(int m, int nout, int sms, bool res) {
  const long long mt = (m + kBM - 1) / kBM;
  for (int bn = res ? 128 : 256; bn > 64; bn /= 2) {
    if (nout % bn) continue;
    const long long tiles = mt * (nout / bn);
    const long long waves = (tiles + sms - 1) / sms;
    if (tiles <= sms || 10 * tiles >= 9 * waves * sms) return bn;
  }
  return 64;
}

// A ShiftSrc over x [n*h*w][c] for out [.][f] (tensor maps set by the caller).
template <int BN>
__host__ __device__ ShiftSrc<BN> shift_src(const bf16* x, int m, int plane,
                                           int c, int f, int t, int fold) {
  ShiftSrc<BN> s{};
  s.x = x;
  s.m = m;
  s.c = c;
  s.f = f;
  s.plane = plane;
  s.t = t;
  s.fold = fold;
  s.ntn = f / BN;
  return s;
}

// A ConvSrc over x [n, h, w, c] (ks 1 or 3, pad ks / 2) for out [m][nout].
template <int BN, bool kRes>
__host__ __device__ ConvSrc<BN, kRes> conv_src(const bf16* x, int n, int h,
                                               int w, int c, int ks,
                                               int stride, int nout) {
  ConvSrc<BN, kRes> s{};
  s.x = x;
  s.h = h;
  s.w = w;
  s.c = c;
  s.ks = ks;
  s.stride = stride;
  s.ho = (h - 1) / stride + 1;
  s.wo = (w - 1) / stride + 1;
  s.m = n * s.ho * s.wo;
  s.nout = nout;
  s.ntn = nout / BN;
  s.cpt = c / kHBK;
  s.ktiles = ks * ks * s.cpt;
  s.lt = -1;
  s.xt = -1;
  return s;
}

}  // namespace hop
}  // namespace vcg
