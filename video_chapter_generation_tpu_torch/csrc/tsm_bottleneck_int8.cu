// W8A8 inference TSM bottlenecks for Hopper (sm_90a): the stride-1 plain
// block (kernel K9) and the stride-2 projection block0 (kernel K14a).
//
// vcg_tsm_bottleneck_int8 replaces video_chapter_generation_tpu/ops/
// tsm_block_int8_pallas.py:tsm_bottleneck_int8_pallas (_kernel_flat_i8,
// _kernel_halo_i8). It computes the integer spec of that file (:26-39)
// exactly as its plain version, ops/tsm_block_int8.py:
// int8_bottleneck_plain, does:
//
//   xq   = x (int8) or clip(round(x / sx))            (stage entry, bf16)
//   y1   = relu(f32(shift(xq) @ w1q) * a1 + b1)
//   y1q  = clip(round(y1 / sz))       (the conv2 im2col is y1q shifted)
//   d_r  = f32(sum_{dc,c} y1q[h+r-1, w+dc-1, c] w2q_r[dc,c]) * a2_r
//   y2   = relu(((d_1 + d_0) + d_2) + b2),   y2q = clip(round(y2 / sy2))
//   out  = relu((f32(y2q @ w3q) * a3 + b3) + xf),  xf = xq * sx or x
//   store clip(round(out / sout)) as int8, or out as bf16.
//
// vcg_tsm_bottleneck_s2_int8 replaces tsm_block_int8_pallas.py:
// tsm_bottleneck_s2_planar_int8_pallas (_kernel_s2_planar_i8, :250), whose
// integer spec is int8_s2_bottleneck_reference (:609); its plain version
// is ops/tsm_block_int8.py:int8_s2_bottleneck_plain. conv1 runs as above
// at full resolution; conv2 runs at stride 2 with pad (1, 1), output pixel
// (oh, ow) reading y1q at (2 oh + dr - 1, 2 ow + dc - 1), the same per-tap
// dequant and tap order; then
//   out  = relu((f32(y2q @ w3q) * a3 + b3) + (f32(xq[2oh, 2ow] @ wpq) * ap
//          + bp))
// with the projection on the same quantized input. The TPU kernel's
// pair-merged input is a row-major view of NHWC, so this entry reads NHWC.
//
// Rounding follows the plain versions: a division by each scale (an
// IEEE quotient: quant_bits() below takes it from a reciprocal multiply
// where that provably rounds to the same integer; the TPU kernels multiply
// by a reciprocal and may differ), round half to even, every product and
// sum rounded on its own
// (__fmul_rn/__fadd_rn: nvcc would otherwise contract them into FMAs),
// and each row tap of the 3x3 kept in its own int32 accumulator, turned
// into float once (the sum of one tap reaches 3F * 127^2 > 2^24, so where
// it is rounded matters) and added in the reference's order. The int32
// sums are exact in any order, so the products may run in wgmma's.
//
// What bounds them on the H100: the int8 products. A block does
// 2 * (M * C*F + Mo * (9*F*F + F*Cout [+ C*Cout])) integer ops against
// about one byte per activation element, above the card's ridge point at
// layers 3-4 (1,979 TOP/s int8 against 3.35 TB/s); layer 2's conv1 and
// conv3 are near it. Design: three persistent launches a block, each a
// walk over [M / 128] x [N / 128] output tiles on hopper_gemm.cuh's ring
// with its s8 wgmma (m64n128k32, both operands K-major: 128 int8 k a
// 128-byte swizzled row; int32 accumulators in registers), loads running
// ahead across tile boundaries, the epilogue from the accumulator
// registers (store_rows: whole 16-byte chunks of output rows):
//   - bf16 x (the first block of a stage) is quantized to xq by its own
//     elementwise launch first (its bytes at the card's rate: quantizing
//     on load inside conv1, from registers or a staged bf16 box, ran
//     slower, one block an SM);
//   - conv1: shift(xq) @ w1. A stage whose 128 channels share one frame
//     offset is one TMA box of xq viewed as [M][C] at a row offset of +-1
//     frame, the rows whose shift leaves their clip zeroed on arrival; a
//     stage that mixes offsets (layer 2: fold 64) is copied by cp.async;
//   - conv2: the 3x3 as three row taps walked in the order 1, 0, 2, each
//     K = 3F (dc, c) into one int32 accumulator that is drained after the
//     tap's last stage, turned into float once, scaled and folded into a
//     float running sum (64 + 64 registers a thread at BN 128, not 3 x 64).
//     At stride 1 a stage is one TMA box of y1q shifted by the tap (rows
//     that leave the image zeroed on arrival); at stride 2 (K14a) a
//     cp.async gather, the pixels decoded once a tile;
//   - conv3: y2q @ w3 by TMA, two blocks an SM. K9's residual x (int8 or
//     bf16) is read from device memory in the epilogue; K14a's projection
//     xq[2oh, 2ow] @ wp follows in the same tile into a second int32
//     accumulator (gathered by cp.async), each dequantized on its own as
//     the spec adds them.
// y1q and y2q round-trip device memory as int8 (a quarter of the bf16
// path's bytes). The TPU kernel's row tiles with a one-row halo exist for
// VMEM only and are not carried over.
#include <algorithm>

#include "hopper_gemm.cuh"

namespace vcg {
namespace {

using namespace hop;

constexpr int kBN8 = 128;                     // tile width (output channels)
constexpr int kStage8 = kATile + kBN8 * 128;  // A and B panels, 32 KB

// The epilogues convert one value or more an output element, and the
// card converts at a quarter of its float rate: where exact, integers and
// roundings are made with full-rate adds instead. kMagic = 1.5 * 2^23 has
// ulp 1 and float bits 0x4B400000; for |x| < 2^22, x + kMagic rounds x to
// an integer half to even (kMagic is even), and the bits of the sum are
// 0x4B400000 plus that integer.
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// float(i) for |i| < 2^22, exactly
__device__ __forceinline__ float small_i2f(int i) {
  return __fsub_rn(__int_as_float(kMagicBits + i), kMagic);
}

// clip(round(v / s), -127, 127) with v / s the IEEE quotient, rounded half
// to even, as the float bits of kMagic plus that integer (its low byte is
// the int8), at the cost of a multiply where it can: an IEEE division is
// a few dozen instructions, and at one per output element it set the pace
// of every epilogue. With inv = 1 / s rounded (__frcp_rn), r = v * inv
// lies within 3 ulp of the rounded quotient q (|v / s| < 128: 2.3e-5), so
// where r lies more than 2^-13 from every half-integer, r and q round to
// the same integer; clipping r to +-127 first clips the same (127.5
// rounds to 128). Only the rest divides: about 1 in 4,000 values of an
// arbitrary scale, on a branch the warp rarely takes, through one
// out-of-line copy of the division (inlined at each of an epilogue's 64
// unrolled sites, its code cost more time than its rare runs).
__device__ __noinline__ float quant_exact(float v, float s) {
  return __fadd_rn(fminf(fmaxf(__fdiv_rn(v, s), -127.0f), 127.0f), kMagic);
}

__device__ __forceinline__ uint32_t quant_bits(float v, float s, float inv) {
  const float r = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  float t = __fadd_rn(r, kMagic);
  if (fabsf(__fsub_rn(r, __fsub_rn(t, kMagic))) >= 0.5f - 1.0f / 8192.0f)
    t = quant_exact(v, s);
  return __float_as_uint(t);
}

// the low bytes of a and b as the two bytes of a 16-bit word
__device__ __forceinline__ uint32_t pack_lo2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x0040);
}

__device__ __forceinline__ float i2f(int v) { return __int2float_rn(v); }

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// four bf16 (two words) quantized by sx (inv = 1 / sx) into four int8 bytes
__device__ __forceinline__ uint32_t quant4(uint32_t w0, uint32_t w1,
                                           float sx, float inv) {
  const uint32_t a = quant_bits(__uint_as_float(w0 << 16), sx, inv);
  const uint32_t b = quant_bits(__uint_as_float(w0 & 0xffff0000u), sx, inv);
  const uint32_t c = quant_bits(__uint_as_float(w1 << 16), sx, inv);
  const uint32_t d = quant_bits(__uint_as_float(w1 & 0xffff0000u), sx, inv);
  return __byte_perm(pack_lo2(a, b), pack_lo2(c, d), 0x5410);
}

// xq = clip(round(x / sx)) over n bf16 values (n % 16 == 0), 16 a thread
__global__ void quantize_kernel(const bf16* x, int8_t* xq, size_t n,
                                float sx) {
  const float inv = __frcp_rn(sx);
  for (size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x) * 16;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x * 16) {
    const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(x + i));
    const uint4 v1 = __ldg(reinterpret_cast<const uint4*>(x + i) + 1);
    *reinterpret_cast<uint4*>(xq + i) =
        make_uint4(quant4(v0.x, v0.y, sx, inv), quant4(v0.z, v0.w, sx, inv),
                   quant4(v1.x, v1.y, sx, inv), quant4(v1.z, v1.w, sx, inv));
  }
}

__device__ __forceinline__ int tile_of(int i) {
  return static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
}

// This block's tiles of a persistent grid over `tiles`.
__device__ __forceinline__ int my_tiles(int tiles) {
  return (tiles - static_cast<int>(blockIdx.x) +
          static_cast<int>(gridDim.x) - 1) / gridDim.x;
}

// conv1's operands: A = shift(xq) rows [m0, m0 + 128) of xq [M][C]
// (frames time-major per clip: channels < fold from frame t + 1, < 2 fold
// from t - 1, zero past the clip), B = w1t [F][C] by TMA. A stage whose
// 128 channels share one frame offset is one TMA box at that row offset,
// the rows whose shift leaves the clip zeroed on arrival; one that mixes
// offsets (fold % 128 != 0) is copied by cp.async, thread i taking chunk
// i % 8 of rows i / 8 + 32 j.
struct ShiftI8 {
  static constexpr int kStageBytes = kStage8;
  static constexpr bool kTma = true;
  const int8_t* x;
  const CUtensorMap* xmap;  // x as [M][C], boxes 128 x 128
  const CUtensorMap* wmap;  // w1t [F][C], boxes 128 x 128
  int m, c, f, plane, t, fold, ntn;

  // the frame offset of the stage's channels from k0 (none, +1 or -1
  // frame: region 0, 1, 2), or -1 where they mix
  __device__ int region(int k0) const {
    if (fold == 0 || k0 >= 2 * fold) return 0;
    if (fold % kIBK) return -1;
    return k0 < fold ? 1 : 2;
  }

  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    const int k0 = kt * kIBK;
    const int tg = tile_of(tile);
    const int m0 = (tg / ntn) * kBM, n0 = (tg % ntn) * kBN8;
    const int reg = region(k0);
    if (threadIdx.x == 0) {
      mbar_expect(bar, kBN8 * 128 + (reg >= 0 ? kATile : 0));
      if (reg >= 0)
        tma_load(st, xmap, k0,
                 m0 + (reg == 1 ? plane : (reg == 2 ? -plane : 0)), bar);
    }
    if (tma_lane(1, 0)) tma_load(st + kATile, wmap, k0, n0, bar);
    if (reg >= 0) return;
    const int kc = threadIdx.x & 7;
    const int ch = k0 + kc * 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (threadIdx.x >> 3) + 32 * j;
      int src = m0 + r;
      bool ok = src < m;
      if (ch < 2 * fold) {
        const int tt = (src / plane) % t;
        const bool fwd = ch < fold;
        ok = ok && (fwd ? tt < t - 1 : tt > 0);
        src += fwd ? plane : -plane;
      }
      cp_async16(st + swz(r, kc),
                 x + (ok ? static_cast<size_t>(src) * c + ch : 0), ok);
    }
  }

  // A stage that came by TMA from a shifted offset: zero the rows whose
  // frame t + 1 (region 1) or t - 1 (region 2) lies outside their clip.
  __device__ void xform(uint8_t* st, int tile, int kt) const {
    const int reg = region(kt * kIBK);
    if (reg <= 0) return;
    const int m0 = (tile_of(tile) / ntn) * kBM;
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

// conv2's operands: A row = output pixel of a 3x3 (pad 1) over y1q
// [n, h, w, f] at stride 1 or 2, B = w2t [3 f (row tap, out)][3 f (dc, c)].
// Stage kt is row tap dr (the taps in the order 1, 0, 2), column tap dc,
// channels ch.. of y1q (f % 128 == 0, so a stage lies inside one tap).
struct Tap3I8 {
  static constexpr int kStageBytes = kStage8;
  static constexpr bool kTma = true;
  const int8_t* y;
  const CUtensorMap* ymap;  // stride 1: y as [n h w][f], boxes 128 x 128
  const CUtensorMap* wmap;  // w2t as [3 f][3 f], boxes 128 x 128
  int m, f, h, w, ho, wo, stride, ntn, cpt, spt;  // cpt = f / 128, spt = 3 cpt
  // the tiles whose rows are decoded below, for load (lt) and xform (xt)
  int lt, xt;
  int lih[4], liw[4], lpix[4];  // stride 2: input pixel of the (0, 0) tap
  int xoh[4], xow[4];           // stride 1: output pixel

  __device__ void pixel(int mm, int& n, int& oh, int& ow) const {
    const int plane = ho * wo;
    n = mm / plane;
    const int rem = mm - n * plane;
    oh = rem / wo;
    ow = rem - oh * wo;
  }

  __device__ void decode(int kt, int& dr, int& dc, int& ch, int& kcol) const {
    const int ti = kt / spt, rem = kt - ti * spt;
    dr = ti == 0 ? 1 : (ti == 1 ? 0 : 2);
    dc = rem / cpt;
    ch = (rem - dc * cpt) * kIBK;
    kcol = rem * kIBK;
  }

  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    const int tg = tile_of(tile);
    const int m0 = (tg / ntn) * kBM, n0 = (tg % ntn) * kBN8;
    int dr, dc, ch, kcol;
    decode(kt, dr, dc, ch, kcol);
    const bool gather = stride != 1;
    if (threadIdx.x == 0) {
      mbar_expect(bar, kBN8 * 128 + (gather ? 0 : kATile));
      if (!gather) tma_load(st, ymap, ch, m0 + (dr - 1) * w + (dc - 1), bar);
    }
    if (tma_lane(1, 0)) tma_load(st + kATile, wmap, kcol, dr * f + n0, bar);
    if (!gather) return;
    if (tile != lt) {
      lt = tile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = m0 + (threadIdx.x >> 3) + 32 * j;
        int n, oh, ow;
        pixel(mm < m ? mm : 0, n, oh, ow);
        // a row past m gets a pixel no tap reaches
        lih[j] = mm < m ? oh * stride - 1 : -4;
        liw[j] = ow * stride - 1;
        lpix[j] = (n * h + lih[j]) * w + liw[j];
      }
    }
    const int kc = threadIdx.x & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok =
          static_cast<unsigned>(lih[j] + dr) < static_cast<unsigned>(h) &&
          static_cast<unsigned>(liw[j] + dc) < static_cast<unsigned>(w);
      const size_t off =
          ok ? static_cast<size_t>(lpix[j] + dr * w + dc) * f + ch + kc * 16
             : 0;
      cp_async16(st + swz((threadIdx.x >> 3) + 32 * j, kc), y + off, ok);
    }
  }

  // stride 1: zero the rows whose tap leaves the image
  __device__ void xform(uint8_t* st, int tile, int kt) {
    if (stride != 1) return;
    int dr, dc, ch, kcol;
    decode(kt, dr, dc, ch, kcol);
    if (dr == 1 && dc == 1) return;
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
      if (static_cast<unsigned>(xoh[j] + dr - 1) >= static_cast<unsigned>(h) ||
          static_cast<unsigned>(xow[j] + dc - 1) >= static_cast<unsigned>(w))
        *reinterpret_cast<uint4*>(
            st + swz((threadIdx.x >> 3) + 32 * j, threadIdx.x & 7)) =
            make_uint4(0, 0, 0, 0);
    }
  }
};

// K9's conv3 operands: A = y2q [M][F], B = w3t [C][F], both by TMA (the
// residual is read in the epilogue).
struct Conv3I8 {
  static constexpr int kStageBytes = kStage8;
  static constexpr bool kTma = true;
  const CUtensorMap* ymap;  // y2q [M][F], boxes 128 x 128
  const CUtensorMap* wmap;  // w3t [C][F], boxes 128 x 128
  int ntn;

  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    const int tg = tile_of(tile);
    const int m0 = (tg / ntn) * kBM, n0 = (tg % ntn) * kBN8;
    if (threadIdx.x == 0) {
      mbar_expect(bar, kATile + kBN8 * 128);
      tma_load(st, ymap, kt * kIBK, m0, bar);
    }
    if (tma_lane(1, 0)) tma_load(st + kATile, wmap, kt * kIBK, n0, bar);
  }
  __device__ void xform(uint8_t*, int, int) const {}
};

// K14a's conv3 operands: stages 0 .. k3 - 1 bring y2q [M2][F] and w3t
// [Cout][F] by TMA, the rest xq at input pixel (2 oh, 2 ow) of xq
// [n, h, w, c] by cp.async and wpt [Cout][C] by TMA.
struct PairI8 {
  static constexpr int kStageBytes = kStage8;
  static constexpr bool kTma = true;
  const CUtensorMap* ymap;  // y2q [M2][F], boxes 128 x 128
  const CUtensorMap* wmap;  // w3t [Cout][F], boxes 128 x 128
  const CUtensorMap* pmap;  // wpt [Cout][C], boxes 128 x 128
  const int8_t* x;
  int m, c, h, w, ho, wo, ntn, k3;
  int lt;
  size_t lsrc[4];  // the row's input pixel, in elements of x
  bool lok[4];

  __device__ void load(uint8_t* st, uint64_t* bar, int tile, int kt) {
    const int tg = tile_of(tile);
    const int m0 = (tg / ntn) * kBM, n0 = (tg % ntn) * kBN8;
    if (kt < k3) {
      if (threadIdx.x == 0) {
        mbar_expect(bar, kATile + kBN8 * 128);
        tma_load(st, ymap, kt * kIBK, m0, bar);
      }
      if (tma_lane(1, 0)) tma_load(st + kATile, wmap, kt * kIBK, n0, bar);
      return;
    }
    const int k0 = (kt - k3) * kIBK;
    if (threadIdx.x == 0) mbar_expect(bar, kBN8 * 128);
    if (tma_lane(1, 0)) tma_load(st + kATile, pmap, k0, n0, bar);
    if (tile != lt) {
      lt = tile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int mm = m0 + (threadIdx.x >> 3) + 32 * j;
        lok[j] = mm < m;
        const int q = lok[j] ? mm : 0;
        const int n = q / (ho * wo);
        const int rem = q - n * ho * wo;
        const int oh = rem / wo, ow = rem - (rem / wo) * wo;
        lsrc[j] = ((static_cast<size_t>(n) * h + 2 * oh) * w + 2 * ow) * c;
      }
    }
    const int kc = threadIdx.x & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cp_async16(st + swz((threadIdx.x >> 3) + 32 * j, kc),
                 x + (lok[j] ? lsrc[j] + k0 + kc * 16 : 0), lok[j]);
  }
  __device__ void xform(uint8_t*, int, int) const {}
};

// Store a warp's 16 x 128 tile from wgmma's register layout: fn(col, v, y)
// maps the lane's four values v (rows r and r + 8, r = lane / 4, at
// columns col and col + 1: v[0] (r, col), v[1] (r, col + 1), v[2] (r + 8,
// col), v[3] (r + 8, col + 1)) to outputs y, stored as int8
// clip(round(y / oscale)) (out_i8) or bf16 into out rows row0 .. row0 + 15
// (rows >= m skipped), columns n0 + tile column, through this warp's 1 KB
// of staging (stg) eight rows at a time: whole 16-byte chunks.
template <class V, class Fn>
__device__ void store_rows(uint8_t* stg, const V (&acc)[kBN8 / 2], Fn fn,
                           void* out, bool out_i8, float oscale, int ld,
                           int row0, int m, int n0) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, q = lane & 3;
  const float inv = __frcp_rn(oscale);
#pragma unroll
  for (int grp = 0; grp < kBN8 / 64; ++grp) {
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = 4 * (8 * grp + b);
      const V v[4] = {acc[i], acc[i + 1], acc[i + 2], acc[i + 3]};
      float y[4];
      fn(n0 + 64 * grp + 8 * b + 2 * q, v, y);
      if (out_i8) {
        lo[b] = pack_lo2(quant_bits(y[0], oscale, inv),
                         quant_bits(y[1], oscale, inv));
        hi[b] = pack_lo2(quant_bits(y[2], oscale, inv),
                         quant_bits(y[3], oscale, inv));
      } else {
        lo[b] = pack2(y[0], y[1]);
        hi[b] = pack2(y[2], y[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (out_i8) {
        // row rr (0..7) of this half: its 64 bytes at rr * 64
#pragma unroll
        for (int b = 0; b < 8; ++b)
          *reinterpret_cast<uint16_t*>(stg + r * 64 + 8 * b + 2 * q) =
              static_cast<uint16_t>(half ? hi[b] : lo[b]);
        __syncwarp();
        const int rr = lane >> 2, cc = lane & 3;
        const int gm = row0 + rr + 8 * half;
        const uint4 v =
            *reinterpret_cast<const uint4*>(stg + rr * 64 + 16 * cc);
        if (gm < m)
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) +
                                    static_cast<size_t>(gm) * ld + n0 +
                                    64 * grp + 16 * cc) = v;
      } else {
        // row rr (0..7) of this half: chunk b at (b ^ rr) * 16
#pragma unroll
        for (int b = 0; b < 8; ++b)
          *reinterpret_cast<uint32_t*>(stg + r * 128 + ((b ^ r) << 4) +
                                       4 * q) = half ? hi[b] : lo[b];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int rr = (lane >> 3) + 4 * k;
          const int cc = lane & 7;
          const int gm = row0 + rr + 8 * half;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + rr * 128 + ((cc ^ rr) << 4));
          if (gm < m)
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out) +
                                      static_cast<size_t>(gm) * ld + n0 +
                                      64 * grp + 8 * cc) = v;
        }
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[kBN8 / 2]) {
#pragma unroll
  for (int i = 0; i < kBN8 / 2; ++i) acc[i] = 0;
}

// Dynamic shared memory of an S-stage ring of Src, the store staging and
// the alignment slack.
template <class Src, int S>
constexpr int ring_smem() {
  return S * Src::kStageBytes + kStoreBytes + kAlignSlack;
}

// A launch's ring: its stages (every stage's product is waited before the
// next stage's copies; keeping one in flight ran no faster) and the blocks
// an SM its shared memory and registers leave room for.
template <int S, int kBl>
struct Ring {
  static constexpr int kStages = S;
  static constexpr int kBlocks = kBl;
};
using Ring1 = Ring<3, 2>;  // conv1
using Ring2 = Ring<4, 1>;  // conv2: per-tap drains, 229 registers
// K9's conv3: two blocks an SM, one stage ahead (a tile is often a single
// stage)
using Ring3 = Ring<2, 2>;
using RingP = Ring<4, 1>;  // K14a's conv3 and projection

// y1q = clip(round(relu(f32(shift(xq) @ w1q) * a1 + b1) / sz))
__global__ void __launch_bounds__(kThreads, Ring1::kBlocks)
    conv1_kernel(ShiftI8 src, const float* a1, const float* b1, float sz,
                 int8_t* y1q, int tiles,
                 const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap) {
  __shared__ alignas(8) uint64_t bars[Ring1::kStages];
  src.xmap = &xmap;
  src.wmap = &wmap;
  if (threadIdx.x == 0) {
    tma_prefetch(&xmap);
    tma_prefetch(&wmap);
  }
  uint8_t* sm = aligned_smem();
  uint8_t* stg = sm + Ring1::kStages * kStage8 + (threadIdx.x >> 5) * 1024;
  const int mine = my_tiles(tiles);
  Mainloop<kBN8, Ring1::kStages, 0, ShiftI8> ml(sm, bars, src, mine,
                                                src.c / kIBK);
  int acc[kBN8 / 2];
  for (int i = 0; i < mine; ++i) {
    zero(acc);
    ml.k_loop([&](const uint8_t* st, int) {
                mma_issue_s8(st, st + kATile, acc);
              },
              [&] { mma_wait<0>(acc); });
    const int tg = tile_of(i);
    store_rows<int>(
        stg, acc,
        [&](int col, const int (&v)[4], float (&y)[4]) {
          const float2 a = ldg2(a1 + col), b = ldg2(b1 + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = fmaxf(__fadd_rn(__fmul_rn(i2f(v[e]), (e & 1) ? a.y : a.x),
                                   (e & 1) ? b.y : b.x),
                         0.0f);
        },
        y1q, true, sz, src.f, (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16,
        src.m, (tg % src.ntn) * kBN8);
  }
  ml.finish();
}

// y2q = clip(round(relu(((d_1 + d_0) + d_2) + b2) / sy2)), d_r = f32(row
// tap r's int32 sum) * a2_r
__global__ void __launch_bounds__(kThreads, Ring2::kBlocks)
    conv2_kernel(Tap3I8 src, const float* a2, const float* b2, float sy2,
                 int8_t* y2q, int tiles,
                 const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap wmap) {
  __shared__ alignas(8) uint64_t bars[Ring2::kStages];
  src.ymap = &ymap;
  src.wmap = &wmap;
  if (threadIdx.x == 0) {
    if (src.stride == 1) tma_prefetch(&ymap);
    tma_prefetch(&wmap);
  }
  uint8_t* sm = aligned_smem();
  uint8_t* stg = sm + Ring2::kStages * kStage8 + (threadIdx.x >> 5) * 1024;
  const int mine = my_tiles(tiles);
  Mainloop<kBN8, Ring2::kStages, 0, Tap3I8> ml(sm, bars, src, mine,
                                               3 * src.spt);
  const int q = threadIdx.x & 3;
  int acc[kBN8 / 2];
  float sum[kBN8 / 2];
  for (int i = 0; i < mine; ++i) {
    const int tg = tile_of(i);
    const int n0 = (tg % src.ntn) * kBN8;
    zero(acc);
    int step = 0;
    ml.k_loop([&](const uint8_t* st, int) {
                mma_issue_s8(st, st + kATile, acc);
              },
              [&] {
                mma_wait<0>(acc);
                if (++step % src.spt) return;
                // a row tap's last stage: its sum to float once, scaled,
                // folded in the order 1, 0, 2
                const int ti = step / src.spt - 1;
                const float* a2r = a2 + (ti == 0 ? 1 : ti == 1 ? 0 : 2) * src.f;
#pragma unroll
                for (int j = 0; j < kBN8 / 8; ++j) {
                  const float2 a = ldg2(a2r + n0 + 8 * j + 2 * q);
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const float d =
                        __fmul_rn(i2f(acc[4 * j + e]), (e & 1) ? a.y : a.x);
                    sum[4 * j + e] =
                        ti == 0 ? d : __fadd_rn(sum[4 * j + e], d);
                    acc[4 * j + e] = 0;
                  }
                }
              });
    store_rows<float>(
        stg, sum,
        [&](int col, const float (&v)[4], float (&y)[4]) {
          const float2 b = ldg2(b2 + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = fmaxf(__fadd_rn(v[e], (e & 1) ? b.y : b.x), 0.0f);
        },
        y2q, true, sy2, src.f,
        (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16, src.m, n0);
  }
  ml.finish();
}

// K9's conv3 epilogue, out = relu((f32(acc) * a3 + b3) + xf), xf = x * sx
// (int8 x) or x (bf16), 32 columns at a time: the warp's 16 x 32
// accumulators go to its staging as words [16][kStg3Ld]; lane l then takes
// row l / 2, columns 16 (l % 2) .. + 15, in two runs of 8, with the scales,
// biases and residual as 16- or 8-byte loads and the outputs as one 16-byte
// int8 (two bf16) store. (In wgmma's layout a lane holds two columns of
// two rows: small loads for every pair of values, which left this epilogue
// waiting on latency.)
constexpr int kStg3Ld = 36;                   // words a staged row
constexpr int kStg3Bytes = 16 * kStg3Ld * 4;  // a warp's staging

template <bool kResI8>
__device__ void conv3_epilogue(uint32_t* stg, const int (&acc)[kBN8 / 2],
                               const void* x, const float* a3,
                               const float* b3, float sx, float sout,
                               void* out, bool out_i8, int c, int m,
                               int row0, int n0) {
  const int lane = threadIdx.x & 31, r = lane >> 2, q = lane & 3;
  const int gm = row0 + (lane >> 1);
  const float inv = __frcp_rn(sout);
#pragma unroll
  for (int qt = 0; qt < kBN8 / 32; ++qt) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = 4 * (4 * qt + jj);
      *reinterpret_cast<uint2*>(stg + r * kStg3Ld + 8 * jj + 2 * q) =
          make_uint2(acc[i], acc[i + 1]);
      *reinterpret_cast<uint2*>(stg + (r + 8) * kStg3Ld + 8 * jj + 2 * q) =
          make_uint2(acc[i + 2], acc[i + 3]);
    }
    __syncwarp();
    uint4 raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      raw[k] = *reinterpret_cast<const uint4*>(
          stg + (lane >> 1) * kStg3Ld + 16 * (lane & 1) + 4 * k);
    __syncwarp();
    const int col = n0 + 32 * qt + 16 * (lane & 1);
    if (gm >= m) continue;
    const size_t o = static_cast<size_t>(gm) * c + col;
    uint32_t packed[8];
#pragma unroll
    for (int run = 0; run < 2; ++run) {
      const int v[8] = {static_cast<int>(raw[2 * run].x),
                        static_cast<int>(raw[2 * run].y),
                        static_cast<int>(raw[2 * run].z),
                        static_cast<int>(raw[2 * run].w),
                        static_cast<int>(raw[2 * run + 1].x),
                        static_cast<int>(raw[2 * run + 1].y),
                        static_cast<int>(raw[2 * run + 1].z),
                        static_cast<int>(raw[2 * run + 1].w)};
      float a[8], b[8], xf[8];
      *reinterpret_cast<float4*>(a) =
          __ldg(reinterpret_cast<const float4*>(a3 + col + 8 * run));
      *reinterpret_cast<float4*>(a + 4) =
          __ldg(reinterpret_cast<const float4*>(a3 + col + 8 * run + 4));
      *reinterpret_cast<float4*>(b) =
          __ldg(reinterpret_cast<const float4*>(b3 + col + 8 * run));
      *reinterpret_cast<float4*>(b + 4) =
          __ldg(reinterpret_cast<const float4*>(b3 + col + 8 * run + 4));
      if (kResI8) {
        const uint2 p = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(x) + o + 8 * run));
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xf[e] = __fmul_rn(
              small_i2f(static_cast<int8_t>(((e < 4 ? p.x : p.y) >>
                                             (8 * (e & 3))) & 0xff)),
              sx);
      } else {
        const uint4 p = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(x) + o + 8 * run));
        const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 f = unpack2(w[e / 2]);
          xf[e] = f.x;
          xf[e + 1] = f.y;
        }
      }
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(i2f(v[e]), a[e]), b[e]),
                               xf[e]),
                     0.0f);
      if (out_i8) {
#pragma unroll
        for (int e = 0; e < 8; e += 4)
          packed[2 * run + e / 4] = __byte_perm(
              pack_lo2(quant_bits(y[e], sout, inv),
                       quant_bits(y[e + 1], sout, inv)),
              pack_lo2(quant_bits(y[e + 2], sout, inv),
                       quant_bits(y[e + 3], sout, inv)),
              0x5410);
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o + 8 * run) =
            make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                       pack2(y[4], y[5]), pack2(y[6], y[7]));
      }
    }
    if (out_i8)
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + o) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// K9's conv3: out = relu((f32(y2q @ w3q) * a3 + b3) + xf), xf = x * sx
// (int8 x) or x (bf16), read from x [M][C] in the epilogue.
template <bool kResI8>
__global__ void __launch_bounds__(kThreads, Ring3::kBlocks)
    conv3_kernel(Conv3I8 src, const void* x, const float* a3,
                 const float* b3, float sx, float sout, void* out, int out_i8,
                 int c, int m, int ktiles, int tiles,
                 const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap wmap) {
  constexpr int S = Ring3::kStages;
  __shared__ alignas(8) uint64_t bars[S];
  src.ymap = &ymap;
  src.wmap = &wmap;
  if (threadIdx.x == 0) {
    tma_prefetch(&ymap);
    tma_prefetch(&wmap);
  }
  uint8_t* sm = aligned_smem();
  uint32_t* stg = reinterpret_cast<uint32_t*>(sm + S * kStage8 +
                                              (threadIdx.x >> 5) * kStg3Bytes);
  const int mine = my_tiles(tiles);
  Mainloop<kBN8, S, 0, Conv3I8> ml(sm, bars, src, mine, ktiles);
  int acc[kBN8 / 2];
  for (int i = 0; i < mine; ++i) {
    zero(acc);
    ml.k_loop([&](const uint8_t* st, int) {
                mma_issue_s8(st, st + kATile, acc);
              },
              [&] { mma_wait<0>(acc); });
    const int tg = tile_of(i);
    conv3_epilogue<kResI8>(stg, acc, x, a3, b3, sx, sout, out, out_i8, c, m,
                           (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16,
                           (tg % src.ntn) * kBN8);
  }
  ml.finish();
}

// K14a's conv3: out = relu((f32(y2q @ w3q) * a3 + b3) + (f32(xq[2oh, 2ow]
// @ wpq) * ap + bp)), the two products in two int32 accumulators.
__global__ void __launch_bounds__(kThreads, RingP::kBlocks)
    pair_kernel(PairI8 src, const float* a3, const float* b3,
                const float* ap, const float* bp, float sout, void* out,
                int out_i8, int cout, int tiles,
                const __grid_constant__ CUtensorMap ymap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap pmap) {
  __shared__ alignas(8) uint64_t bars[RingP::kStages];
  src.ymap = &ymap;
  src.wmap = &wmap;
  src.pmap = &pmap;
  if (threadIdx.x == 0) {
    tma_prefetch(&ymap);
    tma_prefetch(&wmap);
    tma_prefetch(&pmap);
  }
  uint8_t* sm = aligned_smem();
  uint8_t* stg = sm + RingP::kStages * kStage8 + (threadIdx.x >> 5) * 1024;
  const int mine = my_tiles(tiles);
  Mainloop<kBN8, RingP::kStages, 0, PairI8> ml(
      sm, bars, src, mine, src.k3 + src.c / kIBK);
  const int q = threadIdx.x & 3;
  int acc[kBN8 / 2], acc2[kBN8 / 2];
  for (int i = 0; i < mine; ++i) {
    zero(acc);
    zero(acc2);
    ml.k_loop(
        [&](const uint8_t* st, int kt) {
          if (kt < src.k3)
            mma_issue_s8(st, st + kATile, acc);
          else
            mma_issue_s8(st, st + kATile, acc2);
        },
        [&] {
          mma_wait<0>(acc);
          fence_acc(acc2);
        });
    const int tg = tile_of(i);
    const int n0 = (tg % src.ntn) * kBN8;
    // the output into acc2's registers (float bits)
#pragma unroll
    for (int j = 0; j < kBN8 / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      const float2 s3 = ldg2(a3 + col), c3 = ldg2(b3 + col);
      const float2 sp = ldg2(ap + col), cp = ldg2(bp + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float y3 = __fadd_rn(__fmul_rn(i2f(acc[4 * j + e]),
                                             odd ? s3.y : s3.x),
                                   odd ? c3.y : c3.x);
        const float r = __fadd_rn(__fmul_rn(i2f(acc2[4 * j + e]),
                                            odd ? sp.y : sp.x),
                                  odd ? cp.y : cp.x);
        acc2[4 * j + e] = __float_as_int(fmaxf(__fadd_rn(y3, r), 0.0f));
      }
    }
    store_rows<int>(
        stg, acc2,
        [](int, const int (&v)[4], float (&y)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = __int_as_float(v[e]);
        },
        out, out_i8, sout, cout,
        (tg / src.ntn) * kBM + (threadIdx.x >> 5) * 16, src.m, n0);
  }
  ml.finish();
}

struct Params {
  const void* x;         // [m, c] int8 or bf16
  int8_t* xq;            // [m, c]: x (int8), or its quantization (scratch)
  const int8_t* w1t;     // [f, c]
  const int8_t* w2t;     // [3, f, 3f]: row tap, out channel, (dc, c)
  const int8_t* w3t;     // [cout, f]
  const int8_t* wpt;     // [cout, c] (K14a) or null
  const float *a1, *b1;  // [f]
  const float *a2, *b2;  // [3f] (row tap major), [f]
  const float *a3, *b3;  // [cout]
  const float *ap, *bp;  // [cout] (K14a) or null
  int8_t* y1q;           // [m, f] scratch
  int8_t* y2q;           // [m2, f] scratch
  void* out;             // [m2, cout] int8 or bf16
  float sx, sz, sy2, sout;
  int m, h, w, c, f, t, fold, x_i8, out_i8;
  int ho, wo, m2, cout, stride;  // conv2's stride and output (K9: 1, h, w)
};

// A persistent grid of kernel K over `tiles` at smem bytes a block.
template <auto K>
cudaError_t grid_of(int smem, int tiles, int* grid) {
  int held = 0;
  const cudaError_t e = resident<K>(smem, &held);
  *grid = std::max(1, std::min(tiles, held));
  return e;
}

int launch_quantize(const Params& p, cudaStream_t st) {
  const size_t n = static_cast<size_t>(p.m) * p.c;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t blocks = std::min<size_t>((n / 16 + 255) / 256, 8 * sms);
  quantize_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const bf16*>(p.x), p.xq, n, p.sx);
  return static_cast<int>(cudaGetLastError());
}

int launch_conv1(const Params& p, cudaStream_t st) {
  ShiftI8 src{};
  src.x = p.xq;
  src.m = p.m;
  src.c = p.c;
  src.f = p.f;
  src.plane = p.h * p.w;
  src.t = p.t;
  src.fold = p.fold;
  src.ntn = p.f / kBN8;
  CUtensorMap xmap{}, wmap{};
  cudaError_t e = tensor_map_2d(&xmap, p.xq, p.m, p.c, 1, kBM);
  if (e == cudaSuccess) e = tensor_map_2d(&wmap, p.w1t, p.f, p.c, 1, kBN8);
  constexpr int smem = ring_smem<ShiftI8, Ring1::kStages>();
  const int tiles = (p.m + kBM - 1) / kBM * src.ntn;
  int grid = 0;
  if (e == cudaSuccess) e = grid_of<conv1_kernel>(smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv1_kernel<<<grid, kThreads, smem, st>>>(src, p.a1, p.b1, p.sz, p.y1q,
                                             tiles, xmap, wmap);
  return static_cast<int>(cudaGetLastError());
}

int launch_conv2(const Params& p, cudaStream_t st) {
  Tap3I8 src{};
  src.y = p.y1q;
  src.m = p.m2;
  src.f = p.f;
  src.h = p.h;
  src.w = p.w;
  src.ho = p.ho;
  src.wo = p.wo;
  src.stride = p.stride;
  src.ntn = p.f / kBN8;
  src.cpt = p.f / kIBK;
  src.spt = 3 * src.cpt;
  src.lt = -1;
  src.xt = -1;
  CUtensorMap ymap{}, wmap{};
  cudaError_t e = cudaSuccess;
  if (p.stride == 1) e = tensor_map_2d(&ymap, p.y1q, p.m, p.f, 1, kBM);
  if (e == cudaSuccess)
    e = tensor_map_2d(&wmap, p.w2t, 3 * p.f, 3 * p.f, 1, kBN8);
  constexpr int smem = ring_smem<Tap3I8, Ring2::kStages>();
  const int tiles = (p.m2 + kBM - 1) / kBM * src.ntn;
  int grid = 0;
  if (e == cudaSuccess) e = grid_of<conv2_kernel>(smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv2_kernel<<<grid, kThreads, smem, st>>>(src, p.a2, p.b2, p.sy2, p.y2q,
                                             tiles, ymap, wmap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kResI8>
int launch_conv3(const Params& p, cudaStream_t st) {
  Conv3I8 src{};
  src.ntn = p.c / kBN8;
  CUtensorMap ymap{}, wmap{};
  cudaError_t e = tensor_map_2d(&ymap, p.y2q, p.m, p.f, 1, kBM);
  if (e == cudaSuccess) e = tensor_map_2d(&wmap, p.w3t, p.c, p.f, 1, kBN8);
  constexpr int smem =
      Ring3::kStages * kStage8 + 8 * kStg3Bytes + kAlignSlack;
  const int tiles = (p.m + kBM - 1) / kBM * src.ntn;
  int grid = 0;
  if (e == cudaSuccess) e = grid_of<conv3_kernel<kResI8>>(smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  conv3_kernel<kResI8><<<grid, kThreads, smem, st>>>(
      src, p.x, p.a3, p.b3, p.sx, p.sout, p.out, p.out_i8, p.c, p.m,
      p.f / kIBK, tiles, ymap, wmap);
  return static_cast<int>(cudaGetLastError());
}

int launch_pair(const Params& p, cudaStream_t st) {
  PairI8 src{};
  src.x = p.xq;
  src.m = p.m2;
  src.c = p.c;
  src.h = p.h;
  src.w = p.w;
  src.ho = p.ho;
  src.wo = p.wo;
  src.ntn = p.cout / kBN8;
  src.k3 = p.f / kIBK;
  src.lt = -1;
  CUtensorMap ymap{}, wmap{}, pmap{};
  cudaError_t e = tensor_map_2d(&ymap, p.y2q, p.m2, p.f, 1, kBM);
  if (e == cudaSuccess) e = tensor_map_2d(&wmap, p.w3t, p.cout, p.f, 1, kBN8);
  if (e == cudaSuccess) e = tensor_map_2d(&pmap, p.wpt, p.cout, p.c, 1, kBN8);
  constexpr int smem = ring_smem<PairI8, RingP::kStages>();
  const int tiles = (p.m2 + kBM - 1) / kBM * src.ntn;
  int grid = 0;
  if (e == cudaSuccess) e = grid_of<pair_kernel>(smem, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  pair_kernel<<<grid, kThreads, smem, st>>>(
      src, p.a3, p.b3, p.ap, p.bp, p.sout, p.out, p.out_i8, p.cout, tiles,
      ymap, wmap, pmap);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* x, void* xq, const void* w1t, const void* w2t,
                   const void* w3t, const void* a1, const void* b1,
                   const void* a2, const void* b2, const void* a3,
                   const void* b3, void* y1q, void* y2q, void* out, float sx,
                   float sz, float sy2, float sout, int nt, int h, int w,
                   int c, int f, int t, int fold, int x_i8, int out_i8) {
  Params p;
  p.x = x;
  p.xq = static_cast<int8_t*>(x_i8 ? const_cast<void*>(x) : xq);
  p.w1t = static_cast<const int8_t*>(w1t);
  p.w2t = static_cast<const int8_t*>(w2t);
  p.w3t = static_cast<const int8_t*>(w3t);
  p.wpt = nullptr;
  p.a1 = static_cast<const float*>(a1); p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2); p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3); p.b3 = static_cast<const float*>(b3);
  p.ap = p.bp = nullptr;
  p.y1q = static_cast<int8_t*>(y1q);
  p.y2q = static_cast<int8_t*>(y2q);
  p.out = out;
  p.sx = sx; p.sz = sz; p.sy2 = sy2; p.sout = sout;
  p.m = nt * h * w; p.h = h; p.w = w; p.c = c; p.f = f; p.t = t;
  p.fold = fold; p.x_i8 = x_i8; p.out_i8 = out_i8;
  p.ho = h; p.wo = w; p.m2 = p.m; p.cout = c; p.stride = 1;
  return p;
}

// [bf16 x: its quantization,] conv1 and conv2 (both blocks), then the
// block's conv3: K9's with the identity residual, or K14a's with the
// projection (proj).
int run(const Params& p, bool proj, cudaStream_t st) {
  int rc = p.x_i8 ? 0 : launch_quantize(p, st);
  if (rc == 0) rc = launch_conv1(p, st);
  if (rc == 0) rc = launch_conv2(p, st);
  if (rc != 0) return rc;
  if (proj) return launch_pair(p, st);
  return p.x_i8 ? launch_conv3<true>(p, st) : launch_conv3<false>(p, st);
}

}  // namespace
}  // namespace vcg

// K9. x [n*t, h, w, c] int8 (x_i8) or bf16; xq [n*t*h*w, c] int8 scratch
// for bf16 x (null for int8 x); w1t [f, c], w2t [3, f, 3f], w3t [c, f]
// int8 (transposed: K contiguous); a1/b1 [f], a2 [3f], b2 [f], a3/b3 [c]
// f32 (8-byte aligned); y1q, y2q [n*t*h*w, f] int8 scratch; out [n*t, h,
// w, c] int8 (out_i8) or bf16; every pointer 16-byte aligned. Needs
// c % 128 == 0, f % 128 == 0, fold % 16 == 0; the caller checks.
extern "C" int vcg_tsm_bottleneck_int8(
    const void* x, void* xq, const void* w1t, const void* w2t,
    const void* w3t, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* a3, const void* b3, void* y1q, void* y2q,
    void* out, float sx, float sz, float sy2, float sout, int nt, int h,
    int w, int c, int f, int t, int fold, int x_i8, int out_i8,
    void* stream) {
  const vcg::Params p = vcg::make_params(
      x, xq, w1t, w2t, w3t, a1, b1, a2, b2, a3, b3, y1q, y2q, out, sx, sz,
      sy2, sout, nt, h, w, c, f, t, fold, x_i8, out_i8);
  return vcg::run(p, false, static_cast<cudaStream_t>(stream));
}

// K14a. x [n*t, h, w, c] int8 (x_i8) or bf16, h and w even; xq as for K9;
// w1t [f, c], w2t [3, f, 3f], w3t [cout, f], wpt [cout, c] int8; a1/b1
// [f], a2 [3f], b2 [f], a3/b3/ap/bp [cout] f32; y1q [n*t*h*w, f] and y2q
// [n*t*(h/2)*(w/2), f] int8 scratch; out [n*t, h/2, w/2, cout] int8
// (out_i8) or bf16. Needs c, f and cout % 128 == 0, fold % 16 == 0.
extern "C" int vcg_tsm_bottleneck_s2_int8(
    const void* x, void* xq, const void* w1t, const void* w2t,
    const void* w3t, const void* wpt, const void* a1, const void* b1,
    const void* a2, const void* b2, const void* a3, const void* b3,
    const void* ap, const void* bp, void* y1q, void* y2q, void* out,
    float sx, float sz, float sy2, float sout, int nt, int h, int w, int c,
    int f, int cout, int t, int fold, int x_i8, int out_i8, void* stream) {
  vcg::Params p = vcg::make_params(
      x, xq, w1t, w2t, w3t, a1, b1, a2, b2, a3, b3, y1q, y2q, out, sx, sz,
      sy2, sout, nt, h, w, c, f, t, fold, x_i8, out_i8);
  p.wpt = static_cast<const int8_t*>(wpt);
  p.ap = static_cast<const float*>(ap);
  p.bp = static_cast<const float*>(bp);
  p.ho = h / 2; p.wo = w / 2; p.m2 = nt * p.ho * p.wo;
  p.cout = cout; p.stride = 2;
  return vcg::run(p, true, static_cast<cudaStream_t>(stream));
}
