// ResNet stems for Hopper (sm_90a).
//
// vcg_stem_s2d replaces video_chapter_generation_tpu/ops/stem_pallas.py:
// stem_s2d_pallas (_stem_kernel, K1): ImageNet normalize -> 7x7/2 conv (pad
// 3) -> folded BN -> ReLU -> 3x3/2 max pool (pad 1), [N, H/4, W/4, 48] u8 ->
// [N, H/4, W/4, 64]. The s2d channel order is (dy, dx, c): pixel
// (4I + dy, 4J + dx, c) sits in cell (I, J) at channel dy * 12 + dx * 3 + c.
// vcg_stem_frames replaces stem_pallas.py:stem_conv_bn_pool_pallas (K8),
// which is the s2d reshape followed by the same kernel: the same stem on
// normalized bf16 NHWC frames, whose 4x4 cells it reads in place.
//
// Both are one launch of stem_kernel<kU8, false> (stem_tiles.cuh, which
// describes it): the TPU kernel's phase packing on hopper_gemm.cuh's wgmma
// mainloop over strips of 2 cell rows, with the max pool in the epilogue.
// No [N, 2h, 2w, 64] conv output reaches device memory.
//
// What bounds it on the H100: the products, 2 x 448 x 256 flops a cell
// (184 GFLOP, 0.19 ms at 989 TFLOP/s for 256 frames at 224 px, the phase
// packing's zeros included); the bytes are 38.5 MB of u8 cells (77 MB of
// bf16 frames) in and 103 MB out, and W from L2 once a tile.
//
// vcg_stem_s2d_int8 replaces stem_pallas.py:stem_s2d_int8_pallas
// (_stem_kernel_i8, K14b): the weight-only int8 stem on the same raw u8
// pack. Per s2d cell (I, J) it computes the 4 conv-output phases
// (2I + pr, 2J + pc) at once as one int8 [M, 448] x [448, 256] product
// (the [432, 256] phase-packed im2col weight of the bf16 TPU kernel, its
// K zero-padded to a multiple of 64): A is x - 128, an exact int8, over
// the 3x3 cell neighbourhood (zero outside the frame), W the per-output-
// channel int8 weight with the normalize scale folded in, and the sums
// int32 (mma.sync s8, int8_gemm.cuh). The epilogue adds back what x - 128
// and the zero padding leave out: per valid tap t a row wb[t] (the tap's
// normalize-bias and +128 share, BN-scaled), summed in tap order after a
// start at 0, then the BN bias row wb[9]; y = relu(f32(acc) * sv + bias),
// each product and sum rounded on its own, as the plain version
// ops/stem.py:stem_s2d_int8_plain does. It stores y as bf16 into the
// conv-output layout [N, 2h, 2w, 64], and the pool kernel below
// (identity affine) takes the 3x3/2 max: y >= 0, so the pool's -inf
// padding picks what the TPU kernel's phase max pool with 0 padding picks.
// Bound on the H100: the int8 products; the bias epilogue is nine
// predicated adds per output.
//
// vcg_bn_relu_maxpool replaces stem_pallas.py:bn_relu_maxpool_pallas (the
// K8 pool row): folded BN + ReLU, rounded to bf16, then the 3x3/2 max pool
// on any [N, H, W, C] with C % 8 == 0, 16 bytes a thread; bound by bytes
// (it reads its input once and writes a quarter). K14b's second launch.
#include "int8_gemm.cuh"
#include "stem_tiles.cuh"

namespace vcg {

// relu(x * scale + bias) rounded to bf16, then the 3x3/2 max pool (pad 1)
// over [n, h, w, c]; one thread per 8-channel chunk of one output pixel.
// Padding never wins (-inf); every window holds a real pixel.
__global__ void bn_relu_maxpool_kernel(const bf16* x, const float* scale,
                                       const float* bias, bf16* out, int n,
                                       int h, int w, int c, int hp, int wp) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int chunks = c / 8;
  const size_t total = static_cast<size_t>(n) * hp * wp * chunks;
  if (idx >= total) return;
  const int cc = idx % chunks;
  const size_t pix = idx / chunks;
  const int q = pix % wp;
  const int p = (pix / wp) % hp;
  const int nn = pix / (static_cast<size_t>(wp) * hp);
  float s[8], b[8], best[8];
  for (int e = 0; e < 8; ++e) {
    s[e] = scale[cc * 8 + e];
    b[e] = bias[cc * 8 + e];
    best[e] = -INFINITY;
  }
  for (int dr = 0; dr < 3; ++dr) {
    const int r = 2 * p - 1 + dr;
    if (r < 0 || r >= h) continue;
    for (int dc = 0; dc < 3; ++dc) {
      const int col = 2 * q - 1 + dc;
      if (col < 0 || col >= w) continue;
      alignas(16) bf16 v[8];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(nn) * h + r) * w + col) * c + cc * 8);
      for (int e = 0; e < 8; ++e) {
        // two roundings, no FMA, then bf16: the plain version's float ops
        const float a = fmaxf(
            __fadd_rn(__fmul_rn(__bfloat162float(v[e]), s[e]), b[e]), 0.0f);
        best[e] = fmaxf(best[e], __bfloat162float(__float2bfloat16_rn(a)));
      }
    }
  }
  alignas(16) bf16 o[8];
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(best[e]);
  *reinterpret_cast<uint4*>(out + pix * c + cc * 8) =
      *reinterpret_cast<const uint4*>(o);
}

// bn_relu_maxpool_kernel over [n, h, w, c].
static int bn_relu_maxpool(const bf16* x, const float* scale,
                           const float* bias, bf16* out, int n, int h, int w,
                           int c, cudaStream_t st) {
  const int hp = (h - 1) / 2 + 1, wp = (w - 1) / 2 + 1;
  const size_t total = static_cast<size_t>(n) * hp * wp * (c / 8);
  bn_relu_maxpool_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                           0, st>>>(x, scale, bias, out, n, h, w, c, hp, wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vcg

namespace vcg8 {

constexpr int kStemI8K = 432;     // 9 cells x 48 channels
constexpr int kStemI8KPad = 448;  // multiple of kBK; W columns 432.. are zero

// A of the int8 stem: row = s2d cell (n, I, J), k = (tap_r, tap_c, ch48)
// over the 3x3 cell neighbourhood; 16 consecutive k are 16 channels of one
// cell, loaded as one 16-byte word and shifted to x - 128 (u ^ 0x80 is
// u - 128 as a two's-complement byte). Zero outside the frame and for
// k >= 432.
struct StemI8A {
  const uint8_t* s4;
  int hs, ws;
  int n_[2], i_[2], j_[2];
  Rows rows;

  __device__ void init(const uint8_t* p, int hs_, int ws_, int m0, int m) {
    s4 = p; hs = hs_; ws = ws_;
    rows.init(m0, m);
    for (int i = 0; i < 2; ++i) {
      const int q = rows.pix[i];
      n_[i] = q / (hs * ws);
      const int rem = q - n_[i] * hs * ws;
      i_[i] = rem / ws;
      j_[i] = rem - i_[i] * ws;
    }
  }

  __device__ void load(int8_t* as, int k0) const {
    const int k = k0 + rows.kc * 16;
    const int tap = k / 48, ch = k - 48 * tap;
    const int tr = tap / 3, tc = tap - 3 * (tap / 3);
    for (int i = 0; i < 2; ++i) {
      const int ci = i_[i] - 1 + tr, cj = j_[i] - 1 + tc;
      const bool ok = rows.ok[i] && k < kStemI8K && ci >= 0 && ci < hs &&
                      cj >= 0 && cj < ws;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (ok) {
        v = *reinterpret_cast<const uint4*>(
            s4 + ((static_cast<size_t>(n_[i]) * hs + ci) * ws + cj) * 48 + ch);
        v.x ^= 0x80808080u; v.y ^= 0x80808080u;
        v.z ^= 0x80808080u; v.w ^= 0x80808080u;
      }
      *reinterpret_cast<uint4*>(as + rows.r[i] * kLd + rows.kc * 16) = v;
    }
  }
};

// The int8 stem conv: per cell and phase column n = (pr * 2 + pc) * 64 + f,
// y = relu(f32(acc) * sv[n] + bias) with bias the valid taps' wb rows and
// wb[9], stored bf16 at conv pixel (2I + pr, 2J + pc).
__global__ void __launch_bounds__(kThreads)
    stem_i8_conv_kernel(const uint8_t* s4, const int8_t* wt, const float* sv,
                        const float* wb, bf16* conv, int n, int hs, int ws) {
  const int m = n * hs * ws;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  __shared__ Smem sm;
  StemI8A al;
  al.init(s4, hs, ws, m0, m);
  int acc[kFM][kFN][4];
  zero(acc);
  gemm_tile(sm, al, wt, kStemI8KPad, n0, acc);
  each_element(m0, n0, [&](int row, int col, int i, int j, int e) {
    if (row >= m) return;
    const int nn = row / (hs * ws);
    const int rem = row - nn * hs * ws;
    const int ci = rem / ws, cj = rem - (rem / ws) * ws;
    float bias = 0.0f;
    for (int t = 0; t < 9; ++t) {
      const int r = ci - 1 + t / 3, c = cj - 1 + t % 3;
      if (r >= 0 && r < hs && c >= 0 && c < ws)
        bias = __fadd_rn(bias, wb[t * 256 + col]);
    }
    bias = __fadd_rn(bias, wb[9 * 256 + col]);
    const float y = fmaxf(
        __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), sv[col]), bias),
        0.0f);
    const int ph = col >> 6, f = col & 63;
    const int oh = 2 * ci + (ph >> 1), ow = 2 * cj + (ph & 1);
    conv[((static_cast<size_t>(nn) * 2 * hs + oh) * 2 * ws + ow) * 64 + f] =
        __float2bfloat16_rn(y);
  });
}

}  // namespace vcg8

// K1. s4 [n, hs, ws, 48] u8 (16-byte aligned); w [448, 256] bf16 the
// phase-packed weight (ops/stem.py:stem_weight_im2col, rows 432.. zero);
// scale/bias [64] f32 the folded BN; norm [6] f32 = ImageNet (a[3], b[3])
// with x = u8 * a + b; out [n, hs, ws, 64] bf16; bands a frame in
// 1 .. (hs + 1) / 2; ws <= 64.
extern "C" int vcg_stem_s2d(const void* s4, const void* w, const void* scale,
                            const void* bias, const void* norm, void* out,
                            int n, int hs, int ws, int bands, void* stream) {
  const vcg::StemArgs a{s4, static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<const float*>(norm),
                        static_cast<vcg::bf16*>(out), nullptr, n, hs, ws,
                        bands};
  return vcg::launch_stem<true, false>(a, w,
                                       static_cast<cudaStream_t>(stream));
}

// K8. x [n, 4 hs, 4 ws, 3] bf16 normalized frames (8-byte aligned); w, scale,
// bias, out, bands as for vcg_stem_s2d.
extern "C" int vcg_stem_frames(const void* x, const void* w,
                               const void* scale, const void* bias, void* out,
                               int n, int hs, int ws, int bands,
                               void* stream) {
  const vcg::StemArgs a{x, static_cast<const float*>(scale),
                        static_cast<const float*>(bias), nullptr,
                        static_cast<vcg::bf16*>(out), nullptr, n, hs, ws,
                        bands};
  return vcg::launch_stem<false, false>(a, w,
                                        static_cast<cudaStream_t>(stream));
}

// x [n, h, w, c] bf16 (c % 8 == 0); scale/bias [c] f32;
// out [n, (h-1)/2+1, (w-1)/2+1, c] bf16.
extern "C" int vcg_bn_relu_maxpool(const void* x, const void* scale,
                                   const void* bias, void* out, int n, int h,
                                   int w, int c, void* stream) {
  return vcg::bn_relu_maxpool(
      static_cast<const vcg::bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<vcg::bf16*>(out), n, h, w,
      c, static_cast<cudaStream_t>(stream));
}

// s4 [n, hs, ws, 48] u8; wt [256, 448] int8 (the phase-packed im2col
// weight with the normalize scale folded in, quantized per output column,
// transposed and zero-padded); sv [256] f32 (weight scale x BN scale);
// wb [10, 256] f32 (rows 0-8: each tap's bias share, row 9: the BN bias);
// one/zero [64] f32 (ones, zeros); conv [n, 2hs, 2ws, 64] bf16 scratch;
// out [n, hs, ws, 64] bf16.
extern "C" int vcg_stem_s2d_int8(const void* s4, const void* wt,
                                 const void* sv, const void* wb,
                                 const void* one, const void* zero,
                                 void* conv, void* out, int n, int hs, int ws,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n * hs * ws;
  vcg8::stem_i8_conv_kernel<<<dim3((m + vcg8::kBM - 1) / vcg8::kBM,
                                   256 / vcg8::kBN),
                              vcg8::kThreads, 0, st>>>(
      static_cast<const uint8_t*>(s4), static_cast<const int8_t*>(wt),
      static_cast<const float*>(sv), static_cast<const float*>(wb),
      static_cast<vcg::bf16*>(conv), n, hs, ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return vcg::bn_relu_maxpool(
      static_cast<const vcg::bf16*>(conv), static_cast<const float*>(one),
      static_cast<const float*>(zero), static_cast<vcg::bf16*>(out), n,
      2 * hs, 2 * ws, 64, st);
}
