// ResNet stems for Hopper (sm_90a).
//
// vcg_stem_s2d replaces video_chapter_generation_tpu/ops/stem_pallas.py:
// stem_s2d_pallas (_stem_kernel): ImageNet normalize -> 7x7/2 conv (pad 3)
// -> folded BN -> ReLU -> 3x3/2 max pool (pad 1), [N, H/4, W/4, 48] u8 ->
// [N, H/4, W/4, 64]. The s2d channel order is (dy, dx, c): pixel
// (4I + dy, 4J + dx, c) sits in cell (I, J) at channel dy * 12 + dx * 3 + c.
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
// conv-output layout [N, 2h, 2w, 64], and the one pool kernel below
// (identity affine) takes the 3x3/2 max: y >= 0, so the pool's -inf
// padding picks what the TPU kernel's phase max pool with 0 padding picks.
// Bound on the H100: the int8 products; the bias epilogue is nine
// predicated adds per output.
//
// vcg_stem_frames_conv and vcg_bn_relu_maxpool replace stem_pallas.py:
// stem_conv_bn_pool_pallas and bn_relu_maxpool_pallas (kernel K8): the
// same stem on normalized bf16 NHWC frames.
//
// Both stems are two launches. Launch 1 is the 7x7/2 conv alone: no
// affine, the conv output rounded to bf16 once, as the plain version's
// convolution rounds it. Launch 2 (bn_relu_maxpool_kernel, the one pool
// kernel) applies the folded BN and the ReLU as it loads each value,
// rounds to bf16 and takes the 3x3/2 max; it serves any [N, H, W, C] with
// C % 8 == 0, 16 bytes a thread.
//
// What bounds it on the H100: the gather, not the product. K = 7*7*3 = 147
// is shallow (padded to 160 for the tensor cores), and every A element is a
// scattered read (for s2d: a byte, a normalize and a bf16 convert). Launch
// 1 gathers each A tile straight from the input into shared memory (no
// im2col or normalized frame in device memory; normalization happens
// before the zero padding, as in the reference) and runs the implicit GEMM
// of conv_gemm.cuh. The pool is bound by bytes: it reads the conv output
// once and writes a quarter. Fusing the pool into launch 1 (with a
// one-pixel halo) is left for later.
#include <math.h>

#include "conv_gemm.cuh"
#include "int8_gemm.cuh"

namespace vcg {

constexpr int kStemK = 147;     // 7 * 7 * 3
constexpr int kStemKPad = 160;  // multiple of kBK; weight rows 147.. are zero

// Thread i fills 16 consecutive k of A-tile row i / 2.
struct StemA {
  const uint8_t* s4;
  int hs, ws, hc, wc;
  float a0, a1, a2, b0, b1, b2;
  int n, oh, ow, row, kh16;
  bool ok;

  __device__ void init(const uint8_t* p, const float* norm, int hs_, int ws_,
                       int m0, int m) {
    s4 = p; hs = hs_; ws = ws_; hc = 2 * hs_; wc = 2 * ws_;
    a0 = norm[0]; a1 = norm[1]; a2 = norm[2];
    b0 = norm[3]; b1 = norm[4]; b2 = norm[5];
    row = threadIdx.x >> 1;
    kh16 = (threadIdx.x & 1) * 16;
    const int mm = m0 + row;
    ok = mm < m;
    const int q = ok ? mm : 0;
    n = q / (hc * wc);
    const int rem = q - n * hc * wc;
    oh = rem / wc;
    ow = rem - oh * wc;
  }

  __device__ void load(bf16* as, int k0) const {
    alignas(16) bf16 v[16];
    for (int e = 0; e < 16; ++e) {
      const int k = k0 + kh16 + e;
      float val = 0.0f;
      if (ok && k < kStemK) {
        const int tap = k / 3;
        const int c = k - 3 * tap;
        const int kh = tap / 7;
        const int kw = tap - 7 * kh;
        const int ih = 2 * oh - 3 + kh;
        const int iw = 2 * ow - 3 + kw;
        if (ih >= 0 && ih < 4 * hs && iw >= 0 && iw < 4 * ws) {
          const uint8_t u =
              s4[((static_cast<size_t>(n) * hs + (ih >> 2)) * ws + (iw >> 2)) *
                     48 +
                 (ih & 3) * 12 + (iw & 3) * 3 + c];
          const float a = c == 0 ? a0 : (c == 1 ? a1 : a2);
          const float b = c == 0 ? b0 : (c == 1 ? b1 : b2);
          // two roundings, no FMA: the same float ops as the reference
          val = __fadd_rn(__fmul_rn(static_cast<float>(u), a), b);
        }
      }
      v[e] = __float2bfloat16_rn(val);
    }
    uint4* dst = reinterpret_cast<uint4*>(as + row * kALd + kh16);
    dst[0] = reinterpret_cast<const uint4*>(v)[0];
    dst[1] = reinterpret_cast<const uint4*>(v)[1];
  }
};

// Thread i fills 16 consecutive k of A-tile row i / 2 from bf16 NHWC
// frames [n, h, w, 3]; taps outside the frame are zero (the conv's pad).
struct FramesA {
  const bf16* x;
  int h, w, hc, wc;
  int n, oh, ow, row, kh16;
  bool ok;

  __device__ void init(const bf16* p, int h_, int w_, int m0, int m) {
    x = p; h = h_; w = w_; hc = (h_ - 1) / 2 + 1; wc = (w_ - 1) / 2 + 1;
    row = threadIdx.x >> 1;
    kh16 = (threadIdx.x & 1) * 16;
    const int mm = m0 + row;
    ok = mm < m;
    const int q = ok ? mm : 0;
    n = q / (hc * wc);
    const int rem = q - n * hc * wc;
    oh = rem / wc;
    ow = rem - oh * wc;
  }

  __device__ void load(bf16* as, int k0) const {
    alignas(16) bf16 v[16];
    for (int e = 0; e < 16; ++e) {
      const int k = k0 + kh16 + e;
      bf16 val = __float2bfloat16_rn(0.0f);
      if (ok && k < kStemK) {
        const int tap = k / 3;
        const int c = k - 3 * tap;
        const int kh = tap / 7;
        const int kw = tap - 7 * kh;
        const int ih = 2 * oh - 3 + kh;
        const int iw = 2 * ow - 3 + kw;
        if (ih >= 0 && ih < h && iw >= 0 && iw < w)
          val = x[((static_cast<size_t>(n) * h + ih) * w + iw) * 3 + c];
      }
      v[e] = val;
    }
    uint4* dst = reinterpret_cast<uint4*>(as + row * kALd + kh16);
    dst[0] = reinterpret_cast<const uint4*>(v)[0];
    dst[1] = reinterpret_cast<const uint4*>(v)[1];
  }
};

// The 7x7/2 conv over bf16 frames; one and zero make the shared epilogue
// the identity, so the output is the f32 sum rounded once to bf16.
__global__ void __launch_bounds__(kThreads)
    stem_frames_conv_kernel(const bf16* x, const bf16* w, const float* one,
                            const float* zero, bf16* conv, int n, int h,
                            int wd) {
  const int m = n * ((h - 1) / 2 + 1) * ((wd - 1) / 2 + 1);
  const int m0 = blockIdx.x * kBM;
  __shared__ Smem<64> sm;
  FramesA al;
  al.init(x, h, wd, m0, m);
  conv_gemm_tile<64>(sm, al, w, kStemKPad, 64, m0, 0, m, one, zero, conv,
                     false);
}

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

// The 7x7/2 conv over the s2d pack, normalized as it is gathered; one and
// zero make the epilogue the identity, as for the frames conv.
__global__ void __launch_bounds__(kThreads)
    stem_conv_kernel(const uint8_t* s4, const bf16* w, const float* one,
                     const float* zero, const float* norm, bf16* conv, int n,
                     int hs, int ws) {
  const int m = n * (2 * hs) * (2 * ws);
  const int m0 = blockIdx.x * kBM;
  __shared__ Smem<64> sm;
  StemA al;
  al.init(s4, norm, hs, ws, m0, m);
  conv_gemm_tile<64>(sm, al, w, kStemKPad, 64, m0, 0, m, one, zero, conv,
                     false);
}

// Launch 2 of both stems: bn_relu_maxpool_kernel over [n, h, w, c].
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

// s4 [n, hs, ws, 48] u8; w [160, 64] bf16 (HWIO [7,7,3,64] rows, zero
// padded); one/zero [64] f32 (ones, zeros); scale/bias [64] f32 the folded
// BN; norm [6] f32 = ImageNet (a[3], b[3]) with x = u8 * a + b; conv
// [n, 2hs, 2ws, 64] bf16 scratch; out [n, hs, ws, 64].
extern "C" int vcg_stem_s2d(const void* s4, const void* w, const void* one,
                            const void* zero, const void* scale,
                            const void* bias, const void* norm, void* conv,
                            void* out, int n, int hs, int ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = n * (2 * hs) * (2 * ws);
  vcg::stem_conv_kernel<<<(m + vcg::kBM - 1) / vcg::kBM, vcg::kThreads, 0,
                          st>>>(
      static_cast<const uint8_t*>(s4), static_cast<const vcg::bf16*>(w),
      static_cast<const float*>(one), static_cast<const float*>(zero),
      static_cast<const float*>(norm), static_cast<vcg::bf16*>(conv), n, hs,
      ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return vcg::bn_relu_maxpool(
      static_cast<const vcg::bf16*>(conv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<vcg::bf16*>(out), n,
      2 * hs, 2 * ws, 64, st);
}

// x [n, h, w, 3] bf16 normalized frames; w [160, 64] bf16 as above;
// one/zero [64] f32 (ones, zeros); conv [n, (h-1)/2+1, (w-1)/2+1, 64] bf16.
extern "C" int vcg_stem_frames_conv(const void* x, const void* w,
                                    const void* one, const void* zero,
                                    void* conv, int n, int h, int wd,
                                    void* stream) {
  const int m = n * ((h - 1) / 2 + 1) * ((wd - 1) / 2 + 1);
  vcg::stem_frames_conv_kernel<<<(m + vcg::kBM - 1) / vcg::kBM,
                                 vcg::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vcg::bf16*>(x), static_cast<const vcg::bf16*>(w),
      static_cast<const float*>(one), static_cast<const float*>(zero),
      static_cast<vcg::bf16*>(conv), n, h, wd);
  return static_cast<int>(cudaGetLastError());
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
