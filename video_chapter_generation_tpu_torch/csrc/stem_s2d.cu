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
// Both are one launch of stem_kernel<kU8, false, kWide> (stem_tiles.cuh,
// which describes it): the TPU kernel's phase packing on hopper_gemm.cuh's
// wgmma mainloop over strips of 2 cell rows (a wide frame in column
// chunks), with the max pool in the epilogue. No [N, 2h, 2w, 64] conv
// output reaches device memory.
//
// What bounds it on the H100: the products, 2 x 448 x 256 flops a cell
// (184 GFLOP, 0.19 ms at 989 TFLOP/s for 256 frames at 224 px, the phase
// packing's zeros included); the bytes are 38.5 MB of u8 cells (77 MB of
// bf16 frames) in and 103 MB out, and W from L2 once a tile.
//
// vcg_stem_s2d_int8 replaces stem_pallas.py:stem_s2d_int8_pallas
// (_stem_kernel_i8, K14b): the weight-only int8 stem on the same raw u8
// pack, one launch of stem_i8_kernel (stem_tiles.cuh) on the same strip
// walk: per s2d cell the 4 conv-output phases at once as one s8 [cells,
// 448] x [448, 256] product (A = x - 128, an exact int8, over the 3x3
// cell neighbourhood, zero outside the frame; W = the phase-packed im2col
// weight with the normalize scale folded in, quantized per output
// column), its weight resident in shared memory; then per phase y =
// relu(f32(acc) * sv + bias), each product and sum rounded on its own,
// with bias the valid taps' wb rows (each tap's normalize-bias and +128
// share, BN-scaled) summed in tap order from 0, then the BN bias row
// wb[9], as ops/stem.py:stem_s2d_int8_plain does; then the 3x3/2 max
// pool of the bf16 y in the epilogue. Bound on the H100 for 256 frames at
// 224 px: its bytes (38.5 MB in, 103 MB out: 0.042 ms) above the stem's
// own int8 operations (0.030 ms at 1,979 TOP/s; 0.093 ms with the phase
// packing's zeros); what paces it is the epilogue (256 affines a lane a
// strip), which does not overlap the products.
//
// vcg_bn_relu_maxpool replaces stem_pallas.py:bn_relu_maxpool_pallas (the
// K8 pool row): folded BN + ReLU, rounded to bf16, then the 3x3/2 max pool
// on any [N, H, W, C] with C % 8 == 0, 16 bytes a thread; bound by bytes
// (it reads its input once and writes a quarter).
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

// K1. s4 [n, hs, ws, 48] u8 (16-byte aligned); w [448, 256] bf16 the
// phase-packed weight (ops/stem.py:stem_weight_im2col, rows 432.. zero);
// scale/bias [64] f32 the folded BN; norm [6] f32 = ImageNet (a[3], b[3])
// with x = u8 * a + b; out [n, hs, ws, 64] bf16; bands a column chunk
// (stem_chunks(ws) chunks a frame row) in 1 .. (hs + 1) / 2.
extern "C" int vcg_stem_s2d(const void* s4, const void* w, const void* scale,
                            const void* bias, const void* norm, void* out,
                            int n, int hs, int ws, int bands,
                            void* stream) {
  const vcg::StemArgs a{s4, static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<const float*>(norm),
                        static_cast<vcg::bf16*>(out), nullptr, n, hs, ws,
                        vcg::stem_chunks(ws), bands};
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
                        vcg::stem_chunks(ws), bands};
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

// K14b. s4 [n, hs, ws, 48] u8 (16-byte aligned); wt [256, 512] s8 (the
// phase-packed im2col weight with the normalize scale folded in, quantized
// per output column, transposed, k zero from 432); sv [256] f32 (weight
// scale x BN scale); wb [10, 256] f32 (rows 0-8: each tap's bias share,
// row 9: the BN bias); out [n, hs, ws, 64] bf16; bands as for
// vcg_stem_s2d.
extern "C" int vcg_stem_s2d_int8(const void* s4, const void* wt,
                                 const void* sv, const void* wb, void* out,
                                 int n, int hs, int ws, int bands,
                                 void* stream) {
  const vcg::StemArgs a{s4, static_cast<const float*>(sv),
                        static_cast<const float*>(wb), nullptr,
                        static_cast<vcg::bf16*>(out), nullptr, n, hs, ws,
                        vcg::stem_chunks(ws), bands};
  return vcg::launch_stem_i8(a, wt, static_cast<cudaStream_t>(stream));
}
