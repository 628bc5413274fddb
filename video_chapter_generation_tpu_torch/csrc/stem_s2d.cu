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
// on any [N, H, W, C] with C % 8 == 0 (odd H and W too). Bound by bytes:
// it reads its input once and writes a quarter (at [256, 112, 112, 64]
// 411 MB in and 103 MB out, 0.153 ms at 3.35 TB/s). bn_relu_maxpool_kernel
// streams them as the TPU kernel's separable form suggests: a lane walks
// an 8-channel chunk of one output column down a strip of output rows,
// loading each input row pair once with 16-byte loads (the next pair in
// flight while this one is pooled) and applying the affine, ReLU and bf16
// rounding once per element (again only for the strip's halo row and the
// column left of a warp's first), the left column from its neighbour lane
// by a shuffle and the row above carried as its 3-wide max; 16 bytes
// stored a lane.
#include "stem_tiles.cuh"

namespace vcg {

constexpr int kPStrip = 8;  // output rows a thread walks down
constexpr int kPThreads = 128;

// relu(x * s + b) of one 8-channel chunk, each product and sum rounded on
// its own (the plain version's float ops), rounded to bf16; -inf where
// the chunk lies outside the frame (padding never wins, and every window
// holds a real pixel)
__device__ __forceinline__ uint4 pool_affine(uint4 v, bool in,
                                             const float (&s)[8],
                                             const float (&b)[8]) {
  if (!in) return make_uint4(0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u,
                             0xFF80FF80u);  // bf16 -inf x 8
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = hop::unpack2(w[e]);
    y[e] = hop::pack2(
        fmaxf(__fadd_rn(__fmul_rn(f.x, s[2 * e]), b[2 * e]), 0.0f),
        fmaxf(__fadd_rn(__fmul_rn(f.y, s[2 * e + 1]), b[2 * e + 1]), 0.0f));
  }
  return make_uint4(y[0], y[1], y[2], y[3]);
}

// best = max(best, each of the chunk's 8 values), in order
__device__ __forceinline__ void pool_fold(float (&best)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = hop::unpack2(w[e]);
    best[2 * e] = fmaxf(best[2 * e], f.x);
    best[2 * e + 1] = fmaxf(best[2 * e + 1], f.y);
  }
}

__device__ __forceinline__ uint4 shfl_up4(uint4 v, int by) {
  return make_uint4(__shfl_up_sync(0xffffffffu, v.x, by),
                    __shfl_up_sync(0xffffffffu, v.y, by),
                    __shfl_up_sync(0xffffffffu, v.z, by),
                    __shfl_up_sync(0xffffffffu, v.w, by));
}

// relu(x * scale + bias) rounded to bf16, then the 3x3/2 max pool (pad 1)
// over [n, h, w, c] (see above). A lane takes one 8-channel chunk k of one
// output column q and walks kPStrip output rows p down it: per row it
// loads input rows 2p and 2p + 1 at columns 2q and 2q + 1 (the next
// row's loads in flight while this one is pooled) and transforms them;
// column 2q - 1 is the odd column of the lane cb to its left (a shuffle;
// the first column of a warp loads its own), and row 2p - 1 is the row
// 2p + 1 before it, carried as its 3-wide max. The window's values meet
// the running max in the plain version's order (row by row, left to
// right), so the max is the one it takes. blockIdx.x walks the column
// tiles (4 warps of 32 / cb columns), the chunk groups and the frames;
// blockIdx.y the row strips.
__global__ void __launch_bounds__(kPThreads)
    bn_relu_maxpool_kernel(const bf16* x, const float* scale,
                           const float* bias, bf16* out, int h, int w, int c,
                           int hp, int wp, int cb, int col_tiles, int groups) {
  const int chunks = c / 8;
  const int lane = threadIdx.x & 31, qpw = 32 / cb;
  const int qi = lane / cb, k = lane - qi * cb;
  int bx = blockIdx.x;
  const int ct = bx % col_tiles;
  bx /= col_tiles;
  const int chunk = bx % groups * cb + k;
  const size_t nn = bx / groups;
  const int q = (ct * (kPThreads / 32) + (threadIdx.x >> 5)) * qpw + qi;
  const bool lane_in = qi < qpw && q < wp && chunk < chunks;
  const int p0 = blockIdx.y * kPStrip;
  const int p1 = min(p0 + kPStrip, hp);
  float s8[8], b8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s8[e] = lane_in ? __ldg(scale + chunk * 8 + e) : 0.0f;
    b8[e] = lane_in ? __ldg(bias + chunk * 8 + e) : 0.0f;
  }
  const bf16* xn = x + nn * h * w * c + chunk * 8;
  auto in_frame = [&](int row, int col) {
    return lane_in && row >= 0 && row < h && col >= 0 && col < w;
  };
  auto load = [&](int row, int col) {
    return in_frame(row, col)
               ? __ldg(reinterpret_cast<const uint4*>(
                     xn + (static_cast<size_t>(row) * w + col) * c))
               : make_uint4(0, 0, 0, 0);
  };
  // raw chunks of one input row: columns 2q - 1 (the warp's first column
  // only), 2q, 2q + 1
  struct Row {
    uint4 p, e, o;
  };
  auto load_row = [&](int row) {
    Row r;
    r.p = qi == 0 ? load(row, 2 * q - 1) : make_uint4(0, 0, 0, 0);
    r.e = load(row, 2 * q);
    r.o = load(row, 2 * q + 1);
    return r;
  };
  // the row's transformed chunks in window order
  auto affine_row = [&](const Row& r, int row, uint4 (&y)[3]) {
    y[1] = pool_affine(r.e, in_frame(row, 2 * q), s8, b8);
    y[2] = pool_affine(r.o, in_frame(row, 2 * q + 1), s8, b8);
    const uint4 left = shfl_up4(y[2], cb);
    y[0] = qi == 0 ? pool_affine(r.p, in_frame(row, 2 * q - 1), s8, b8)
                   : left;
  };
  auto fold_row = [&](float (&best)[8], const uint4 (&y)[3]) {
    pool_fold(best, y[0]);
    pool_fold(best, y[1]);
    pool_fold(best, y[2]);
  };
  // the carried 3-wide max of row 2 p0 - 1
  float top[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) top[e] = -INFINITY;
  {
    uint4 y[3];
    affine_row(load_row(2 * p0 - 1), 2 * p0 - 1, y);
    fold_row(top, y);
  }
  Row rb = load_row(2 * p0), rc = load_row(2 * p0 + 1);
  for (int pp = p0; pp < p1; ++pp) {
    const Row cb_ = rb, cc_ = rc;
    if (pp + 1 < p1) {  // the next row's loads, in flight while pooling
      rb = load_row(2 * pp + 2);
      rc = load_row(2 * pp + 3);
    }
    uint4 yb[3], yc[3];
    affine_row(cb_, 2 * pp, yb);
    affine_row(cc_, 2 * pp + 1, yc);
    float best[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) best[e] = top[e];
    fold_row(best, yb);
    fold_row(best, yc);
#pragma unroll
    for (int e = 0; e < 8; ++e) top[e] = -INFINITY;
    fold_row(top, yc);
    if (lane_in)
      *reinterpret_cast<uint4*>(out + ((nn * hp + pp) * wp + q) * c +
                                chunk * 8) =
          make_uint4(hop::pack2(best[0], best[1]), hop::pack2(best[2], best[3]),
                     hop::pack2(best[4], best[5]), hop::pack2(best[6], best[7]));
  }
}

// bn_relu_maxpool_kernel over [n, h, w, c]: column tiles of 4 warps of
// 32 / cb columns, strips of kPStrip output rows.
static int bn_relu_maxpool(const bf16* x, const float* scale,
                           const float* bias, bf16* out, int n, int h, int w,
                           int c, cudaStream_t st) {
  const int hp = (h - 1) / 2 + 1, wp = (w - 1) / 2 + 1;
  const int chunks = c / 8;
  const int cb = chunks < 8 ? chunks : 8;
  const int per_tile = kPThreads / 32 * (32 / cb);
  const int col_tiles = (wp + per_tile - 1) / per_tile;
  const int groups = (chunks + cb - 1) / cb;
  const long long nx = static_cast<long long>(col_tiles) * groups * n;
  const int ny = (hp + kPStrip - 1) / kPStrip;
  if (nx > 0x7fffffffLL || ny > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bn_relu_maxpool_kernel<<<dim3(static_cast<unsigned>(nx), ny), kPThreads,
                           0, st>>>(x, scale, bias, out, h, w, c, hp, wp, cb,
                                    col_tiles, groups);
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
