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
// Rounding follows the plain versions: a division by each scale
// (__fdiv_rn; the TPU kernels multiply by a reciprocal), round half to
// even (__float2int_rn), every product and sum rounded on its own
// (__fmul_rn/__fadd_rn: nvcc would otherwise contract them into FMAs),
// and each row tap of the 3x3 kept in its own int32 accumulator, turned
// into float once (the sum of one tap reaches 3F * 127^2 > 2^24, so where
// it is rounded matters) and added in the reference's order.
//
// What bounds them on the H100: the int8 products. A block does
// 2 * (M * C*F + Mo * (9*F*F + F*Cout [+ C*Cout])) integer ops against
// about one byte per activation element, far above the card's ridge
// point. This first version is three launches of the int8 implicit-GEMM
// tile of int8_gemm.cuh: conv1 (the temporal shift folded into the A load,
// and the stage entry's quantization too), conv2 (three row taps, each a
// K = 3F GEMM), conv3 (K9: the residual in the epilogue; K14a: a second
// GEMM in the same block for the projection, read at even rows and
// columns of x). y1q and y2q round-trip device memory as int8. The TPU
// kernel's row tiles with a one-row halo exist for VMEM only and are not
// carried over. wgmma/TMA, and keeping y1/y2 on chip, are left for later.
#include "int8_gemm.cuh"

namespace vcg8 {

// 16 channels of x at pixel offset `off` (elements) into the A tile: int8
// x streams in with cp.async; bf16 x (the stage entry) is loaded,
// quantized with sx and stored. Zeros where !ok.
__device__ __forceinline__ void load_x16(int8_t* dst, const void* x,
                                         size_t off, bool ok, int x_i8,
                                         float sx) {
  if (x_i8) {
    cp_async16(dst, static_cast<const int8_t*>(x) + (ok ? off : 0), ok);
    return;
  }
  alignas(16) int8_t q[16];
  if (ok) {
    alignas(16) bf16 v[16];
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + off);
    reinterpret_cast<uint4*>(v)[0] = src[0];
    reinterpret_cast<uint4*>(v)[1] = src[1];
    for (int e = 0; e < 16; ++e)
      q[e] = static_cast<int8_t>(quant(__bfloat162float(v[e]), sx));
  } else {
    for (int e = 0; e < 16; ++e) q[e] = 0;
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q);
}

// conv1's A: x at the shifted frame (fold 0 reads frame t + 1, fold 1
// frame t - 1, zero at the clip edges; frames are time-major per clip).
struct Conv1A {
  const void* x;
  int c, hw, t, fold, x_i8;
  float sx;
  Rows rows;

  __device__ void load(int8_t* as, int k0) const {
    const int ch = k0 + rows.kc * 16;
    for (int i = 0; i < 2; ++i) {
      int p = rows.pix[i];
      bool ok = rows.ok[i];
      if (fold) {
        const int tt = (p / hw) % t;
        if (ch < fold) {
          p += hw;
          ok = ok && tt < t - 1;
        } else if (ch < 2 * fold) {
          p -= hw;
          ok = ok && tt > 0;
        }
      }
      load_x16(as + rows.r[i] * kLd + rows.kc * 16, x,
               static_cast<size_t>(p) * c + ch, ok, x_i8, sx);
    }
  }
};

// The projection's A (K14a): x unshifted at input pixel (2 oh, 2 ow) of
// output pixel (oh, ow).
struct ProjA {
  const void* x;
  int c, x_i8;
  float sx;
  size_t src[2];
  Rows rows;

  __device__ void init(int m0, int m, int h, int w, int ho, int wo) {
    rows.init(m0, m);
    for (int i = 0; i < 2; ++i) {
      const int p = rows.pix[i];
      const int n = p / (ho * wo);
      const int rem = p - n * ho * wo;
      const int oh = rem / wo, ow = rem - (rem / wo) * wo;
      src[i] = ((static_cast<size_t>(n) * h + 2 * oh) * w + 2 * ow) * c;
    }
  }

  __device__ void load(int8_t* as, int k0) const {
    const int ch = k0 + rows.kc * 16;
    for (int i = 0; i < 2; ++i)
      load_x16(as + rows.r[i] * kLd + rows.kc * 16, x, src[i] + ch,
               rows.ok[i], x_i8, sx);
  }
};

// conv2's A for row tap dr at output pixel (oh, ow): K runs over (dc, c)
// of y1q at (oh * stride + dr - 1, ow * stride + dc - 1), zero outside the
// image (the 3x3's pad).
struct Conv2A {
  const int8_t* y1q;
  int f, h, w, stride, dr;
  int n_[2], h_[2], w_[2];
  Rows rows;

  __device__ void init(int m0, int m, int ho, int wo) {
    rows.init(m0, m);
    for (int i = 0; i < 2; ++i) {
      const int p = rows.pix[i];
      n_[i] = p / (ho * wo);
      const int rem = p - n_[i] * ho * wo;
      h_[i] = (rem / wo) * stride;
      w_[i] = (rem - (rem / wo) * wo) * stride;
    }
  }

  __device__ void load(int8_t* as, int k0) const {
    const int k = k0 + rows.kc * 16;
    const int dc = k / f;
    const int ch = k - dc * f;
    for (int i = 0; i < 2; ++i) {
      const int ih = h_[i] + dr - 1, iw = w_[i] + dc - 1;
      const bool ok = rows.ok[i] && ih >= 0 && ih < h && iw >= 0 && iw < w;
      const size_t off =
          ok ? ((static_cast<size_t>(n_[i]) * h + ih) * w + iw) * f + ch : 0;
      cp_async16(as + rows.r[i] * kLd + rows.kc * 16, y1q + off, ok);
    }
  }
};

// conv3's A: the rows of y2q [m, f] as they are.
struct RowA {
  const int8_t* a;
  int k_total;
  Rows rows;

  __device__ void load(int8_t* as, int k0) const {
    const int ch = k0 + rows.kc * 16;
    for (int i = 0; i < 2; ++i)
      cp_async16(as + rows.r[i] * kLd + rows.kc * 16,
                 a + static_cast<size_t>(rows.pix[i]) * k_total + ch,
                 rows.ok[i]);
  }
};

struct Params {
  const void* x;         // [m, c] int8 or bf16
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

__device__ __forceinline__ void store_out(const Params& p, size_t o,
                                          float out) {
  if (p.out_i8)
    static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(quant(out, p.sout));
  else
    static_cast<bf16*>(p.out)[o] = __float2bfloat16_rn(out);
}

__global__ void __launch_bounds__(kThreads) conv1_kernel(Params p) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  __shared__ Smem sm;
  Conv1A al;
  al.x = p.x; al.c = p.c; al.hw = p.h * p.w; al.t = p.t; al.fold = p.fold;
  al.x_i8 = p.x_i8; al.sx = p.sx;
  al.rows.init(m0, p.m);
  int acc[kFM][kFN][4];
  zero(acc);
  gemm_tile(sm, al, p.w1t, p.c, n0, acc);
  each_element(m0, n0, [&](int row, int col, int i, int j, int e) {
    if (row >= p.m) return;
    const float y1 = fmaxf(
        __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), p.a1[col]),
                  p.b1[col]),
        0.0f);
    p.y1q[static_cast<size_t>(row) * p.f + col] =
        static_cast<int8_t>(quant(y1, p.sz));
  });
}

__global__ void __launch_bounds__(kThreads) conv2_kernel(Params p) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  __shared__ Smem sm;
  Conv2A al;
  al.y1q = p.y1q; al.f = p.f; al.h = p.h; al.w = p.w; al.stride = p.stride;
  al.init(m0, p.m2, p.ho, p.wo);
  int acc[kFM][kFN][4];
  float sum[kFM][kFN][4];
  const int taps[3] = {1, 0, 2};  // the reference's order: centre, top, bottom
  for (int ti = 0; ti < 3; ++ti) {
    const int dr = taps[ti];
    al.dr = dr;
    zero(acc);
    gemm_tile(sm, al, p.w2t + static_cast<size_t>(dr) * p.f * 3 * p.f,
              3 * p.f, n0, acc);
    const float* a2 = p.a2 + dr * p.f;
    each_element(m0, n0, [&](int, int col, int i, int j, int e) {
      const float d = __fmul_rn(__int2float_rn(acc[i][j][e]), a2[col]);
      sum[i][j][e] = ti == 0 ? d : __fadd_rn(sum[i][j][e], d);
    });
  }
  each_element(m0, n0, [&](int row, int col, int i, int j, int e) {
    if (row >= p.m2) return;
    const float y2 = fmaxf(__fadd_rn(sum[i][j][e], p.b2[col]), 0.0f);
    p.y2q[static_cast<size_t>(row) * p.f + col] =
        static_cast<int8_t>(quant(y2, p.sy2));
  });
}

// K9's conv3: the identity residual xf in the epilogue.
__global__ void __launch_bounds__(kThreads) conv3_kernel(Params p) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  __shared__ Smem sm;
  RowA al;
  al.a = p.y2q; al.k_total = p.f;
  al.rows.init(m0, p.m);
  int acc[kFM][kFN][4];
  zero(acc);
  gemm_tile(sm, al, p.w3t, p.f, n0, acc);
  each_element(m0, n0, [&](int row, int col, int i, int j, int e) {
    if (row >= p.m) return;
    const size_t o = static_cast<size_t>(row) * p.c + col;
    const float y3 = __fadd_rn(
        __fmul_rn(__int2float_rn(acc[i][j][e]), p.a3[col]), p.b3[col]);
    const float xf =
        p.x_i8 ? __fmul_rn(static_cast<float>(static_cast<const int8_t*>(p.x)[o]),
                           p.sx)
               : __bfloat162float(static_cast<const bf16*>(p.x)[o]);
    store_out(p, o, fmaxf(__fadd_rn(y3, xf), 0.0f));
  });
}

// K14a's conv3: y3 = y2q @ w3q, then the projection xq[2oh, 2ow] @ wpq in
// the same block (a second GEMM over the same shared memory), summed in
// the epilogue.
__global__ void __launch_bounds__(kThreads) conv3_proj_kernel(Params p) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  __shared__ Smem sm;
  int acc[kFM][kFN][4];
  float y3[kFM][kFN][4];
  {
    RowA al;
    al.a = p.y2q; al.k_total = p.f;
    al.rows.init(m0, p.m2);
    zero(acc);
    gemm_tile(sm, al, p.w3t, p.f, n0, acc);
  }
  each_element(m0, n0, [&](int, int col, int i, int j, int e) {
    y3[i][j][e] = __fadd_rn(
        __fmul_rn(__int2float_rn(acc[i][j][e]), p.a3[col]), p.b3[col]);
  });
  ProjA al;
  al.x = p.x; al.c = p.c; al.x_i8 = p.x_i8; al.sx = p.sx;
  al.init(m0, p.m2, p.h, p.w, p.ho, p.wo);
  zero(acc);
  gemm_tile(sm, al, p.wpt, p.c, n0, acc);
  each_element(m0, n0, [&](int row, int col, int i, int j, int e) {
    if (row >= p.m2) return;
    const float res = __fadd_rn(
        __fmul_rn(__int2float_rn(acc[i][j][e]), p.ap[col]), p.bp[col]);
    store_out(p, static_cast<size_t>(row) * p.cout + col,
              fmaxf(__fadd_rn(y3[i][j][e], res), 0.0f));
  });
}

static Params make_params(const void* x, const void* w1t, const void* w2t,
                          const void* w3t, const void* a1, const void* b1,
                          const void* a2, const void* b2, const void* a3,
                          const void* b3, void* y1q, void* y2q, void* out,
                          float sx, float sz, float sy2, float sout, int nt,
                          int h, int w, int c, int f, int t, int fold,
                          int x_i8, int out_i8) {
  Params p;
  p.x = x;
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

// conv1 and conv2 (both blocks), then the block's conv3: K9's with the
// identity residual, or K14a's with the projection (proj).
static int run(const Params& p, bool proj, cudaStream_t st) {
  const unsigned mt = (p.m + kBM - 1) / kBM;
  const unsigned mt2 = (p.m2 + kBM - 1) / kBM;
  conv1_kernel<<<dim3(mt, p.f / kBN), kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  conv2_kernel<<<dim3(mt2, p.f / kBN), kThreads, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid3(mt2, p.cout / kBN);
  if (proj)
    conv3_proj_kernel<<<grid3, kThreads, 0, st>>>(p);
  else
    conv3_kernel<<<grid3, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vcg8

// K9. x [n*t, h, w, c] int8 (x_i8) or bf16; w1t [f, c], w2t [3, f, 3f],
// w3t [c, f] int8 (transposed: K contiguous); a1/b1 [f], a2 [3f], b2 [f],
// a3/b3 [c] f32; y1q, y2q [n*t*h*w, f] int8 scratch; out [n*t, h, w, c]
// int8 (out_i8) or bf16. Needs c % 128 == 0, f % 128 == 0, fold % 16 == 0.
extern "C" int vcg_tsm_bottleneck_int8(
    const void* x, const void* w1t, const void* w2t, const void* w3t,
    const void* a1, const void* b1, const void* a2, const void* b2,
    const void* a3, const void* b3, void* y1q, void* y2q, void* out,
    float sx, float sz, float sy2, float sout, int nt, int h, int w, int c,
    int f, int t, int fold, int x_i8, int out_i8, void* stream) {
  const vcg8::Params p = vcg8::make_params(
      x, w1t, w2t, w3t, a1, b1, a2, b2, a3, b3, y1q, y2q, out, sx, sz, sy2,
      sout, nt, h, w, c, f, t, fold, x_i8, out_i8);
  return vcg8::run(p, false, static_cast<cudaStream_t>(stream));
}

// K14a. x [n*t, h, w, c] int8 (x_i8) or bf16, h and w even; w1t [f, c],
// w2t [3, f, 3f], w3t [cout, f], wpt [cout, c] int8; a1/b1 [f], a2 [3f],
// b2 [f], a3/b3/ap/bp [cout] f32; y1q [n*t*h*w, f] and y2q
// [n*t*(h/2)*(w/2), f] int8 scratch; out [n*t, h/2, w/2, cout] int8
// (out_i8) or bf16. Needs c % 64 == 0, f % 128 == 0, cout % 128 == 0,
// fold % 16 == 0.
extern "C" int vcg_tsm_bottleneck_s2_int8(
    const void* x, const void* w1t, const void* w2t, const void* w3t,
    const void* wpt, const void* a1, const void* b1, const void* a2,
    const void* b2, const void* a3, const void* b3, const void* ap,
    const void* bp, void* y1q, void* y2q, void* out, float sx, float sz,
    float sy2, float sout, int nt, int h, int w, int c, int f, int cout,
    int t, int fold, int x_i8, int out_i8, void* stream) {
  vcg8::Params p = vcg8::make_params(
      x, w1t, w2t, w3t, a1, b1, a2, b2, a3, b3, y1q, y2q, out, sx, sz, sy2,
      sout, nt, h, w, c, f, t, fold, x_i8, out_i8);
  p.wpt = static_cast<const int8_t*>(wpt);
  p.ap = static_cast<const float*>(ap);
  p.bp = static_cast<const float*>(bp);
  p.ho = h / 2; p.wo = w / 2; p.m2 = nt * p.ho * p.wo;
  p.cout = cout; p.stride = 2;
  return vcg8::run(p, true, static_cast<cudaStream_t>(stream));
}
