// W8A8 inference TSM bottleneck (stride 1, identity residual) for Hopper
// (sm_90a), kernel K9.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_int8_pallas.py:
// tsm_bottleneck_int8_pallas (_kernel_flat_i8, _kernel_halo_i8). It
// computes the integer spec of that file (:26-39) exactly as its plain
// version, ops/tsm_block_int8.py:int8_bottleneck_plain, does:
//
//   xq   = x (int8) or clip(round(x / sx))            (stage entry, bf16)
//   y1   = relu(f32(shift(xq) @ w1q) * a1 + b1)
//   y1q  = clip(round(y1 / sz))       (the conv2 im2col is y1q shifted)
//   d_r  = f32(sum_{dc,c} y1q[h+r-1, w+dc-1, c] w2q_r[dc,c]) * a2_r
//   y2   = relu(((d_1 + d_0) + d_2) + b2),   y2q = clip(round(y2 / sy2))
//   out  = relu((f32(y2q @ w3q) * a3 + b3) + xf),  xf = xq * sx or x
//   store clip(round(out / sout)) as int8, or out as bf16.
//
// Rounding follows the plain version: a division by each scale
// (__fdiv_rn; the TPU kernel multiplies by a reciprocal), round half to
// even (__float2int_rn), every product and sum rounded on its own
// (__fmul_rn/__fadd_rn: nvcc would otherwise contract them into FMAs),
// and each row tap of the 3x3 kept in its own int32 accumulator, turned
// into float once (the sum of one tap reaches 3F * 127^2 > 2^24, so where
// it is rounded matters) and added in the reference's order.
//
// What bounds it on the H100: the int8 products. The block does
// 2 * M * (C*F + 9*F*F + F*C) integer ops against about one byte per
// activation element, far above the card's ridge point. This first
// version is three launches of one int8 implicit-GEMM tile
// (mma.sync.m16n8k32 s8 x s8 -> s32, 128 x 128 x 64 tiles, cp.async two
// stages): conv1 (the temporal shift folded into the A load, and the
// stage entry's quantization too), conv2 (three row taps, each a K = 3F
// GEMM), conv3 (the residual in the epilogue). y1q and y2q round-trip
// device memory as int8. wgmma/TMA, and keeping y1/y2 on chip, are left
// for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vcg8 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 128;       // output channels per block
constexpr int kBK = 64;        // reduction depth (bytes) per stage
constexpr int kThreads = 256;  // eight warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int kLd = kBK + 16;  // smem pitch (bytes): conflict-free words
constexpr int kFM = 4;         // m16 tiles per warp
constexpr int kFN = 4;         // n8 tiles per warp

struct Smem {
  alignas(16) int8_t a[2][kBM * kLd];  // A tile, [row][k]
  alignas(16) int8_t b[2][kBN * kLd];  // W tile, [n][k] (W is stored N x K)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // a source size of 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// clip(round(v / s), -127, 127): IEEE division, round half to even
__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

// Thread i owns 16-byte chunk (i % 4) of A rows i / 4 and i / 4 + 64.
struct Rows {
  int kc, r[2], pix[2];
  bool ok[2];
  __device__ void init(int m0, int m) {
    kc = threadIdx.x & 3;
    for (int i = 0; i < 2; ++i) {
      r[i] = (threadIdx.x >> 2) + i * 64;
      pix[i] = m0 + r[i];
      ok[i] = pix[i] < m;
      if (!ok[i]) pix[i] = 0;
    }
  }
};

// conv1's A: x at the shifted frame (fold 0 reads frame t + 1, fold 1
// frame t - 1, zero at the clip edges; frames are time-major per clip).
// int8 x streams in with cp.async; bf16 x (the stage entry) is loaded,
// quantized with sx and stored.
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
      int8_t* dst = as + rows.r[i] * kLd + rows.kc * 16;
      const size_t off = static_cast<size_t>(ok ? p : 0) * c + ch;
      if (x_i8) {
        cp_async16(dst, static_cast<const int8_t*>(x) + off, ok);
      } else {
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
    }
  }
};

// conv2's A for row tap dr: K runs over (dc, c) of y1q at (h + dr - 1,
// w + dc - 1), zero outside the image (the 3x3's pad).
struct Conv2A {
  const int8_t* y1q;
  int f, h, w, dr;
  int n_[2], h_[2], w_[2];
  Rows rows;

  __device__ void init(int m0, int m) {
    rows.init(m0, m);
    for (int i = 0; i < 2; ++i) {
      const int p = rows.pix[i];
      n_[i] = p / (h * w);
      const int rem = p - n_[i] * h * w;
      h_[i] = rem / w;
      w_[i] = rem - h_[i] * w;
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

// W tile: rows n0.. of wt [nout, k_total] (K contiguous), 64 bytes each.
__device__ __forceinline__ void load_w(int8_t* bs, const int8_t* wt,
                                       int k_total, int k0, int n0) {
  const int kc = threadIdx.x & 3;
  for (int i = 0; i < 2; ++i) {
    const int r = (threadIdx.x >> 2) + i * 64;
    cp_async16(bs + r * kLd + kc * 16,
               wt + static_cast<size_t>(n0 + r) * k_total + k0 + kc * 16,
               true);
  }
}

// acc += A[m0.., :k_total] x W[n0.., :k_total]^T for this block's tile.
template <class ALoader>
__device__ void gemm_tile(Smem& sm, const ALoader& al, const int8_t* wt,
                          int k_total, int n0, int (&acc)[kFM][kFN][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int ktiles = k_total / kBK;
  al.load(sm.a[0], 0);
  load_w(sm.b[0], wt, k_total, 0, n0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) {
      al.load(sm.a[s ^ 1], (kt + 1) * kBK);
      load_w(sm.b[s ^ 1], wt, k_total, (kt + 1) * kBK, n0);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kFM][4], bfr[kFN][2];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        const int8_t* p = sm.a[s] + (wm * 64 + i * 16 + g) * kLd + kk + tg * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        const int8_t* p = sm.b[s] + (wn * 32 + j * 8 + g) * kLd + kk + tg * 4;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(int (&acc)[kFM][kFN][4]) {
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Calls fn(row, col, i, j, e) for each accumulator element this thread
// holds: element e of tile (i, j) sits at row g (+8 for e >= 2), column
// 2 * tg + (e & 1) of the m16 x n8 tile.
template <class Fn>
__device__ __forceinline__ void each_element(int m0, int n0, Fn fn) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(m0 + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0),
           n0 + wn * 32 + j * 8 + 2 * tg + (e & 1), i, j, e);
}

struct Params {
  const void* x;         // [m, c] int8 or bf16
  const int8_t* w1t;     // [f, c]
  const int8_t* w2t;     // [3, f, 3f]: row tap, out channel, (dc, c)
  const int8_t* w3t;     // [c, f]
  const float *a1, *b1;  // [f]
  const float *a2, *b2;  // [3f] (row tap major), [f]
  const float *a3, *b3;  // [c]
  int8_t* y1q;           // [m, f] scratch
  int8_t* y2q;           // [m, f] scratch
  void* out;             // [m, c] int8 or bf16
  float sx, sz, sy2, sout;
  int m, h, w, c, f, t, fold, x_i8, out_i8;
};

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
  al.y1q = p.y1q; al.f = p.f; al.h = p.h; al.w = p.w;
  al.init(m0, p.m);
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
    if (row >= p.m) return;
    const float y2 = fmaxf(__fadd_rn(sum[i][j][e], p.b2[col]), 0.0f);
    p.y2q[static_cast<size_t>(row) * p.f + col] =
        static_cast<int8_t>(quant(y2, p.sy2));
  });
}

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
    const float out = fmaxf(__fadd_rn(y3, xf), 0.0f);
    if (p.out_i8)
      static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(quant(out, p.sout));
    else
      static_cast<bf16*>(p.out)[o] = __float2bfloat16_rn(out);
  });
}

}  // namespace vcg8

// x [n*t, h, w, c] int8 (x_i8) or bf16; w1t [f, c], w2t [3, f, 3f],
// w3t [c, f] int8 (transposed: K contiguous); a1/b1 [f], a2 [3f], b2 [f],
// a3/b3 [c] f32; y1q, y2q [n*t*h*w, f] int8 scratch; out [n*t, h, w, c]
// int8 (out_i8) or bf16. Needs c % 128 == 0, f % 128 == 0, fold % 16 == 0.
extern "C" int vcg_tsm_bottleneck_int8(
    const void* x, const void* w1t, const void* w2t, const void* w3t,
    const void* a1, const void* b1, const void* a2, const void* b2,
    const void* a3, const void* b3, void* y1q, void* y2q, void* out,
    float sx, float sz, float sy2, float sout, int nt, int h, int w, int c,
    int f, int t, int fold, int x_i8, int out_i8, void* stream) {
  vcg8::Params p;
  p.x = x;
  p.w1t = static_cast<const int8_t*>(w1t);
  p.w2t = static_cast<const int8_t*>(w2t);
  p.w3t = static_cast<const int8_t*>(w3t);
  p.a1 = static_cast<const float*>(a1); p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2); p.b2 = static_cast<const float*>(b2);
  p.a3 = static_cast<const float*>(a3); p.b3 = static_cast<const float*>(b3);
  p.y1q = static_cast<int8_t*>(y1q);
  p.y2q = static_cast<int8_t*>(y2q);
  p.out = out;
  p.sx = sx; p.sz = sz; p.sy2 = sy2; p.sout = sout;
  p.m = nt * h * w; p.h = h; p.w = w; p.c = c; p.f = f; p.t = t;
  p.fold = fold; p.x_i8 = x_i8; p.out_i8 = out_i8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned mt = (p.m + vcg8::kBM - 1) / vcg8::kBM;
  vcg8::conv1_kernel<<<dim3(mt, f / vcg8::kBN), vcg8::kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  vcg8::conv2_kernel<<<dim3(mt, f / vcg8::kBN), vcg8::kThreads, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  vcg8::conv3_kernel<<<dim3(mt, c / vcg8::kBN), vcg8::kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
