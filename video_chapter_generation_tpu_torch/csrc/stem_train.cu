// Training-mode ResNet stem on 4x4 space-to-depth frames, for Hopper.
//
// Replaces video_chapter_generation_tpu/ops/stem_train_pallas.py
// (stem_s2d_train / stem_frames_train: the SFK-A, SFK-B, SBK-A and SBK-B
// kernels). Input [N, H/4, W/4, 48] as raw uint8 pixels (normalized here)
// or as bf16 values already normalized (the frames entry); channel order
// (dy, dx, c) as in stem_s2d.cu.
//
// Forward (one C entry):
//   yc  = conv7x7/2(x) (pad 3), bf16, + (sum, sum^2) of yc per channel
//   BN statistics over all 2n x 2n conv pixels, on the device
//   out = maxpool3x3/2(relu(sa * yc + sb)) (pad 1)
// Backward (one C entry; the stem's input is data, so no dx):
//   da  = sum of dpool over the windows whose max equals the recomputed
//         activation (ties inside a window each receive the window's
//         gradient, as the TPU kernel does), times relu', + the BN
//         backward moments (sum da, sum da * (yc - mu))
//   dw  = patches^T (A * da + E * yc + F) over all conv pixels, split
//         over pixels with float32 partial sums
//
// What bounds it on the H100: the gather. K = 147 (padded to 160) is
// shallow; every A element is a scattered byte read and a normalize. The
// conv output yc round-trips device memory once for the pool and once for
// the backward, as on the TPU.
#include <math.h>

#include <algorithm>

#include "train_gemm.cuh"

namespace vcg {

constexpr int kStemK = 147;     // 7 * 7 * 3
constexpr int kStemKPad = 160;  // multiple of kBK; weight rows 147.. are zero

struct StemSrc {
  const void* s4;
  int u8;            // 1: raw uint8 pixels, normalized here; 0: bf16 values
  const float* norm; // [a0 a1 a2 b0 b1 b2]: x = u8 * a + b
  int n, hs, ws;     // input [n, hs, ws, 48]; conv output [n, 2hs, 2ws, 64]
};

// Element k = (kh, kw, c) of the 7x7/2 patch of conv pixel (n, oh, ow).
__device__ __forceinline__ float stem_val(const StemSrc& s, int n, int oh,
                                          int ow, int k) {
  if (k >= kStemK) return 0.0f;
  const int tap = k / 3;
  const int c = k - 3 * tap;
  const int kh = tap / 7;
  const int kw = tap - 7 * kh;
  const int ih = 2 * oh - 3 + kh;
  const int iw = 2 * ow - 3 + kw;
  if (ih < 0 || ih >= 4 * s.hs || iw < 0 || iw >= 4 * s.ws) return 0.0f;
  const size_t idx =
      ((static_cast<size_t>(n) * s.hs + (ih >> 2)) * s.ws + (iw >> 2)) * 48 +
      (ih & 3) * 12 + (iw & 3) * 3 + c;
  if (s.u8) {
    const float u = static_cast<float>(static_cast<const uint8_t*>(s.s4)[idx]);
    // two roundings, no FMA: the same float ops as the plain version
    return __fadd_rn(__fmul_rn(u, s.norm[c]), s.norm[3 + c]);
  }
  return __bfloat162float(static_cast<const bf16*>(s.s4)[idx]);
}

// Forward A tile: thread i fills 16 consecutive k of row i / 2.
struct StemA {
  StemSrc s;
  int n, oh, ow, row, kh16;
  bool ok;

  __device__ void init(const StemSrc& s_, int m0) {
    s = s_;
    const int hc = 2 * s.hs, wc = 2 * s.ws;
    row = threadIdx.x >> 1;
    kh16 = (threadIdx.x & 1) * 16;
    const int mm = m0 + row;
    ok = mm < s.n * hc * wc;
    const int q = ok ? mm : 0;
    n = q / (hc * wc);
    const int rem = q - n * hc * wc;
    oh = rem / wc;
    ow = rem - oh * wc;
  }

  __device__ void load(bf16* as, int k0) const {
    alignas(16) bf16 v[16];
    for (int e = 0; e < 16; ++e)
      v[e] = __float2bfloat16_rn(ok ? stem_val(s, n, oh, ow, k0 + kh16 + e)
                                    : 0.0f);
    uint4* dst = reinterpret_cast<uint4*>(as + row * kALd + kh16);
    dst[0] = reinterpret_cast<const uint4*>(v)[0];
    dst[1] = reinterpret_cast<const uint4*>(v)[1];
  }
};

// Weight-gradient A tile [32 pixels][128 k], as ActT.
struct StemT {
  StemSrc s;
  int kc, rsub, k0;

  __device__ void init(int k0_) {
    k0 = k0_;
    kc = threadIdx.x & 15;
    rsub = threadIdx.x >> 4;
  }

  __device__ void load(bf16* as, int m0, int m_end) const {
    const int hc = 2 * s.hs, wc = 2 * s.ws;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rsub + 16 * i;
      const int mm = m0 + r;
      const bool ok = mm < m_end;
      const int q = ok ? mm : 0;
      const int n = q / (hc * wc);
      const int rem = q - n * hc * wc;
      const int oh = rem / wc;
      const int ow = rem - oh * wc;
      alignas(16) bf16 v[8];
      for (int e = 0; e < 8; ++e)
        v[e] = __float2bfloat16_rn(
            ok ? stem_val(s, n, oh, ow, k0 + kc * 8 + e) : 0.0f);
      *reinterpret_cast<uint4*>(as + r * kTLd + kc * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    stem_conv_kernel(StemSrc s, const bf16* w, bf16* yc, float* part) {
  __shared__ Smem<64> sm;
  __shared__ MomSlots<64> ms;
  const int m = s.n * 4 * s.hs * s.ws;
  const int m0 = blockIdx.x * kBM;
  ms.zero();
  StemA al;
  al.init(s, m0);
  Acc<64> acc;
  mainloop_w<64>(sm, al, w, kStemKPad, 64, 0, acc);
  epilogue<64>(sm.epi[threadIdx.x >> 5], acc, [&](int r, int c,
                                                 float(&v)[8]) {
    const int gm = m0 + r;
    const bool valid = gm < m;
    alignas(16) bf16 o[8];
    float a[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] = __float2bfloat16_rn(v[e]);
      const float f = valid ? __bfloat162float(o[e]) : 0.0f;
      a[e] = f;
      b[e] = f * f;
    }
    if (valid)
      *reinterpret_cast<uint4*>(yc + static_cast<size_t>(gm) * 64 + c) =
          *reinterpret_cast<const uint4*>(o);
    moments_add(ms.s0(), ms.s1(), c, a, b);
  });
  __syncthreads();
  ms.store(part, 64, 0);
}

// relu(sa * yc + sb) rounded to bf16, the same ops in the pool and in the
// backward's recompute, so the tie test is exact.
__device__ __forceinline__ float stem_act(float v, float sa, float sb) {
  return __bfloat162float(__float2bfloat16_rn(fmaxf(fmaf(v, sa, sb), 0.0f)));
}

// out [n, hp, wp, 64] = 3x3/2 max pool (pad 1) of the activation of yc
// [n, hc, wc, 64]; one thread per 8-channel chunk of one output pixel.
__global__ void stem_pool_kernel(const bf16* yc, const float* sa,
                                 const float* sb, bf16* out, int n, int hc,
                                 int wc, int hp, int wp) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(n) * hp * wp * 8) return;
  const int cc = idx & 7;
  const size_t pix = idx >> 3;
  const int q = pix % wp;
  const int p = (pix / wp) % hp;
  const int nn = pix / (static_cast<size_t>(wp) * hp);
  float best[8];
  for (int e = 0; e < 8; ++e) best[e] = -INFINITY;
  for (int dr = 0; dr < 3; ++dr) {
    const int r = 2 * p - 1 + dr;
    if (r < 0 || r >= hc) continue;
    for (int dc = 0; dc < 3; ++dc) {
      const int c = 2 * q - 1 + dc;
      if (c < 0 || c >= wc) continue;
      float v[8];
      unpack8(ldg16(yc + ((static_cast<size_t>(nn) * hc + r) * wc + c) * 64 +
                    cc * 8),
              v);
      for (int e = 0; e < 8; ++e)
        best[e] = fmaxf(best[e], stem_act(v[e], sa[cc * 8 + e],
                                          sb[cc * 8 + e]));
    }
  }
  *reinterpret_cast<uint4*>(out + pix * 64 + cc * 8) = pack8(best);
}

// da at every conv pixel: the pooled gradient routed to each window
// position equal to the window max, times relu'; plus the BN backward
// moments, one row [2][64] of partial sums per block in part. Thread: one
// 8-channel chunk of pixels strided over the grid; the block's rows are
// summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
    stem_route_kernel(const bf16* dpool, const bf16* pooled, const bf16* yc,
                      const float* sa, const float* sb, const float* mu,
                      bf16* da, float* part, int n, int hc, int wc, int hp,
                      int wp) {
  __shared__ float red[kThreads / 8][2][64];
  const int cc = threadIdx.x & 7;
  const int ch = cc * 8;
  const int total = n * hc * wc;
  float s0[8] = {0}, s1[8] = {0};
  for (int pix = blockIdx.x * (kThreads / 8) + (threadIdx.x >> 3); pix < total;
       pix += gridDim.x * (kThreads / 8)) {
    const int c = pix % wc;
    const int r = (pix / wc) % hc;
    const int nn = pix / (wc * hc);
    float v[8], y[8], acc[8];
    unpack8(ldg16(yc + static_cast<size_t>(pix) * 64 + ch), v);
    for (int e = 0; e < 8; ++e) {
      y[e] = stem_act(v[e], sa[ch + e], sb[ch + e]);
      acc[e] = 0.0f;
    }
    // windows p with 2p - 1 <= r <= 2p + 1, likewise for columns
    const int p_lo = r / 2, p_hi = min((r + 1) / 2, hp - 1);
    const int q_lo = c / 2, q_hi = min((c + 1) / 2, wp - 1);
    for (int p = p_lo; p <= p_hi; ++p) {
      for (int q = q_lo; q <= q_hi; ++q) {
        const size_t off = ((static_cast<size_t>(nn) * hp + p) * wp + q) * 64 + ch;
        float pm[8], dp[8];
        unpack8(ldg16(pooled + off), pm);
        unpack8(ldg16(dpool + off), dp);
        for (int e = 0; e < 8; ++e)
          if (y[e] == pm[e]) acc[e] += dp[e];
      }
    }
    for (int e = 0; e < 8; ++e) {
      const float d = y[e] > 0.0f ? acc[e] : 0.0f;
      acc[e] = d;
      s0[e] += d;
      s1[e] += d * (v[e] - mu[ch + e]);
    }
    *reinterpret_cast<uint4*>(da + static_cast<size_t>(pix) * 64 + ch) =
        pack8(acc);
  }
  for (int e = 0; e < 8; ++e) {
    red[threadIdx.x >> 3][0][ch + e] = s0[e];
    red[threadIdx.x >> 3][1][ch + e] = s1[e];
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    const int k = threadIdx.x >> 6, j = threadIdx.x & 63;
    float acc = 0.0f;
    for (int r = 0; r < kThreads / 8; ++r) acc += red[r][k][j];
    part[static_cast<size_t>(blockIdx.x) * 128 + threadIdx.x] = acc;
  }
}

static int route_blocks(int m) {
  return std::max(1, std::min(4 * 132, m / (kThreads / 8)));
}

// Floats of the `part` scratch of the stem's forward and backward.
static size_t stem_workspace(int n, int hs, int ws) {
  const int m = n * 4 * hs * ws;
  int chunk = 0;
  const size_t z = wgrad_grid(kStemKPad, 64, 64, m, &chunk).z;
  size_t need = static_cast<size_t>((m + kBM - 1) / kBM) * 128;
  need = std::max(need, static_cast<size_t>(route_blocks(m)) * 128);
  if (z > 1) need = std::max(need, z * kStemKPad * 64);
  return need;
}

#define VCG_TRY(expr)                      \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return int(e_); \
  } while (0)

}  // namespace vcg

// s4 [n, hs, ws, 48] (u8 != 0: uint8, else bf16); w [160, 64] bf16 (HWIO
// [7,7,3,64] rows, zero padded); gb = gamma [64], beta [64] f32; norm [6]
// f32. Outputs: yc [n, 2hs, 2ws, 64] bf16, out [n, hs, ws, 64] bf16, stats
// = mu [64], var [64] f32, vec = sa [64], sb [64] f32; scratch: mom 128
// f32, part vcg_stem_train_workspace f32.
extern "C" long long vcg_stem_train_workspace(int n, int hs, int ws) {
  return static_cast<long long>(vcg::stem_workspace(n, hs, ws));
}

extern "C" int vcg_stem_train_fwd(const void* s4, int u8, const void* w,
                                  const void* gb, const void* norm, void* yc,
                                  void* out, void* stats, void* vec,
                                  void* mom, void* part, int n, int hs,
                                  int ws, float eps, void* stream) {
  using namespace vcg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StemSrc s{s4, u8, static_cast<const float*>(norm), n, hs, ws};
  const int hc = 2 * hs, wc = 2 * ws;
  const int m = n * hc * wc;
  float* mo = static_cast<float*>(mom);
  float* sv = static_cast<float*>(stats);
  float* vv = static_cast<float*>(vec);
  const float* g = static_cast<const float*>(gb);
  float* pa = static_cast<float*>(part);
  const int mt = (m + kBM - 1) / kBM;
  stem_conv_kernel<<<mt, kThreads, 0, st>>>(
      s, static_cast<const bf16*>(w), static_cast<bf16*>(yc), pa);
  VCG_TRY(cudaGetLastError());
  VCG_TRY(reduce_rows(pa, mt, 128, mo, st));
  bn_stats_kernel<<<1, 64, 0, st>>>(mo, 64, static_cast<float>(m), g, g + 64,
                                    eps, sv, sv + 64, vv, vv + 64);
  VCG_TRY(cudaGetLastError());
  const int hp = (hc - 1) / 2 + 1, wp = (wc - 1) / 2 + 1;
  const size_t total = static_cast<size_t>(n) * hp * wp * 8;
  stem_pool_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(yc), vv, vv + 64, static_cast<bf16*>(out), n,
      hc, wc, hp, wp);
  return static_cast<int>(cudaGetLastError());
}

// dpool, out [n, hs, ws, 64] bf16; yc as the forward wrote it; stats/vec
// from the forward. Outputs: dw [160, 64] f32 (rows 147.. stay zero),
// dgb = dgamma [64], dbeta [64] f32. Scratch: da [n, 2hs, 2ws, 64] bf16,
// work 128 + 192 f32, part vcg_stem_train_workspace f32.
extern "C" int vcg_stem_train_bwd(const void* dpool, const void* out,
                                  const void* yc, const void* s4, int u8,
                                  const void* norm, const void* gb,
                                  const void* stats, const void* vec,
                                  void* da, void* dw, void* dgb, void* work,
                                  void* part, int n, int hs, int ws,
                                  float eps, void* stream) {
  using namespace vcg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hc = 2 * hs, wc = 2 * ws;
  const int hp = (hc - 1) / 2 + 1, wp = (wc - 1) / 2 + 1;
  const int m = n * hc * wc;
  float* mo = static_cast<float*>(work);
  float* abc = mo + 128;
  const float* sv = static_cast<const float*>(stats);
  const float* vv = static_cast<const float*>(vec);
  const float* g = static_cast<const float*>(gb);
  float* dg = static_cast<float*>(dgb);
  float* dwf = static_cast<float*>(dw);
  float* pa = static_cast<float*>(part);
  const int blocks = route_blocks(m);
  stem_route_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const bf16*>(dpool), static_cast<const bf16*>(out),
      static_cast<const bf16*>(yc), vv, vv + 64, sv,
      static_cast<bf16*>(da), pa, n, hc, wc, hp, wp);
  VCG_TRY(cudaGetLastError());
  VCG_TRY(reduce_rows(pa, blocks, 128, mo, st));
  bn_bwd_kernel<<<1, 64, 0, st>>>(mo, mo + 64, 64, static_cast<float>(m), g,
                                  sv, sv + 64, eps, abc, abc + 64, abc + 128,
                                  dg, dg + 64);
  VCG_TRY(cudaGetLastError());
  StemT al;
  al.s = StemSrc{s4, u8, static_cast<const float*>(norm), n, hs, ws};
  GradT<64> gl;
  gl.gx.da = static_cast<const bf16*>(da);
  gl.gx.v = static_cast<const bf16*>(yc);
  gl.gx.ga = abc;
  gl.gx.ge = abc + 64;
  gl.gx.gf = abc + 128;
  gl.gx.c = 64;
  int chunk = 0;
  const dim3 grid = wgrad_grid(kStemKPad, 64, 64, m, &chunk);
  wgrad_kernel<64, StemT, GradT<64>><<<grid, kThreads, 0, st>>>(
      al, gl, chunk, m, kStemKPad, 64, grid.z > 1 ? pa : dwf);
  VCG_TRY(cudaGetLastError());
  if (grid.z > 1) {
    reduce_slices_kernel<<<(kStemKPad * 64 + 255) / 256, 256, 0, st>>>(
        pa, grid.z, kStemKPad * 64, dwf);
  }
  return static_cast<int>(cudaGetLastError());
}
