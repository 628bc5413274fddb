// Training-mode TSM bottleneck for Hopper (sm_90a), forward and backward,
// stride 1 and stride 2, with or without the projection residual.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_train_pallas.py:
//   tsm_bottleneck_train, tsm_bottleneck_proj_train and
//   tsm_bottleneck_s2_train (the FK1/FK2/FK3 forward kernels and the
//   BK3/BK2/BK1 backward kernels of _forward, _forward_s2, _backward and
//   _backward_s2), and carries the trunk of tsm_trunk_train_pallas.py
//   (ops/tsm_trunk_train.py calls these entries block after block, and
//   vcg_block_train_recompute_p to make each block's p again before its
//   backward instead of keeping it).
//
// Forward (one C entry, 5-8 launches on the caller's stream):
//   u  = conv1x1(shift(x))                + moments of u       (FK1)
//   pr = conv1x1(x, stride)               + moments of pr      (projection)
//   z  = conv3x3(relu(bn1(u)), stride)    + moments of z       (FK2)
//   p  = conv1x1(relu(bn2(z)))            + moments of p       (FK3)
//   y  = relu(bn3(p) + (x or bnp(pr)))                         (finale)
// with the batch statistics finalized between the GEMMs on the device.
// Backward (one C entry): the finale's relu mask and the BN3/BNp backward
// moments, then per conv a weight-gradient GEMM (split over pixels,
// float32 partial sums) and a data-gradient GEMM whose epilogue applies
// the next ReLU mask and takes the next BN's backward moments; conv1's
// data gradient undoes the shift in its epilogue and adds itself to the
// residual gradient. Every BN backward is applied on load (GradXf).
//
// What bounds it on the H100: the products. The block does
// 2 * M * (C*F + 9*F*F + F*4F [+ C*4F]) flops forward and twice that
// backward against a few bytes per flop, above the card's ridge point.
// This first version uses WMMA bf16 tiles of 128 x 64/128 with loads
// through registers; wgmma/TMA, on-chip chaining of the three convs and
// the cross-block finale fusion of tsm_trunk_train_pallas.py are left for
// later.
#include <algorithm>
#include <initializer_list>

#include "train_gemm.cuh"

namespace vcg {

template <int BN>
__global__ void __launch_bounds__(kThreads)
    conv_fwd_kernel(ActXf a, ConvGeo g, const bf16* w, bf16* out,
                    float* part) {
  __shared__ Smem<BN> sm;
  __shared__ MomSlots<BN> ms;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  ms.zero();
  ActA al;
  al.init(a, g, m0);
  Acc<BN> acc;
  mainloop_w<BN>(sm, al, w, g.k, g.nout, n0, acc);
  epilogue<BN>(sm.epi[threadIdx.x >> 5], acc,
               [&](int r, int c, float(&v)[8]) {
                 const int gm = m0 + r;
                 const bool valid = gm < g.m;
                 alignas(16) bf16 o[8];
                 float s[8], q[8];
#pragma unroll
                 for (int e = 0; e < 8; ++e) {
                   o[e] = __float2bfloat16_rn(v[e]);
                   const float f = valid ? __bfloat162float(o[e]) : 0.0f;
                   s[e] = f;
                   q[e] = f * f;
                 }
                 if (valid)
                   *reinterpret_cast<uint4*>(
                       out + static_cast<size_t>(gm) * g.nout + n0 + c) =
                       *reinterpret_cast<const uint4*>(o);
                 moments_add(ms.s0(), ms.s1(), c, s, q);
               });
  __syncthreads();
  ms.store(part, g.nout, n0);
}

// What the data-gradient epilogue does with dX[Mi, C] (C = g.c):
//   kStore:   out = dX
//   kMask:    out = da = dX * (sa * v + sb > 0), plus the moments
//             (sum da, sum da * (v - mu)) of the BN whose output fed it
//   kUnshift: out[dest] += dX, dest = the frame the shift read from
enum { kStore = 0, kMask = 1, kUnshift = 2 };

struct DgradEpi {
  int mode;
  bf16* out;
  const bf16* v;
  const float* sa;
  const float* sb;
  const float* mu;
  float* part;  // kMask: per-block partial moments [blocks][2][C]
  int t, fold;
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    conv_dgrad_kernel(GradXf gx, ConvGeo g, const bf16* wt, DgradEpi ep) {
  __shared__ Smem<BN> sm;
  __shared__ MomSlots<BN> ms;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int mi = g.n * g.h * g.w;
  const int plane = g.h * g.w;
  ms.zero();
  GradA al;
  al.init(gx, g, m0);
  Acc<BN> acc;
  mainloop_w<BN>(sm, al, wt, g.ks * g.ks * g.nout, g.c, n0, acc);
  epilogue<BN>(sm.epi[threadIdx.x >> 5], acc, [&](int r, int c,
                                                  float(&v)[8]) {
    const int gm = m0 + r;
    const bool valid = gm < mi;
    const int col = n0 + c;
    if (ep.mode == kMask) {
      float lv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (valid) unpack8(ldg16(ep.v + static_cast<size_t>(gm) * g.c + col), lv);
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
        *reinterpret_cast<uint4*>(ep.out + static_cast<size_t>(gm) * g.c +
                                  col) = *reinterpret_cast<const uint4*>(o);
      moments_add(ms.s0(), ms.s1(), c, s, q);
    } else if (valid) {
      int dest = gm;
      if (ep.mode == kUnshift && ep.fold) {
        const int tt = (gm / plane) % ep.t;
        if (col < ep.fold)
          dest = tt < ep.t - 1 ? gm + plane : -1;
        else if (col < 2 * ep.fold)
          dest = tt > 0 ? gm - plane : -1;
      }
      if (dest >= 0) {
        bf16* dst = ep.out + static_cast<size_t>(dest) * g.c + col;
        if (ep.mode == kUnshift) {
          float base[8];
          unpack8(ldg16(dst), base);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += base[e];
        }
        *reinterpret_cast<uint4*>(dst) = pack8(v);
      }
    }
  });
  if (ep.mode == kMask) {
    __syncthreads();
    ms.store(ep.part, g.c, n0);
  }
}

// y = relu(bf16(sa3 * p + sb3) + r'), r' = r (identity) or
// bf16(sap * r + sbp) (projection); 8 channels per thread.
__global__ void finale_fwd_kernel(const bf16* p, const bf16* r,
                                  const float* sa3, const float* sb3,
                                  const float* sap, const float* sbp, bf16* y,
                                  size_t chunks, int c) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < chunks; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>((i * 8) % c);
    float pv[8], rv[8], out[8];
    unpack8(ldg16(p + i * 8), pv);
    unpack8(ldg16(r + i * 8), rv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float a3 = __bfloat162float(
          __float2bfloat16_rn(fmaf(pv[e], sa3[ch + e], sb3[ch + e])));
      const float rr =
          sap == nullptr
              ? rv[e]
              : __bfloat162float(__float2bfloat16_rn(
                    fmaf(rv[e], sap[ch + e], sbp[ch + e])));
      out[e] = fmaxf(a3 + rr, 0.0f);
    }
    *reinterpret_cast<uint4*>(y + i * 8) = pack8(out);
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
  float s0[8] = {0}, s1[8] = {0}, s2[8] = {0};
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
      s1[e] += d[e] * (pv[e] - mu3[ch + e]);
      if (pr != nullptr) s2[e] += d[e] * (rv[e] - mup[ch + e]);
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

// The forward conv, then its moments [2][nout] from the blocks' partial
// rows (part holds mt * 2 * nout floats).
static cudaError_t conv_fwd(const ActXf& a, const ConvGeo& g, const void* w,
                            void* out, float* mom, float* part,
                            cudaStream_t st) {
  const dim3 grid((g.m + kBM - 1) / kBM, g.nout % 128 == 0 ? g.nout / 128
                                                           : g.nout / 64);
  const bf16* wk = static_cast<const bf16*>(w);
  bf16* o = static_cast<bf16*>(out);
  if (g.nout % 128 == 0)
    conv_fwd_kernel<128><<<grid, kThreads, 0, st>>>(a, g, wk, o, part);
  else
    conv_fwd_kernel<64><<<grid, kThreads, 0, st>>>(a, g, wk, o, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(part, grid.x, 2 * g.nout, mom, st);
}

// The data-gradient conv; kMask also reduces its moments into mom [2][C]
// (ep.part holds mt * 2 * C floats).
static cudaError_t conv_dgrad(const GradXf& gx, const ConvGeo& g,
                              const void* wt, const DgradEpi& ep, float* mom,
                              cudaStream_t st) {
  const int mi = g.n * g.h * g.w;
  const bool wide = g.c % 128 == 0;
  const dim3 grid((mi + kBM - 1) / kBM, wide ? g.c / 128 : g.c / 64);
  const bf16* wk = static_cast<const bf16*>(wt);
  if (wide)
    conv_dgrad_kernel<128><<<grid, kThreads, 0, st>>>(gx, g, wk, ep);
  else
    conv_dgrad_kernel<64><<<grid, kThreads, 0, st>>>(gx, g, wk, ep);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ep.mode != kMask) return e;
  return reduce_rows(ep.part, grid.x, 2 * g.c, mom, st);
}

// Pixel splits of a weight gradient (see wgrad_grid).
static int wgrad_splits(const ConvGeo& g) {
  int chunk = 0;
  return wgrad_grid(g.k, g.nout, g.nout % 128 == 0 ? 128 : 64, g.m, &chunk).z;
}

// dw [k, nout] f32 = the weight gradient; with more than one pixel split
// the splits' partial sums go to part (splits * k * nout floats) and are
// summed in split order.
static cudaError_t conv_wgrad(const ActXf& a, const ConvGeo& g,
                              const GradXf& gx, float* dw, float* part,
                              cudaStream_t st) {
  ActT al;
  al.a = a;
  al.g = g;
  int chunk = 0;
  dim3 grid;
  if (g.nout % 128 == 0) {
    GradT<128> gl;
    gl.gx = gx;
    grid = wgrad_grid(g.k, g.nout, 128, g.m, &chunk);
    wgrad_kernel<128, ActT, GradT<128>><<<grid, kThreads, 0, st>>>(
        al, gl, chunk, g.m, g.k, g.nout, grid.z > 1 ? part : dw);
  } else {
    GradT<64> gl;
    gl.gx = gx;
    grid = wgrad_grid(g.k, g.nout, 64, g.m, &chunk);
    wgrad_kernel<64, ActT, GradT<64>><<<grid, kThreads, 0, st>>>(
        al, gl, chunk, g.m, g.k, g.nout, grid.z > 1 ? part : dw);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || grid.z == 1) return e;
  const size_t n = static_cast<size_t>(g.k) * g.nout;
  reduce_slices_kernel<<<static_cast<unsigned>(std::min<size_t>(
                             (n + 255) / 256, 4 * 132 * 8)),
                         256, 0, st>>>(part, grid.z, n, dw);
  return cudaGetLastError();
}

static cudaError_t bn_stats(const float* mom, int n, int count,
                            const float* gamma, const float* beta, float eps,
                            float* mu, float* var, float* sa, float* sb,
                            cudaStream_t st) {
  bn_stats_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      mom, n, static_cast<float>(count), gamma, beta, eps, mu, var, sa, sb);
  return cudaGetLastError();
}

static cudaError_t bn_bwd(const float* s0, const float* s1, int n, int count,
                          const float* gamma, const float* mu,
                          const float* var, float eps, float* abc,
                          float* dgamma, float* dbeta, cudaStream_t st) {
  bn_bwd_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      s0, s1, n, static_cast<float>(count), gamma, mu, var, eps, abc,
      abc + n, abc + 2 * n, dgamma, dbeta);
  return cudaGetLastError();
}

static int finale_bwd_blocks(int m) {
  return std::max(1, std::min(4 * 132, m / 8));
}

// Floats of the scratch `part` one block's forward and backward need: the
// largest of the per-block moment rows of each conv and the finale, and
// the pixel-split partial weight gradients.
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
  take(rows(g1.m) * 2 * f);            // conv2 dgrad moments (rows of u)
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

static int block_fwd(const void* x, const void* w1, const void* w2,
                     const void* w3, const void* wp, const float* gb,
                     void* u, void* z, void* p, void* pr, void* y,
                     float* stats, float* vec, float* mom, float* part,
                     int n, int h, int w, int c, int f, int co, int stride,
                     int t, int fold, float eps, cudaStream_t st) {
  // gb: gamma/beta in the stats layout (g1 be1 g2 be2 g3 be3 gp bep)
  const Vec8 S{stats, f, co}, V{vec, f, co}, G{const_cast<float*>(gb), f, co};
  const bool proj = wp != nullptr;
  // moments: m1 [2F] | m2 [2F] | m3 [2Co] | mp [2Co]
  float* m1 = mom;
  float* m2 = mom + 2 * f;
  float* m3 = mom + 4 * f;
  float* mp = mom + 4 * f + 2 * co;
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  VCG_TRY(conv_fwd(act(x, nullptr, nullptr, t, fold), g1, w1, u, m1, part,
                   st));
  const ConvGeo gp = geo(n, h, w, c, 1, stride, 0, co);
  if (proj)
    VCG_TRY(conv_fwd(act(x, nullptr, nullptr, t, 0), gp, wp, pr, mp, part,
                     st));
  VCG_TRY(bn_stats(m1, f, g1.m, G.at(0), G.at(1), eps, S.at(0), S.at(1),
                   V.at(0), V.at(1), st));
  const ConvGeo g2 = geo(n, h, w, f, 3, stride, 1, f);
  VCG_TRY(conv_fwd(act(u, V.at(0), V.at(1), t, 0), g2, w2, z, m2, part,
                   st));
  VCG_TRY(bn_stats(m2, f, g2.m, G.at(2), G.at(3), eps, S.at(2), S.at(3),
                   V.at(2), V.at(3), st));
  const ConvGeo g3 = geo(n, g2.ho, g2.wo, f, 1, 1, 0, co);
  VCG_TRY(conv_fwd(act(z, V.at(2), V.at(3), t, 0), g3, w3, p, m3, part,
                   st));
  VCG_TRY(bn_stats(m3, co, g3.m, G.at(4), G.at(5), eps, S.at(4), S.at(5),
                   V.at(4), V.at(5), st));
  if (proj)
    VCG_TRY(bn_stats(mp, co, g3.m, G.at(6), G.at(7), eps, S.at(6), S.at(7),
                     V.at(6), V.at(7), st));
  const size_t chunks = static_cast<size_t>(g3.m) * co / 8;
  const int blocks = static_cast<int>(std::min<size_t>((chunks + 255) / 256,
                                                       4 * 132 * 8));
  finale_fwd_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(p),
      static_cast<const bf16*>(proj ? pr : x), V.at(4), V.at(5),
      proj ? V.at(6) : nullptr, proj ? V.at(7) : nullptr,
      static_cast<bf16*>(y), chunks, co);
  return static_cast<int>(cudaGetLastError());
}

static int block_bwd(const void* dy, const void* x, const void* u,
                     const void* z, const void* p, const void* pr,
                     const void* y, const void* w1t, const void* w2t,
                     const void* w3t, const void* wpt, const float* gb,
                     const float* stats, const float* vec, void* dx,
                     float* dw1, float* dw2, float* dw3, float* dwp,
                     float* dgb, void* dq, void* da2, void* da1, float* work,
                     float* part, int n, int h, int w, int c, int f, int co,
                     int stride, int t, int fold, float eps,
                     cudaStream_t st) {
  const bool proj = wpt != nullptr;
  const Vec8 S{const_cast<float*>(stats), f, co};
  const Vec8 V{const_cast<float*>(vec), f, co};
  const Vec8 G{const_cast<float*>(gb), f, co};
  const Vec8 D{dgb, f, co};
  // work: mom3 [3Co] | mom2 [2F] | mom1 [2F] | abc3 [3Co] | abcp [3Co] |
  //       abc2 [3F] | abc1 [3F]
  float* mom3 = work;
  float* mom2 = mom3 + 3 * co;
  float* mom1 = mom2 + 2 * f;
  float* abc3 = mom1 + 2 * f;
  float* abcp = abc3 + 3 * co;
  float* abc2 = abcp + 3 * co;
  float* abc1 = abc2 + 3 * f;
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  const ConvGeo g2 = geo(n, h, w, f, 3, stride, 1, f);
  const ConvGeo g3 = geo(n, g2.ho, g2.wo, f, 1, 1, 0, co);
  const ConvGeo gp = geo(n, h, w, c, 1, stride, 0, co);

  // finale: relu mask, BN3 (and BNp) backward moments
  const int m2 = g3.m;
  const int fb = finale_bwd_blocks(m2);
  finale_bwd_kernel<<<fb, kThreads, 0, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
      static_cast<const bf16*>(p), static_cast<const bf16*>(proj ? pr : nullptr),
      S.at(4), proj ? S.at(6) : nullptr, static_cast<bf16*>(dq), part, m2, co);
  VCG_TRY(cudaGetLastError());
  VCG_TRY(reduce_rows(part, fb, 3 * co, mom3, st));
  VCG_TRY(bn_bwd(mom3, mom3 + co, co, m2, G.at(4), S.at(4), S.at(5), eps,
                 abc3, D.at(4), D.at(5), st));
  if (proj)
    VCG_TRY(bn_bwd(mom3, mom3 + 2 * co, co, m2, G.at(6), S.at(6), S.at(7),
                   eps, abcp, D.at(6), D.at(7), st));

  // conv3: dw3 = relu(bn2(z))^T dp; da2 = (dp w3^T) * relu'(bn2(z))
  const GradXf gx3 = grad(dq, p, abc3, co);
  VCG_TRY(conv_wgrad(act(z, V.at(2), V.at(3), t, 0), g3, gx3, dw3, part,
                     st));
  DgradEpi ep{kMask, static_cast<bf16*>(da2), static_cast<const bf16*>(z),
              V.at(2), V.at(3), S.at(2), part, t, 0};
  VCG_TRY(conv_dgrad(gx3, g3, w3t, ep, mom2, st));
  VCG_TRY(bn_bwd(mom2, mom2 + f, f, m2, G.at(2), S.at(2), S.at(3), eps, abc2,
                 D.at(2), D.at(3), st));

  // conv2 (3x3, stride): dw2 and da1 = conv2^T(dz) * relu'(bn1(u))
  const GradXf gx2 = grad(da2, z, abc2, f);
  VCG_TRY(conv_wgrad(act(u, V.at(0), V.at(1), t, 0), g2, gx2, dw2, part,
                     st));
  ep = DgradEpi{kMask, static_cast<bf16*>(da1), static_cast<const bf16*>(u),
                V.at(0), V.at(1), S.at(0), part, t, 0};
  VCG_TRY(conv_dgrad(gx2, g2, w2t, ep, mom1, st));
  VCG_TRY(bn_bwd(mom1, mom1 + f, f, g1.m, G.at(0), S.at(0), S.at(1), eps,
                 abc1, D.at(0), D.at(1), st));

  // residual gradient into dx, then conv1 (shifted) on top of it
  const GradXf gx1 = grad(da1, u, abc1, f);
  VCG_TRY(conv_wgrad(act(x, nullptr, nullptr, t, fold), g1, gx1, dw1, part,
                     st));
  if (proj) {
    const GradXf gxp = grad(dq, pr, abcp, co);
    VCG_TRY(conv_wgrad(act(x, nullptr, nullptr, t, 0), gp, gxp, dwp, part,
                       st));
    ep = DgradEpi{kStore, static_cast<bf16*>(dx), nullptr, nullptr, nullptr,
                  nullptr, nullptr, t, 0};
    VCG_TRY(conv_dgrad(gxp, gp, wpt, ep, nullptr, st));
  } else {
    VCG_TRY(cudaMemcpyAsync(dx, dq, sizeof(bf16) * static_cast<size_t>(g1.m) * c,
                            cudaMemcpyDeviceToDevice, st));
  }
  ep = DgradEpi{kUnshift, static_cast<bf16*>(dx), nullptr, nullptr, nullptr,
                nullptr, nullptr, t, fold};
  VCG_TRY(conv_dgrad(gx1, g1, w1t, ep, nullptr, st));
  return 0;
}

}  // namespace vcg

// Weights (bf16): w1 [C, F], w2 [9F, F] (HWIO rows), w3 [F, Co], wp [C, Co]
// or null. gb (f32): gamma/beta as g1 be1 g2 be2 g3 be3 gp bep ([F] x 4,
// [Co] x 4). Outputs u [M1, F], z [M2, F], p [M2, Co], pr [M2, Co], y
// [M2, Co] (bf16); stats mu/var and vec sa/sb in the same layout (f32);
// scratch: mom 4F + 4Co floats, part vcg_block_train_workspace floats.
extern "C" int vcg_block_train_fwd(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* wp, const void* gb, void* u, void* z, void* p, void* pr,
    void* y, void* stats, void* vec, void* mom, void* part, int n, int h,
    int w, int c, int f, int co, int stride, int t, int fold, float eps,
    void* stream) {
  return vcg::block_fwd(x, w1, w2, w3, wp, static_cast<const float*>(gb), u,
                        z, p, pr, y, static_cast<float*>(stats),
                        static_cast<float*>(vec), static_cast<float*>(mom),
                        static_cast<float*>(part), n, h, w, c, f, co, stride,
                        t, fold, eps, static_cast<cudaStream_t>(stream));
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

// Floats of the `part` scratch both entries need for this block shape.
extern "C" long long vcg_block_train_workspace(int n, int h, int w, int c,
                                               int f, int co, int stride) {
  return static_cast<long long>(
      vcg::block_workspace(n, h, w, c, f, co, stride));
}

// Transposed weights (bf16): w1t [F, C], w2t [9F, F] with rows (kh, kw, f)
// and columns c (HWIO with I and O swapped), w3t [Co, F], wpt [Co, C] or
// null. Outputs: dx [M1, C] bf16, dw* f32 in the forward layouts, dgb f32
// in the stats layout. Scratch: dq [M2, Co], da2 [M2, F], da1 [M1, F]
// bf16; work 9Co + 10F floats; part vcg_block_train_workspace floats.
extern "C" int vcg_block_train_bwd(
    const void* dy, const void* x, const void* u, const void* z,
    const void* p, const void* pr, const void* y, const void* w1t,
    const void* w2t, const void* w3t, const void* wpt, const void* gb,
    const void* stats, const void* vec, void* dx, void* dw1, void* dw2,
    void* dw3, void* dwp, void* dgb, void* dq, void* da2, void* da1,
    void* work, void* part, int n, int h, int w, int c, int f, int co,
    int stride, int t, int fold, float eps, void* stream) {
  return vcg::block_bwd(
      dy, x, u, z, p, pr, y, w1t, w2t, w3t, wpt,
      static_cast<const float*>(gb), static_cast<const float*>(stats),
      static_cast<const float*>(vec), dx, static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(dw3),
      static_cast<float*>(dwp), static_cast<float*>(dgb), dq, da2, da1,
      static_cast<float*>(work), static_cast<float*>(part), n, h, w, c, f,
      co, stride, t, fold, eps, static_cast<cudaStream_t>(stream));
}
