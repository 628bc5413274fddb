// Training-mode TSM bottleneck for Hopper (sm_90a), forward and backward,
// stride 1 and stride 2, with or without the projection residual, and
// the links that fuse one block of the training trunk into the next.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_train_pallas.py:
//   tsm_bottleneck_train, tsm_bottleneck_proj_train and
//   tsm_bottleneck_s2_train (the FK1/FK2/FK3 forward kernels and the
//   BK3/BK2/BK1 backward kernels of _forward, _forward_s2, _backward and
//   _backward_s2), and the cross-block fusion of tsm_trunk_train_pallas.py
//   (FK1 and BK1/BK1_s2 with prev).
//
// Forward of a block (vcg_block_train_fwd, 4-7 launches on the caller's
// stream):
//   u  = conv1x1(shift(x))                + moments of u       (FK1)
//   pr = conv1x1(x, stride)               + moments of pr      (projection)
//   z  = conv3x3(relu(bn1(u)), stride)    + moments of z       (FK2)
//   p  = conv1x1(relu(bn2(z)))            + moments of p       (FK3)
// with the batch statistics finalized between the GEMMs on the device,
// then the finale y = relu(bn3(p) + (x or bnp(pr))) (vcg_finale_fwd).
// Backward: the finale's relu mask and the BN3/BNp backward moments
// (vcg_finale_bwd), then (vcg_block_train_bwd) per conv a weight-gradient
// GEMM (split over pixels, float32 partial sums) and a data-gradient GEMM
// whose epilogue applies the next ReLU mask and takes the next BN's
// backward moments; conv1's data gradient undoes the shift in its
// epilogue and adds the residual gradient. Every BN backward is applied
// on load (GradXf).
//
// The trunk (ops/tsm_trunk_train.py) runs the finale of block N-1 inside
// block N's conv1 instead (vcg_trunk_link_fwd: the loader computes x_N
// from p and r of block N-1 and writes it once), and block N's conv1 data
// gradient finishes block N-1's finale backward in its epilogue
// (vcg_trunk_link_bwd: relu mask of x_N, dq of block N-1 and its BN3/BNp
// moments), so only the top block launches the two finale kernels.
//
// What bounds it on the H100: the products. The block does
// 2 * M * (C*F + 9*F*F + F*4F [+ C*4F]) flops forward and twice that
// backward against a few bytes per flop, above the card's ridge point.
// This version uses WMMA bf16 tiles of 128 x 64/128 with loads through
// registers; wgmma/TMA and on-chip chaining of a block's three convs are
// left for later.
#include <algorithm>
#include <initializer_list>

#include "train_gemm.cuh"

namespace vcg {

template <int BN, class AL, class Xf>
__global__ void __launch_bounds__(kThreads)
    conv_fwd_kernel(Xf a, ConvGeo g, const bf16* w, bf16* out,
                    float* part) {
  __shared__ Smem<BN> sm;
  __shared__ MomSlots<BN> ms;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  ms.zero();
  AL al;
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
//   kUnshift: out[dest] = dX + res[dest], dest = the frame the shift read
//             from; the clip-edge rows that no frame feeds get res alone
//   kLink:    as kUnshift, then dq = out * (x[dest] > 0) (the finale's
//             relu mask of the block below) and that block's BN3/BNp
//             backward moments (sum dq, sum dq * (v - mu), sum dq * (pr -
//             mup)); out = dq
// In kUnshift and kLink the edge row of one clip end takes the place of
// the row the shift drops at the other end, so (row, channel) -> dest is
// one to one: every element of out is written once, by one thread, which
// also reads res there (res may be out itself).
enum { kStore = 0, kMask = 1, kUnshift = 2, kLink = 3 };

struct DgradEpi {
  int mode;
  bf16* out;
  const bf16* v;     // kMask: the BN's input; kLink: p of the block below
  const float* sa;   // kMask
  const float* sb;
  const float* mu;   // kMask, kLink: the mean of v's BN
  const bf16* res;   // kUnshift, kLink: the residual gradient
  const bf16* x;     // kLink: the block's input (the finale's relu output)
  const bf16* pr;    // kLink: pr of the block below, or null
  const float* mup;
  float* part;       // kMask, kLink: per-block partial moments
  int t, fold;
};

static DgradEpi epi_store(void* out) {
  DgradEpi e{};
  e.mode = kStore;
  e.out = static_cast<bf16*>(out);
  return e;
}

static DgradEpi epi_mask(void* out, const void* v, const float* sa,
                         const float* sb, const float* mu, float* part) {
  DgradEpi e{};
  e.mode = kMask;
  e.out = static_cast<bf16*>(out);
  e.v = static_cast<const bf16*>(v);
  e.sa = sa; e.sb = sb; e.mu = mu; e.part = part;
  return e;
}

static DgradEpi epi_unshift(void* out, const void* res, int t, int fold) {
  DgradEpi e{};
  e.mode = kUnshift;
  e.out = static_cast<bf16*>(out);
  e.res = static_cast<const bf16*>(res);
  e.t = t; e.fold = fold;
  return e;
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
    conv_dgrad_kernel(GradXf gx, ConvGeo g, const bf16* wt, DgradEpi ep) {
  __shared__ Smem<BN> sm;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int mi = g.n * g.h * g.w;
  const int plane = g.h * g.w;
  GradA al;
  al.init(gx, g, m0);
  Acc<BN> acc;
  mainloop_w<BN>(sm, al, wt, g.ks * g.ks * g.nout, g.c, n0, acc);
  // the A tiles are done with (mainloop_w ends on a barrier): the moment
  // slots live there
  static_assert(sizeof(MomSlots<BN, 3>) <= sizeof(sm.a), "moment slots");
  MomSlots<BN, 3>& ms = *reinterpret_cast<MomSlots<BN, 3>*>(&sm.a[0][0]);
  ms.zero();
  __syncthreads();
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
    } else if (ep.mode == kStore) {
      if (valid)
        *reinterpret_cast<uint4*>(ep.out + static_cast<size_t>(gm) * g.c +
                                  col) = pack8(v);
    } else {
      float mom[3][8] = {};
      if (valid) {
        int dest = gm;
        bool keep = true;
        if (ep.fold) {
          const int tt = (gm / plane) % ep.t;
          if (col < ep.fold) {
            keep = tt < ep.t - 1;
            dest += keep ? plane : (1 - ep.t) * plane;
          } else if (col < 2 * ep.fold) {
            keep = tt > 0;
            dest += keep ? -plane : (ep.t - 1) * plane;
          }
        }
        const size_t off = static_cast<size_t>(dest) * g.c + col;
        float o[8];
        unpack8(ldg16(ep.res + off), o);
        if (keep) {
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = v[e] + o[e];
        }
        if (ep.mode == kLink) {
          float xv[8], pv[8], rv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          unpack8(ldg16(ep.x + off), xv);
          unpack8(ldg16(ep.v + off), pv);
          if (ep.pr != nullptr) unpack8(ldg16(ep.pr + off), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float dx = __bfloat162float(__float2bfloat16_rn(o[e]));
            const float d = xv[e] > 0.0f ? dx : 0.0f;
            o[e] = d;
            mom[0][e] = d;
            mom[1][e] = d * (pv[e] - ep.mu[col + e]);
            mom[2][e] = ep.pr != nullptr ? d * (rv[e] - ep.mup[col + e])
                                         : 0.0f;
          }
        }
        *reinterpret_cast<uint4*>(ep.out + off) = pack8(o);
      }
      if (ep.mode == kLink)
        moments_add3(ms.slot(0), ms.slot(1), ms.slot(2), c, mom);
    }
  });
  if (ep.mode == kMask || ep.mode == kLink) {
    __syncthreads();
    ms.store(ep.part, g.c, n0, ep.mode == kLink ? 3 : 2);
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
    *reinterpret_cast<uint4*>(y + i * 8) =
        finale8(ldg16(p + i * 8), ldg16(r + i * 8), sa3, sb3, sap, sbp, ch);
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

// The forward conv (A through loader AL from Xf: ActA for an activation,
// LinkA for the trunk's link), then its moments [2][nout] from the
// blocks' partial rows (part holds mt * 2 * nout floats).
template <class AL = ActA, class Xf = ActXf>
static cudaError_t conv_fwd(const Xf& a, const ConvGeo& g, const void* w,
                            void* out, float* mom, float* part,
                            cudaStream_t st) {
  const dim3 grid((g.m + kBM - 1) / kBM, g.nout % 128 == 0 ? g.nout / 128
                                                           : g.nout / 64);
  const bf16* wk = static_cast<const bf16*>(w);
  bf16* o = static_cast<bf16*>(out);
  if (g.nout % 128 == 0)
    conv_fwd_kernel<128, AL, Xf><<<grid, kThreads, 0, st>>>(a, g, wk, o,
                                                             part);
  else
    conv_fwd_kernel<64, AL, Xf><<<grid, kThreads, 0, st>>>(a, g, wk, o,
                                                            part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(part, grid.x, 2 * g.nout, mom, st);
}

// The data-gradient conv; kMask (kLink) also reduces its moments into mom
// [2][C] ([3][C]); ep.part holds mt * 2 (3) * C floats.
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
  if (e != cudaSuccess || (ep.mode != kMask && ep.mode != kLink)) return e;
  return reduce_rows(ep.part, grid.x, (ep.mode == kLink ? 3 : 2) * g.c, mom,
                     st);
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

// Floats of the scratch `part` one block's entries need: the largest of
// the per-block moment rows of each conv, the finale and the links whose
// conv1 is this block's, and the pixel-split partial weight gradients.
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
  take(rows(g1.m) * 3 * c);            // the backward link's moments
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

// The block's forward up to p (no finale). link: conv1 already ran as the
// trunk's link (trunk_link_fwd wrote x, u and the moments of u into mom).
static int block_fwd(const void* x, const void* w1, const void* w2,
                     const void* w3, const void* wp, const float* gb,
                     void* u, void* z, void* p, void* pr, float* stats,
                     float* vec, float* mom, float* part, int n, int h,
                     int w, int c, int f, int co, int stride, int t, int fold,
                     float eps, int link, cudaStream_t st) {
  // gb: gamma/beta in the stats layout (g1 be1 g2 be2 g3 be3 gp bep)
  const Vec8 S{stats, f, co}, V{vec, f, co}, G{const_cast<float*>(gb), f, co};
  const bool proj = wp != nullptr;
  // moments: m1 [2F] | m2 [2F] | m3 [2Co] | mp [2Co]
  float* m1 = mom;
  float* m2 = mom + 2 * f;
  float* m3 = mom + 4 * f;
  float* mp = mom + 4 * f + 2 * co;
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  if (!link)
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
  return 0;
}

// The block's backward from dq (the finale's masked gradient) and its
// BN3/BNp backward moments mom3 [3Co] (sum dq, sum dq (p - mu3), sum dq
// (pr - mup)). link: stop before conv1's data gradient (the trunk's
// backward link does it); a projection block's residual gradient is then
// left in dx.
static int block_bwd(const void* dq, const float* mom3, const void* x,
                     const void* u, const void* z, const void* p,
                     const void* pr, const void* w1t, const void* w2t,
                     const void* w3t, const void* wpt, const float* gb,
                     const float* stats, const float* vec, void* dx,
                     float* dw1, float* dw2, float* dw3, float* dwp,
                     float* dgb, void* da2, void* da1, float* work,
                     float* part, int n, int h, int w, int c, int f, int co,
                     int stride, int t, int fold, float eps, int link,
                     cudaStream_t st) {
  const bool proj = wpt != nullptr;
  const Vec8 S{const_cast<float*>(stats), f, co};
  const Vec8 V{const_cast<float*>(vec), f, co};
  const Vec8 G{const_cast<float*>(gb), f, co};
  const Vec8 D{dgb, f, co};
  // work: mom2 [2F] | mom1 [2F] | abc3 [3Co] | abcp [3Co] | abc2 [3F] |
  //       abc1 [3F]
  float* mom2 = work;
  float* mom1 = mom2 + 2 * f;
  float* abc3 = mom1 + 2 * f;
  float* abcp = abc3 + 3 * co;
  float* abc2 = abcp + 3 * co;
  float* abc1 = abc2 + 3 * f;
  const ConvGeo g1 = geo(n, h, w, c, 1, 1, 0, f);
  const ConvGeo g2 = geo(n, h, w, f, 3, stride, 1, f);
  const ConvGeo g3 = geo(n, g2.ho, g2.wo, f, 1, 1, 0, co);
  const ConvGeo gp = geo(n, h, w, c, 1, stride, 0, co);
  const int m2 = g3.m;
  VCG_TRY(bn_bwd(mom3, mom3 + co, co, m2, G.at(4), S.at(4), S.at(5), eps,
                 abc3, D.at(4), D.at(5), st));
  if (proj)
    VCG_TRY(bn_bwd(mom3, mom3 + 2 * co, co, m2, G.at(6), S.at(6), S.at(7),
                   eps, abcp, D.at(6), D.at(7), st));

  // conv3: dw3 = relu(bn2(z))^T dp; da2 = (dp w3^T) * relu'(bn2(z))
  const GradXf gx3 = grad(dq, p, abc3, co);
  VCG_TRY(conv_wgrad(act(z, V.at(2), V.at(3), t, 0), g3, gx3, dw3, part,
                     st));
  VCG_TRY(conv_dgrad(gx3, g3, w3t,
                     epi_mask(da2, z, V.at(2), V.at(3), S.at(2), part), mom2,
                     st));
  VCG_TRY(bn_bwd(mom2, mom2 + f, f, m2, G.at(2), S.at(2), S.at(3), eps, abc2,
                 D.at(2), D.at(3), st));

  // conv2 (3x3, stride): dw2 and da1 = conv2^T(dz) * relu'(bn1(u))
  const GradXf gx2 = grad(da2, z, abc2, f);
  VCG_TRY(conv_wgrad(act(u, V.at(0), V.at(1), t, 0), g2, gx2, dw2, part,
                     st));
  VCG_TRY(conv_dgrad(gx2, g2, w2t,
                     epi_mask(da1, u, V.at(0), V.at(1), S.at(0), part), mom1,
                     st));
  VCG_TRY(bn_bwd(mom1, mom1 + f, f, g1.m, G.at(0), S.at(0), S.at(1), eps,
                 abc1, D.at(0), D.at(1), st));

  // conv1's weight gradient, the residual gradient, then (unless the
  // trunk's link takes it) conv1's data gradient unshifted onto it
  const GradXf gx1 = grad(da1, u, abc1, f);
  VCG_TRY(conv_wgrad(act(x, nullptr, nullptr, t, fold), g1, gx1, dw1, part,
                     st));
  if (proj) {
    const GradXf gxp = grad(dq, pr, abcp, co);
    VCG_TRY(conv_wgrad(act(x, nullptr, nullptr, t, 0), gp, gxp, dwp, part,
                       st));
    VCG_TRY(conv_dgrad(gxp, gp, wpt, epi_store(dx), nullptr, st));
  }
  if (link) return 0;
  VCG_TRY(conv_dgrad(gx1, g1, w1t, epi_unshift(dx, proj ? dx : dq, t, fold),
                     nullptr, st));
  return 0;
}

static int finale_fwd(const void* p, const void* r, const float* vec,
                      void* y, int m, int f, int co, int proj,
                      cudaStream_t st) {
  const Vec8 V{const_cast<float*>(vec), f, co};
  const size_t chunks = static_cast<size_t>(m) * co / 8;
  const int blocks = static_cast<int>(std::min<size_t>((chunks + 255) / 256,
                                                       4 * 132 * 8));
  finale_fwd_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(p), static_cast<const bf16*>(r), V.at(4),
      V.at(5), proj ? V.at(6) : nullptr, proj ? V.at(7) : nullptr,
      static_cast<bf16*>(y), chunks, co);
  return static_cast<int>(cudaGetLastError());
}

static int finale_bwd(const void* dy, const void* y, const void* p,
                      const void* pr, const float* stats, void* dq,
                      float* mom3, float* part, int m, int f, int co,
                      cudaStream_t st) {
  const Vec8 S{const_cast<float*>(stats), f, co};
  const int fb = finale_bwd_blocks(m);
  finale_bwd_kernel<<<fb, kThreads, 0, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
      static_cast<const bf16*>(p), static_cast<const bf16*>(pr), S.at(4),
      pr != nullptr ? S.at(6) : nullptr, static_cast<bf16*>(dq), part, m,
      co);
  VCG_TRY(cudaGetLastError());
  return static_cast<int>(reduce_rows(part, fb, 3 * co, mom3, st));
}

// Block N's conv1 with block N-1's finale on load (LinkA); vprev is block
// N-1's vec (sa3 sb3 [sap sbp] at its [4F', ...) offsets, Co' = c).
static int link_fwd(const void* pp, const void* rp, const float* vprev,
                    const void* w1, void* x, void* u, float* mom1,
                    float* part, int n, int h, int w, int c, int f,
                    int fprev, int proj_prev, int t, int fold,
                    cudaStream_t st) {
  const Vec8 V{const_cast<float*>(vprev), fprev, c};
  LinkXf a;
  a.p = static_cast<const bf16*>(pp);
  a.r = static_cast<const bf16*>(rp);
  a.sa3 = V.at(4);
  a.sb3 = V.at(5);
  a.sap = proj_prev ? V.at(6) : nullptr;
  a.sbp = proj_prev ? V.at(7) : nullptr;
  a.x_out = static_cast<bf16*>(x);
  a.t = t;
  a.fold = fold;
  return static_cast<int>(conv_fwd<LinkA>(a, geo(n, h, w, c, 1, 1, 0, f),
                                          w1, u, mom1, part, st));
}

// Block N's conv1 data gradient (da1 through BN1's backward abc1 [3F])
// unshifted onto the residual gradient res, masked by x (block N's input)
// into block N-1's dq, with block N-1's BN3/BNp backward moments into
// mom3 [3C] (sprev: block N-1's stats, F' = fprev, Co' = c).
static int link_bwd(const void* da1, const void* u, const float* abc1,
                    const void* w1t, const void* res, const void* x,
                    const void* pp, const void* prp, const float* sprev,
                    void* dq, float* mom3, float* part, int n, int h, int w,
                    int c, int f, int fprev, int t, int fold,
                    cudaStream_t st) {
  const Vec8 S{const_cast<float*>(sprev), fprev, c};
  DgradEpi ep = epi_unshift(dq, res, t, fold);
  ep.mode = kLink;
  ep.x = static_cast<const bf16*>(x);
  ep.v = static_cast<const bf16*>(pp);
  ep.mu = S.at(4);
  ep.pr = static_cast<const bf16*>(prp);
  ep.mup = prp != nullptr ? S.at(6) : nullptr;
  ep.part = part;
  return static_cast<int>(conv_dgrad(grad(da1, u, abc1, f),
                                     geo(n, h, w, c, 1, 1, 0, f), w1t, ep,
                                     mom3, st));
}

}  // namespace vcg

// Weights (bf16): w1 [C, F], w2 [9F, F] (HWIO rows), w3 [F, Co], wp [C, Co]
// or null. gb (f32): gamma/beta as g1 be1 g2 be2 g3 be3 gp bep ([F] x 4,
// [Co] x 4). Outputs u [M1, F], z [M2, F], p [M2, Co], pr [M2, Co] (bf16);
// stats mu/var and vec sa/sb in the same layout (f32); scratch: mom 4F +
// 4Co floats, part vcg_block_train_workspace floats. link != 0: u and the
// moments mom[0, 2F) come from vcg_trunk_link_fwd, which wrote x.
extern "C" int vcg_block_train_fwd(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* wp, const void* gb, void* u, void* z, void* p, void* pr,
    void* stats, void* vec, void* mom, void* part, int n, int h, int w,
    int c, int f, int co, int stride, int t, int fold, int link, float eps,
    void* stream) {
  return vcg::block_fwd(x, w1, w2, w3, wp, static_cast<const float*>(gb), u,
                        z, p, pr, static_cast<float*>(stats),
                        static_cast<float*>(vec), static_cast<float*>(mom),
                        static_cast<float*>(part), n, h, w, c, f, co, stride,
                        t, fold, eps, link, static_cast<cudaStream_t>(stream));
}

// The finale y [M, Co] = relu(bn3(p) + (r or bnp(r))) from the block's vec
// (proj != 0: r is pr, else the block input x).
extern "C" int vcg_finale_fwd(const void* p, const void* r, const void* vec,
                              void* y, int m, int f, int co, int proj,
                              void* stream) {
  return vcg::finale_fwd(p, r, static_cast<const float*>(vec), y, m, f, co,
                         proj, static_cast<cudaStream_t>(stream));
}

// The finale's backward prologue: dq = dy * (y > 0) [M, Co] and mom3 [3Co]
// = (sum dq, sum dq (p - mu3), sum dq (pr - mup); 0 without pr) with mu3
// and mup from the block's stats. part: vcg_block_train_workspace floats.
extern "C" int vcg_finale_bwd(const void* dy, const void* y, const void* p,
                              const void* pr, const void* stats, void* dq,
                              void* mom3, void* part, int m, int f, int co,
                              void* stream) {
  return vcg::finale_bwd(dy, y, p, pr, static_cast<const float*>(stats), dq,
                         static_cast<float*>(mom3), static_cast<float*>(part),
                         m, f, co, static_cast<cudaStream_t>(stream));
}

// The trunk's forward link: block N's conv1 reading block N-1's p [M, C]
// and r [M, C] (its x, or its pr when proj_prev) with block N-1's vec
// (F' = fprev); writes block N's input x [M, C], u [M, F] and the moments
// of u into mom1 [2F]. part: block N's vcg_block_train_workspace floats.
extern "C" int vcg_trunk_link_fwd(const void* p_prev, const void* r_prev,
                                  const void* vec_prev, const void* w1,
                                  void* x, void* u, void* mom1, void* part,
                                  int n, int h, int w, int c, int f,
                                  int fprev, int proj_prev, int t, int fold,
                                  void* stream) {
  return vcg::link_fwd(p_prev, r_prev, static_cast<const float*>(vec_prev),
                       w1, x, u, static_cast<float*>(mom1),
                       static_cast<float*>(part), n, h, w, c, f, fprev,
                       proj_prev, t, fold, static_cast<cudaStream_t>(stream));
}

// The trunk's backward link: block N's conv1 data gradient from da1 [M, F],
// u and abc1 (the last 3F floats of block N's backward work), unshifted
// onto res [M, C] (block N's dq, or its projection's data gradient),
// masked by x (block N's input) into dq_prev [M, C], with mom3_prev [3C]
// from p_prev, pr_prev (or null) and block N-1's stats (F' = fprev).
// w1t [F, C]. part: block N's vcg_block_train_workspace floats.
extern "C" int vcg_trunk_link_bwd(
    const void* da1, const void* u, const void* abc1, const void* w1t,
    const void* res, const void* x, const void* p_prev, const void* pr_prev,
    const void* stats_prev, void* dq_prev, void* mom3_prev, void* part,
    int n, int h, int w, int c, int f, int fprev, int t, int fold,
    void* stream) {
  return vcg::link_bwd(da1, u, static_cast<const float*>(abc1), w1t, res, x,
                       p_prev, pr_prev, static_cast<const float*>(stats_prev),
                       dq_prev, static_cast<float*>(mom3_prev),
                       static_cast<float*>(part), n, h, w, c, f, fprev, t,
                       fold, static_cast<cudaStream_t>(stream));
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

// Floats of the `part` scratch the entries need for this block shape.
extern "C" long long vcg_block_train_workspace(int n, int h, int w, int c,
                                               int f, int co, int stride) {
  return static_cast<long long>(
      vcg::block_workspace(n, h, w, c, f, co, stride));
}

// From dq [M2, Co] and mom3 [3Co] (vcg_finale_bwd or the block above's
// vcg_trunk_link_bwd). Transposed weights (bf16): w1t [F, C], w2t [9F, F]
// with rows (kh, kw, f) and columns c (HWIO with I and O swapped), w3t
// [Co, F], wpt [Co, C] or null. Outputs: dx [M1, C] bf16 (link != 0: the
// projection's data gradient only, untouched without one), dw* f32 in the
// forward layouts, dgb f32 in the stats layout. Scratch: da2 [M2, F], da1
// [M1, F] bf16; work 10F + 6Co floats (its last 3F: BN1's backward
// vectors, which the link reads); part vcg_block_train_workspace floats.
extern "C" int vcg_block_train_bwd(
    const void* dq, const void* mom3, const void* x, const void* u,
    const void* z, const void* p, const void* pr, const void* w1t,
    const void* w2t, const void* w3t, const void* wpt, const void* gb,
    const void* stats, const void* vec, void* dx, void* dw1, void* dw2,
    void* dw3, void* dwp, void* dgb, void* da2, void* da1, void* work,
    void* part, int n, int h, int w, int c, int f, int co, int stride,
    int t, int fold, int link, float eps, void* stream) {
  return vcg::block_bwd(
      dq, static_cast<const float*>(mom3), x, u, z, p, pr, w1t, w2t, w3t,
      wpt, static_cast<const float*>(gb), static_cast<const float*>(stats),
      static_cast<const float*>(vec), dx, static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(dw3),
      static_cast<float*>(dwp), static_cast<float*>(dgb), da2, da1,
      static_cast<float*>(work), static_cast<float*>(part), n, h, w, c, f,
      co, stride, t, fold, eps, link, static_cast<cudaStream_t>(stream));
}
