// Building blocks of the training kernels (conv_train.cu, stem_train.cu).
//
// Training BatchNorm normalizes with the batch's own statistics, so a
// training convolution cannot fold BN into its weights the way the
// inference kernels do. Every training convolution here is one of three
// implicit GEMMs over NHWC bf16 tensors, each with float32 accumulation:
//
//   forward  out[M, N]  = A[M, K] x W[K, N]      A = input patches
//   dgrad    dX[Mi, C]  = G'[Mi, K'] x Wt[K', C] G' = output-grad patches
//   wgrad    dW[K, N]   = A^T[K, M] x G[M, N]    reduced over all pixels
//
// The operand loaders apply on load what the TPU kernels apply in VMEM:
// the temporal shift or the previous BN + ReLU (relu(sa * v + sb)) on an
// activation, and the BN backward (ga * da + ge * v + gf) on a gradient,
// so none of those intermediates is written to device memory. Epilogues
// take the per-channel batch moments of what they store (forward: sum and
// sum of squares of the bf16-rounded output; dgrad: sum of da and the
// centred sum of da * (v - mu)) with a warp reduction into per-warp-row
// shared slots and one row of partial sums per block; a second small
// kernel sums the rows in a fixed order. No float atomics anywhere: the
// statistics, and so every bf16 rounding downstream of them, are the
// same on every run (batch-stat BN at initialization amplifies a last-bit
// difference in a statistic into a visible difference 16 blocks later).
#pragma once

#include "conv_gemm.cuh"

namespace vcg {

template <int BN>
struct Acc {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[Tile<BN>::kFM][Tile<BN>::kFN];
};

__device__ __forceinline__ void unpack8(uint4 raw, float (&v)[8]) {
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  alignas(16) bf16 o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(v[e]);
  return *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Geometry of one convolution: input [n, h, w, c] -> output [n, ho, wo,
// nout], kernel ks x ks, rows of K ordered (kh, kw, c) like HWIO.
struct ConvGeo {
  int n, h, w, c, ho, wo, ks, stride, pad, nout;
  int m;  // n * ho * wo
  int k;  // ks * ks * c
};

// An activation operand: x [n, h, w, c], optionally shifted in time
// (fold > 0: channels [0, fold) read frame t + 1, [fold, 2 fold) frame
// t - 1, zero at the clip edges) or passed through the previous BN + ReLU
// (sa != null). Padding is zero after the transform, as in the reference.
struct ActXf {
  const bf16* x;
  const float* sa;
  const float* sb;
  int t, fold;
};

__device__ __forceinline__ uint4 act8(const ActXf& a, const ConvGeo& g,
                                      int nn, int ih, int iw, int ch,
                                      bool ok) {
  if (a.fold) {
    const int tt = nn % a.t;
    if (ch < a.fold) {
      nn += 1;
      ok = ok && tt < a.t - 1;
    } else if (ch < 2 * a.fold) {
      nn -= 1;
      ok = ok && tt > 0;
    }
  }
  if (!ok) return make_uint4(0, 0, 0, 0);
  const uint4 raw =
      ldg16(a.x + ((static_cast<size_t>(nn) * g.h + ih) * g.w + iw) * g.c + ch);
  if (a.sa == nullptr) return raw;
  float v[8];
  unpack8(raw, v);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = fmaxf(fmaf(v[e], a.sa[ch + e], a.sb[ch + e]), 0.0f);
  return pack8(v);
}

// A gradient operand through the BN backward: g = ga * da + ge * v + gf,
// da and v row-major [m, c] (v is the BN's input), rounded to bf16.
struct GradXf {
  const bf16* da;
  const bf16* v;
  const float* ga;
  const float* ge;
  const float* gf;
  int c;
};

__device__ __forceinline__ uint4 grad8(const GradXf& g, size_t row, int ch,
                                       bool ok) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  float d[8], v[8];
  unpack8(ldg16(g.da + row * g.c + ch), d);
  unpack8(ldg16(g.v + row * g.c + ch), v);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    d[e] = fmaf(g.ga[ch + e], d[e], fmaf(g.ge[ch + e], v[e], g.gf[ch + e]));
  return pack8(d);
}

// Forward A tile: rows are output pixels, k = (kh, kw, c). Thread i owns
// 16-byte chunk (i % 4) of rows i / 4 and i / 4 + 64 (as ConvA does).
struct ActA {
  ActXf a;
  ConvGeo g;
  int kc;
  int rn[2], roh[2], row_[2];
  bool rok[2];

  __device__ void init(const ActXf& a_, const ConvGeo& g_, int m0) {
    a = a_;
    g = g_;
    kc = threadIdx.x & 3;
    const int plane = g.ho * g.wo;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (threadIdx.x >> 2) + i * 64;
      rok[i] = m < g.m;
      const int mm = rok[i] ? m : 0;
      rn[i] = mm / plane;
      const int rem = mm - rn[i] * plane;
      roh[i] = rem / g.wo;
      row_[i] = rem - roh[i] * g.wo;
    }
  }

  __device__ void load(bf16* as, int k0) const {
    const int k = k0 + kc * 8;
    const int tap = k / g.c;
    const int ch = k - tap * g.c;
    const int kh = tap / g.ks;
    const int kw = tap - kh * g.ks;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ih = roh[i] * g.stride - g.pad + kh;
      const int iw = row_[i] * g.stride - g.pad + kw;
      const bool ok = rok[i] && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      const int r = (threadIdx.x >> 2) + i * 64;
      *reinterpret_cast<uint4*>(as + r * kALd + kc * 8) =
          act8(a, g, rn[i], ih, iw, ch, ok);
    }
  }
};

// Dgrad A tile: rows are INPUT pixels of the forward conv g, k = (kh, kw,
// f) over the output-gradient channels. Input pixel ih receives output
// row oh = (ih + pad - kh) / stride where that divides and is in range.
struct GradA {
  GradXf gx;
  ConvGeo g;
  int kc;
  int rn[2], rih[2], riw[2];
  bool rok[2];

  __device__ void init(const GradXf& gx_, const ConvGeo& g_, int m0) {
    gx = gx_;
    g = g_;
    kc = threadIdx.x & 3;
    const int plane = g.h * g.w;
    const int mi = g.n * plane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (threadIdx.x >> 2) + i * 64;
      rok[i] = m < mi;
      const int mm = rok[i] ? m : 0;
      rn[i] = mm / plane;
      const int rem = mm - rn[i] * plane;
      rih[i] = rem / g.w;
      riw[i] = rem - rih[i] * g.w;
    }
  }

  __device__ void load(bf16* as, int k0) const {
    const int k = k0 + kc * 8;
    const int tap = k / g.nout;
    const int ch = k - tap * g.nout;
    const int kh = tap / g.ks;
    const int kw = tap - kh * g.ks;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int oh = rih[i] + g.pad - kh;
      int ow = riw[i] + g.pad - kw;
      bool ok = rok[i] && oh >= 0 && ow >= 0;
      if (g.stride == 2) {
        ok = ok && (oh & 1) == 0 && (ow & 1) == 0;
        oh >>= 1;
        ow >>= 1;
      }
      ok = ok && oh < g.ho && ow < g.wo;
      const size_t row =
          ok ? (static_cast<size_t>(rn[i]) * g.ho + oh) * g.wo + ow : 0;
      const int r = (threadIdx.x >> 2) + i * 64;
      *reinterpret_cast<uint4*>(as + r * kALd + kc * 8) =
          grad8(gx, row, ch, ok);
    }
  }
};

// Main loop of the forward and dgrad GEMMs: A through its loader, B = a
// weight [k_total, nout] row-major through cp.async, two stages.
template <int BN, class ALoader>
__device__ void mainloop_w(Smem<BN>& sm, const ALoader& al, const bf16* w,
                           int k_total, int nout, int n0, Acc<BN>& acc) {
  using namespace nvcuda;
  using TL = Tile<BN>;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / TL::kWarpsN;
  const int wn = warp - wm * TL::kWarpsN;
#pragma unroll
  for (int i = 0; i < TL::kFM; ++i)
#pragma unroll
    for (int j = 0; j < TL::kFN; ++j) wmma::fill_fragment(acc.f[i][j], 0.0f);

  const int ktiles = k_total / kBK;
  al.load(sm.a[0], 0);
  load_w<BN>(sm.b[0], w, nout, 0, n0, k_total);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < ktiles) {
      al.load(sm.a[s ^ 1], (kt + 1) * kBK);
      load_w<BN>(sm.b[s ^ 1], w, nout, (kt + 1) * kBK, n0, k_total);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[TL::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfr[TL::kFN];
#pragma unroll
      for (int i = 0; i < TL::kFM; ++i)
        wmma::load_matrix_sync(
            af[i], sm.a[s] + (wm * TL::kWM + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < TL::kFN; ++j)
        wmma::load_matrix_sync(
            bfr[j], sm.b[s] + kk * TL::kBLd + wn * TL::kWN + j * 16, TL::kBLd);
#pragma unroll
      for (int i = 0; i < TL::kFM; ++i)
#pragma unroll
        for (int j = 0; j < TL::kFN; ++j)
          wmma::mma_sync(acc.f[i][j], af[i], bfr[j], acc.f[i][j]);
    }
    __syncthreads();
  }
}

// Hand every lane 8 consecutive accumulator columns of one tile row:
// fn(tile_row, tile_col, v[8]). All 32 lanes of each warp call fn
// together, so fn may use warp shuffles.
template <int BN, class Fn>
__device__ void epilogue(float* epi_warp, Acc<BN>& acc, Fn&& fn) {
  using TL = Tile<BN>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / TL::kWarpsN;
  const int wn = warp - wm * TL::kWarpsN;
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < TL::kFM; ++i) {
#pragma unroll
    for (int j = 0; j < TL::kFN; ++j) {
      nvcuda::wmma::store_matrix_sync(epi_warp, acc.f[i][j], 16,
                                      nvcuda::wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = epi_warp[r * 16 + c8 + e];
      fn(wm * TL::kWM + i * 16 + r, wn * TL::kWN + j * 16 + c8, v);
      __syncwarp();
    }
  }
}

// Sum a and b over the 16 lanes that hold the same 8 columns (same lane
// parity), then lanes 0 and 1 add the column sums to this warp row's
// shared slots s0/s1. A (warp row, column) slot belongs to one warp and
// its fragments are visited in a fixed order, so no atomics are needed
// and the sums are the same on every run.
__device__ __forceinline__ void moments_add(float* s0, float* s1, int col,
                                            float (&a)[8], float (&b)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      a[e] += __shfl_xor_sync(0xffffffffu, a[e], off);
      b[e] += __shfl_xor_sync(0xffffffffu, b[e], off);
    }
  }
  if ((threadIdx.x & 31) < 2) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s0[col + e] += a[e];
      s1[col + e] += b[e];
    }
  }
}

// Per-block moment slots: one row of BN columns per warp row.
template <int BN>
struct MomSlots {
  float v[Tile<BN>::kWarpsM][2][BN];

  __device__ void zero() {
    float* p = &v[0][0][0];
    for (int i = threadIdx.x; i < Tile<BN>::kWarpsM * 2 * BN; i += kThreads)
      p[i] = 0.0f;
  }

  __device__ float* s0() { return v[(threadIdx.x >> 5) / Tile<BN>::kWarpsN][0]; }
  __device__ float* s1() { return v[(threadIdx.x >> 5) / Tile<BN>::kWarpsN][1]; }

  // After a __syncthreads: this block's partial moments, summed over the
  // warp rows in order, into row blockIdx.x of part [rows][2][n].
  __device__ void store(float* part, int n, int n0) const {
    float* row = part + static_cast<size_t>(blockIdx.x) * 2 * n;
    for (int i = threadIdx.x; i < BN; i += kThreads) {
      float a = 0.0f, b = 0.0f;
      for (int r = 0; r < Tile<BN>::kWarpsM; ++r) {
        a += v[r][0][i];
        b += v[r][1][i];
      }
      row[n0 + i] = a;
      row[n + n0 + i] = b;
    }
  }
};

// out[j] = sum over rows of part[row][j], in a fixed order: thread (x, y)
// of a 32 x 8 block sums rows y, y + 8, ...; then the 8 partials in order.
__global__ void reduce_rows_kernel(const float* part, int rows, int cols,
                                   float* out) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + tx;
  float acc = 0.0f;
  if (j < cols)
    for (int r = ty; r < rows; r += 8)
      acc += part[static_cast<size_t>(r) * cols + j];
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < cols) {
    float sum = 0.0f;
    for (int y = 0; y < 8; ++y) sum += red[y][tx];
    out[j] = sum;
  }
}

inline cudaError_t reduce_rows(const float* part, int rows, int cols,
                               float* out, cudaStream_t st) {
  reduce_rows_kernel<<<(cols + 31) / 32, 256, 0, st>>>(part, rows, cols, out);
  return cudaGetLastError();
}

// out[i] = sum over slices of part[slice][i], in slice order.
__global__ void reduce_slices_kernel(const float* part, int slices,
                                     size_t n, float* out) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < slices; ++z) acc += part[z * n + i];
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// weight gradient: dW[K, N] += A^T G over a range of pixels
// ---------------------------------------------------------------------------

constexpr int kWStep = 32;       // pixels per stage
constexpr int kTLd = kBM + 8;    // smem pitch of the transposed A tile

template <int BN>
struct WSmem {
  alignas(128) bf16 a[2][kWStep * kTLd];
  alignas(128) bf16 g[2][kWStep * (BN + 8)];
  alignas(128) float epi[8][16 * 16];
};

// A tile of the weight gradient, stored [pixel][k]: 32 pixels x 128 k.
// Thread i owns chunk (i % 16) of the k range (fixed for the block) for
// pixels i / 16 and i / 16 + 16 of each stage.
struct ActT {
  ActXf a;
  ConvGeo g;
  int kc, rsub, ch, kh, kw;
  bool kok;

  __device__ void init(int k0) {
    kc = threadIdx.x & 15;
    rsub = threadIdx.x >> 4;
    const int k = k0 + kc * 8;
    kok = k < g.k;
    const int kk = kok ? k : 0;
    const int tap = kk / g.c;
    ch = kk - tap * g.c;
    kh = tap / g.ks;
    kw = tap - kh * g.ks;
  }

  __device__ void load(bf16* as, int m0, int m_end) const {
    const int plane = g.ho * g.wo;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rsub + 16 * i;
      const int mm = m0 + r;
      bool ok = kok && mm < m_end;
      const int q = ok ? mm : 0;
      const int nn = q / plane;
      const int rem = q - nn * plane;
      const int oh = rem / g.wo;
      const int ow = rem - oh * g.wo;
      const int ih = oh * g.stride - g.pad + kh;
      const int iw = ow * g.stride - g.pad + kw;
      ok = ok && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      *reinterpret_cast<uint4*>(as + r * kTLd + kc * 8) =
          act8(a, g, nn, ih, iw, ch, ok);
    }
  }
};

// G tile of the weight gradient: 32 pixels x BN columns from n0.
template <int BN>
struct GradT {
  GradXf gx;
  int n0;

  __device__ void init(int n0_) { n0 = n0_; }

  __device__ void load(bf16* gs, int m0, int m_end) const {
    constexpr int kCpr = BN / 8;
    for (int q = threadIdx.x; q < kWStep * kCpr; q += kThreads) {
      const int r = q / kCpr;
      const int cc = q - r * kCpr;
      const int mm = m0 + r;
      const bool ok = mm < m_end;
      *reinterpret_cast<uint4*>(gs + r * (BN + 8) + cc * 8) =
          grad8(gx, ok ? static_cast<size_t>(mm) : 0, n0 + cc * 8, ok);
    }
  }
};

// One 128 x BN tile of dW over pixels [m_begin, m_end); grid (k tiles,
// n tiles, pixel splits); split z stores its float32 partial sums into
// slice z of dw [splits][k_total][nout] (no atomics: the caller sums the
// slices in order).
template <int BN, class AL, class GL>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(AL al, GL gl, int chunk, int m_total, int k_total, int nout,
                 float* dw) {
  using namespace nvcuda;
  using TL = Tile<BN>;
  __shared__ WSmem<BN> sm;
  const int k0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(m_total, m_begin + chunk);
  if (m_begin >= m_end) return;
  al.init(k0);
  gl.init(n0);
  const int warp = threadIdx.x >> 5;
  const int wm = warp / TL::kWarpsN;
  const int wn = warp - wm * TL::kWarpsN;
  Acc<BN> acc;
#pragma unroll
  for (int i = 0; i < TL::kFM; ++i)
#pragma unroll
    for (int j = 0; j < TL::kFN; ++j) wmma::fill_fragment(acc.f[i][j], 0.0f);

  const int steps = (m_end - m_begin + kWStep - 1) / kWStep;
  al.load(sm.a[0], m_begin, m_end);
  gl.load(sm.g[0], m_begin, m_end);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      al.load(sm.a[buf ^ 1], m_begin + (s + 1) * kWStep, m_end);
      gl.load(sm.g[buf ^ 1], m_begin + (s + 1) * kWStep, m_end);
    }
#pragma unroll
    for (int kk = 0; kk < kWStep; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
          af[TL::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfr[TL::kFN];
#pragma unroll
      for (int i = 0; i < TL::kFM; ++i)
        wmma::load_matrix_sync(
            af[i], sm.a[buf] + kk * kTLd + wm * TL::kWM + i * 16, kTLd);
#pragma unroll
      for (int j = 0; j < TL::kFN; ++j)
        wmma::load_matrix_sync(
            bfr[j], sm.g[buf] + kk * (BN + 8) + wn * TL::kWN + j * 16, BN + 8);
#pragma unroll
      for (int i = 0; i < TL::kFM; ++i)
#pragma unroll
        for (int j = 0; j < TL::kFN; ++j)
          wmma::mma_sync(acc.f[i][j], af[i], bfr[j], acc.f[i][j]);
    }
    __syncthreads();
  }
  epilogue<BN>(sm.epi[warp], acc, [&](int r, int c, float(&v)[8]) {
    const int k = k0 + r;
    if (k < k_total) {
      float* dst = dw + static_cast<size_t>(blockIdx.z) * k_total * nout +
                   static_cast<size_t>(k) * nout + n0 + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = v[e];
    }
  });
}

// Grid of the weight gradient: enough pixel splits to give the card a few
// waves of blocks, each split at least 256 pixels.
inline dim3 wgrad_grid(int k_total, int nout, int bn, int m_total,
                       int* chunk) {
  const int kt = (k_total + kBM - 1) / kBM;
  const int nt = nout / bn;
  int z = (4 * 132) / (kt * nt);
  z = z < 1 ? 1 : z;
  const int most = (m_total + 255) / 256;
  z = z > most ? most : z;
  int c = (m_total + z - 1) / z;
  c = (c + kWStep - 1) / kWStep * kWStep;
  *chunk = c;
  return dim3(kt, nt, (m_total + c - 1) / c);
}

// ---------------------------------------------------------------------------
// BatchNorm vectors between the GEMMs (tiny, one thread per channel)
// ---------------------------------------------------------------------------

// mom [2, n] = (sum, sum of squares) over count pixels -> mu, biased var,
// and the affine sa * v + sb that the next loader applies.
__global__ void bn_stats_kernel(const float* mom, int n, float count,
                                const float* gamma, const float* beta,
                                float eps, float* mu, float* var, float* sa,
                                float* sb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float m = mom[i] / count;
  const float v = mom[n + i] / count - m * m;
  const float a = gamma[i] * rsqrtf(v + eps);
  mu[i] = m;
  var[i] = v;
  sa[i] = a;
  sb[i] = beta[i] - m * a;
}

// BN backward from s0 = sum(da), s1 = sum(da * (v - mu)) (centred):
// dv = A * da + E * v + F, dgamma = r * s1, dbeta = s0.
__global__ void bn_bwd_kernel(const float* s0, const float* s1, int n,
                              float count, const float* gamma,
                              const float* mu, const float* var, float eps,
                              float* va, float* ve, float* vf, float* dgamma,
                              float* dbeta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float r = rsqrtf(var[i] + eps);
  const float a = gamma[i] * r;
  const float t0 = s0[i] / count;
  const float t1 = r * s1[i] / count;
  va[i] = a;
  ve[i] = -a * t1 * r;
  vf[i] = -a * t0 + a * t1 * r * mu[i];
  dgamma[i] = r * s1[i];
  dbeta[i] = s0[i];
}

}  // namespace vcg
