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
// The operands carry what the TPU kernels apply in VMEM: the temporal
// shift or the previous BN + ReLU (relu(sa * v + sb)) on an activation,
// and the BN backward (ga * da + ge * v + gf) on a gradient, so none of
// those intermediates is written to device memory. Epilogues
// take the per-channel batch moments of what they store (forward: sum and
// sum of squares of the bf16-rounded output; dgrad: sum of da and the
// centred sum of da * (v - mu)) with a warp reduction into per-warp-row
// shared slots and one row of partial sums per block; a second small
// kernel sums the rows in a fixed order. No float atomics anywhere: the
// statistics, and so every bf16 rounding downstream of them, are the
// same on every run (batch-stat BN at initialization amplifies a last-bit
// difference in a statistic into a visible difference 16 blocks later).
//
// K12 (conv_train.cu) and K11 (stem_train.cu) run their GEMMs on
// hopper_gemm.cuh's wgmma mainloop and take from here the operand
// descriptions, the finale, the moment slots and the reduction and
// BN-vector kernels.
#pragma once

#include "conv_gemm.cuh"

namespace vcg {

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

// 8 floats of a per-channel vector from p (16-byte aligned: every vector
// the entries pass starts a multiple of 64 floats into its buffer).
__device__ __forceinline__ void vec8(const float* p, float (&o)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
  o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
}

// A bottleneck's finale on 8 channels from ch: relu(bf16(sa3 * p + sb3)
// + r'), r' = r (identity residual) or bf16(sap * r + sbp) (projection,
// sap != null); the rounding of every step is part of the contract (the
// trunk's link must give what the standalone finale gives, bit for bit).
__device__ __forceinline__ uint4 finale8(uint4 praw, uint4 rraw,
                                         const float* sa3, const float* sb3,
                                         const float* sap, const float* sbp,
                                         int ch) {
  float pv[8], rv[8], out[8], a[8], b[8], ap[8], bp[8];
  unpack8(praw, pv);
  unpack8(rraw, rv);
  vec8(sa3 + ch, a);
  vec8(sb3 + ch, b);
  if (sap != nullptr) {
    vec8(sap + ch, ap);
    vec8(sbp + ch, bp);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float a3 =
        __bfloat162float(__float2bfloat16_rn(fmaf(pv[e], a[e], b[e])));
    const float rr = sap == nullptr ? rv[e]
                                    : __bfloat162float(__float2bfloat16_rn(
                                          fmaf(rv[e], ap[e], bp[e])));
    out[e] = fmaxf(a3 + rr, 0.0f);
  }
  return pack8(out);
}

// The trunk's forward link (tsm_trunk_train_pallas.py: _fk1 with prev):
// the A operand of block N's conv1 is shift(x) with x = block N-1's
// finale of (p, r); x itself is written to x_out once (conv_train.cu's
// LinkPart).
struct LinkXf {
  const bf16* p;
  const bf16* r;
  const float* sa3;
  const float* sb3;
  const float* sap;  // null: block N-1 has an identity residual
  const float* sbp;
  bf16* x_out;
  int t, fold;
};

// Per-block moment slots: R rows of BN columns per warp row; WR warp rows
// (8 for hopper_gemm.cuh's tiles, where every warp owns 16 rows of all BN
// columns).
template <int BN, int R, int WR>
struct MomSlots {
  float v[WR][R][BN];

  __device__ void zero() {
    float* p = &v[0][0][0];
    for (int i = threadIdx.x; i < WR * R * BN; i += kThreads) p[i] = 0.0f;
  }

  __device__ float* slot(int r) {
    return v[(threadIdx.x >> 5) / (8 / WR)][r];
  }
  __device__ float* s0() { return slot(0); }
  __device__ float* s1() { return slot(1); }

  // After a __syncthreads: this block's partial moments, summed over the
  // warp rows in order, into row `at` (default blockIdx.x) of part
  // [rows][nrows][n] (the first nrows <= R slots).
  __device__ void store(float* part, int n, int n0, int nrows = R,
                        int at = -1) const {
    float* row = part + static_cast<size_t>(at < 0 ? blockIdx.x : at) *
                            nrows * n;
    for (int i = threadIdx.x; i < nrows * BN; i += kThreads) {
      const int k = i / BN;
      const int j = i - k * BN;
      float a = 0.0f;
      for (int r = 0; r < WR; ++r) a += v[r][k][j];
      row[k * n + n0 + j] = a;
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
// BatchNorm vectors between the GEMMs (tiny, one thread per channel)
// ---------------------------------------------------------------------------

// The BatchNorm statistics of channel i from its moments (sum m0, sum
// of squares m1) over count pixels -> mu, biased var, and the affine
// sa * v + sb that the next loader applies.
__device__ __forceinline__ void bn_stats_at(int i, float m0, float m1,
                                            float count, const float* gamma,
                                            const float* beta, float eps,
                                            float* mu, float* var, float* sa,
                                            float* sb) {
  const float m = m0 / count;
  const float v = m1 / count - m * m;
  const float a = gamma[i] * rsqrtf(v + eps);
  mu[i] = m;
  var[i] = v;
  sa[i] = a;
  sb[i] = beta[i] - m * a;
}

// mom [2, n] = (sum, sum of squares) over count pixels -> bn_stats_at.
__global__ void bn_stats_kernel(const float* mom, int n, float count,
                                const float* gamma, const float* beta,
                                float eps, float* mu, float* var, float* sa,
                                float* sb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn_stats_at(i, mom[i], mom[n + i], count, gamma, beta, eps, mu, var, sa,
              sb);
}

// BN backward of channel i from s0 = sum(da), s1 = sum(da * (v - mu))
// (centred) over count pixels: dv = A * da + E * v + F, dgamma = r * s1,
// dbeta = s0.
__device__ __forceinline__ void bn_bwd_at(int i, float s0, float s1,
                                          float count, const float* gamma,
                                          const float* mu, const float* var,
                                          float eps, float* va, float* ve,
                                          float* vf, float* dgamma,
                                          float* dbeta) {
  const float r = rsqrtf(var[i] + eps);
  const float a = gamma[i] * r;
  const float t0 = s0 / count;
  const float t1 = r * s1 / count;
  va[i] = a;
  ve[i] = -a * t1 * r;
  vf[i] = -a * t0 + a * t1 * r * mu[i];
  dgamma[i] = r * s1;
  dbeta[i] = s0;
}

__global__ void bn_bwd_kernel(const float* s0, const float* s1, int n,
                              float count, const float* gamma,
                              const float* mu, const float* var, float eps,
                              float* va, float* ve, float* vf, float* dgamma,
                              float* dbeta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bn_bwd_at(i, s0[i], s1[i], count, gamma, mu, var, eps, va, ve, vf, dgamma,
            dbeta);
}

}  // namespace vcg
