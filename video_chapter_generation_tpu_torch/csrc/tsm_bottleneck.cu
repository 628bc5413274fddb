// Inference TSM bottleneck for Hopper (sm_90a), stride 1 and stride 2.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_pallas.py:
//   tsm_bottleneck_pallas (_kernel, _kernel_flat)             -> stride 1
//   tsm_bottleneck_s2_pallas / _s2_planar_pallas (_kernel_s2,
//   _kernel_s2_planar)                                        -> stride 2
// The planar input of the TPU kernel is a row-major view of NHWC, so one
// stride-2 entry reading NHWC serves both.
//
//   y1  = relu(bn1(conv1x1(shift(x))))        shift folded into the A load
//   y2  = relu(bn2(conv3x3(y1, stride)))
//   res = x, or bn_p(conv1x1(x, stride))      projection on the unshifted x
//   out = relu(bn3(conv1x1(y2)) + res)
//
// What bounds it on the H100: the products. At the main-path shapes the
// block does 2 * M * (C*F + 9*F*F + F*4F [+ C*4F]) flops against a few
// bytes per flop, far above the card's ridge point, so it wants tensor
// cores kept busy. This first version is three launches of one implicit-
// GEMM kernel (conv_gemm.cuh): conv1 and the projection share the first
// launch as two jobs, y1 and y2 round-trip device memory as bf16, and the
// W tiles stream in two cp.async stages. WMMA (mma.sync) rather than
// wgmma/TMA, and the on-chip y1/y2 of the TPU kernel, are left for later.
#include <algorithm>

#include "conv_gemm.cuh"

namespace vcg {

template <int BN>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(ConvJob j0, ConvJob j1) {
  const ConvJob j = blockIdx.z == 0 ? j0 : j1;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  if (m0 >= j.m || n0 >= j.nout) return;
  __shared__ Smem<BN> sm;
  ConvA al;
  al.init(j, m0);
  conv_gemm_tile<BN>(sm, al, j.wt, j.k, j.nout, m0, n0, j.m, j.scale, j.bias,
                     j.res, j.out, j.relu != 0);
}

// Launch one or two independent convolutions as one grid (z = job).
static cudaError_t launch_jobs(const ConvJob* jobs, int njobs,
                               cudaStream_t stream) {
  int mt = 0, nt = 0;
  bool wide = true;
  for (int i = 0; i < njobs; ++i) {
    mt = std::max(mt, (jobs[i].m + kBM - 1) / kBM);
    wide = wide && jobs[i].nout % 128 == 0;
  }
  const int bn = wide ? 128 : 64;
  for (int i = 0; i < njobs; ++i) nt = std::max(nt, jobs[i].nout / bn);
  const dim3 grid(mt, nt, njobs);
  const ConvJob second = njobs > 1 ? jobs[1] : jobs[0];
  if (wide)
    conv_kernel<128><<<grid, kThreads, 0, stream>>>(jobs[0], second);
  else
    conv_kernel<64><<<grid, kThreads, 0, stream>>>(jobs[0], second);
  return cudaGetLastError();
}

static ConvJob make_job(const void* x, const void* w, const void* scale,
                        const void* bias, const void* res, void* out, int n,
                        int h, int wd, int c, int ks, int stride, int pad,
                        int t, int fold, int nout, int relu) {
  ConvJob j;
  j.x = static_cast<const bf16*>(x);
  j.wt = static_cast<const bf16*>(w);
  j.scale = static_cast<const float*>(scale);
  j.bias = static_cast<const float*>(bias);
  j.res = static_cast<const bf16*>(res);
  j.out = static_cast<bf16*>(out);
  j.n = n; j.h = h; j.w = wd; j.c = c;
  j.ho = (h + 2 * pad - ks) / stride + 1;
  j.wo = (wd + 2 * pad - ks) / stride + 1;
  j.ks = ks; j.stride = stride; j.pad = pad;
  j.t = t; j.fold = fold; j.nout = nout; j.relu = relu;
  j.m = n * j.ho * j.wo;
  j.k = ks * ks * c;
  return j;
}

static int run_bottleneck(const void* x, const void* w1, const void* w2,
                          const void* w3, const void* wp, const void* s1,
                          const void* b1, const void* s2, const void* b2,
                          const void* s3, const void* b3, const void* sp,
                          const void* bp, void* y1, void* y2, void* r,
                          void* out, int n, int h, int w, int c, int f,
                          int cout, int stride, int t, int fold,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ho = (h - 1) / stride + 1;
  const int wo = (w - 1) / stride + 1;
  ConvJob first[2];
  first[0] = make_job(x, w1, s1, b1, nullptr, y1, n, h, w, c, 1, 1, 0, t,
                      fold, f, 1);
  int nfirst = 1;
  if (wp != nullptr) {
    first[1] = make_job(x, wp, sp, bp, nullptr, r, n, h, w, c, 1, stride, 0,
                        t, 0, cout, 0);
    nfirst = 2;
  }
  cudaError_t e = launch_jobs(first, nfirst, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ConvJob conv2 = make_job(y1, w2, s2, b2, nullptr, y2, n, h, w, f, 3, stride,
                           1, t, 0, f, 1);
  e = launch_jobs(&conv2, 1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ConvJob conv3 = make_job(y2, w3, s3, b3, wp != nullptr ? r : x, out, n, ho,
                           wo, f, 1, 1, 0, t, 0, cout, 1);
  return static_cast<int>(launch_jobs(&conv3, 1, st));
}

}  // namespace vcg

extern "C" int vcg_tsm_bottleneck_s1(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* wp, const void* s1, const void* b1, const void* s2,
    const void* b2, const void* s3, const void* b3, const void* sp,
    const void* bp, void* y1, void* y2, void* r, void* out, int n, int h,
    int w, int c, int f, int cout, int t, int fold, void* stream) {
  return vcg::run_bottleneck(x, w1, w2, w3, wp, s1, b1, s2, b2, s3, b3, sp,
                             bp, y1, y2, r, out, n, h, w, c, f, cout, 1, t,
                             fold, stream);
}

extern "C" int vcg_tsm_bottleneck_s2(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* wp, const void* s1, const void* b1, const void* s2,
    const void* b2, const void* s3, const void* b3, const void* sp,
    const void* bp, void* y1, void* y2, void* r, void* out, int n, int h,
    int w, int c, int f, int cout, int t, int fold, void* stream) {
  return vcg::run_bottleneck(x, w1, w2, w3, wp, s1, b1, s2, b2, s3, b3, sp,
                             bp, y1, y2, r, out, n, h, w, c, f, cout, 2, t,
                             fold, stream);
}
