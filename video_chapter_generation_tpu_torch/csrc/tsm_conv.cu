// Temporal shift + 1x1 convolution (K5) for Hopper (sm_90a).
//
// Replaces video_chapter_generation_tpu/ops/tsm_conv_pallas.py:
//   tsm_conv1x1_bn_relu_pallas (inference, folded BN + ReLU epilogue)
//   tsm_conv1x1_pallas          (training forward, no epilogue)
//
//   y = act(shift(x) @ W * scale + bias)     x [N*T, H, W, C], W [C, F]
//
// The TPU kernel picks between a base-plus-correction product and three
// sliced products by the 128-lane alignment of the shift fold; both exist
// for the MXU only. Here the shift costs nothing: it is one ks = 1,
// stride 1 job of the implicit-GEMM core (conv_gemm.cuh), whose A loader
// reads fold 0 from frame t + 1 and fold 1 from frame t - 1 (zero at the
// clip ends) as it gathers each A tile, so the shifted tensor is never
// written. Products accumulate in fp32 and round once to bf16 after the
// epilogue; the training entry passes a unit scale and a zero bias (exact
// in fp32), so it stores the bare product.
//
// What bounds it on the H100: at C, F <= 2048 the product does 2 F flops
// per 2 bytes of x read, below the card's ridge point for F < ~300, so
// the early layers are bound by bytes and the late ones by the tensor
// cores. This first version is the WMMA core as it is (two cp.async
// stages, no TMA or wgmma).
#include "conv_gemm.cuh"

namespace vcg {

template <int BN>
__global__ void __launch_bounds__(kThreads) tsm_conv1x1_kernel(ConvJob j) {
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  __shared__ Smem<BN> sm;
  ConvA al;
  al.init(j, m0);
  conv_gemm_tile<BN>(sm, al, j.wt, j.k, j.nout, m0, n0, j.m, j.scale, j.bias,
                     nullptr, j.out, j.relu != 0);
}

}  // namespace vcg

// x [n, h, w, c] bf16 (n = clips * t, frames time-major), w [c, f] bf16,
// scale/bias [f] float32, out [n, h, w, f] bf16. c % 32 == 0, f % 64 ==
// 0 and fold % 8 == 0 (fold 0: no shift); the caller checks.
extern "C" int vcg_tsm_conv1x1(const void* x, const void* w,
                               const void* scale, const void* bias, void* out,
                               int n, int h, int wd, int c, int f, int t,
                               int fold, int relu, void* stream) {
  using namespace vcg;
  ConvJob j;
  j.x = static_cast<const bf16*>(x);
  j.wt = static_cast<const bf16*>(w);
  j.scale = static_cast<const float*>(scale);
  j.bias = static_cast<const float*>(bias);
  j.res = nullptr;
  j.out = static_cast<bf16*>(out);
  j.n = n; j.h = h; j.w = wd; j.c = c;
  j.ho = h; j.wo = wd;
  j.ks = 1; j.stride = 1; j.pad = 0;
  j.t = t; j.fold = fold; j.nout = f; j.relu = relu;
  j.m = n * h * wd;
  j.k = c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned mt = static_cast<unsigned>((j.m + kBM - 1) / kBM);
  if (f % 128 == 0)
    tsm_conv1x1_kernel<128><<<dim3(mt, f / 128), kThreads, 0, st>>>(j);
  else
    tsm_conv1x1_kernel<64><<<dim3(mt, f / 64), kThreads, 0, st>>>(j);
  return static_cast<int>(cudaGetLastError());
}
