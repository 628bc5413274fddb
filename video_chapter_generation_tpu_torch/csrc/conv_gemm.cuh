// The constants and cp.async helpers that hopper_gemm.cuh's kernels (the
// stems, K2-K5, K9, K11-K15) build on.
//
// A convolution over an NHWC bf16 activation is a matrix product
// out[M, Nout] = A[M, K] x W[K, Nout] with M = output pixels and
// K = kh * kw * Cin ordered (kh, kw, c): the row order of an HWIO weight
// reshaped to [K, Nout]. A is never materialised: each tile of A is
// gathered straight from the activation into shared memory by the
// caller's operand source, which also applies the zero padding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vcg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // output rows per block tile
constexpr int kThreads = 256;  // eight warps

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

}  // namespace vcg
