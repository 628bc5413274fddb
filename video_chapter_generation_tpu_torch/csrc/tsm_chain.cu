// A chain of consecutive stride-1 plain TSM bottlenecks in one launch, for
// Hopper (sm_90a): kernel K15.
//
// Replaces video_chapter_generation_tpu/ops/tsm_block_pallas.py:
//   tsm_bottleneck_chain_pallas (_kernel_flat_chain)        :868
//   tsm_bottleneck_halo_chain_pallas (_kernel_halo_chain)   :978
// Both compute, for blocks 1..k of a stage, block after block,
//   y1  = relu(bn1(conv1x1(shift(v))))
//   y2  = relu(bn2(conv3x3(y1)))
//   v   = relu(bn3(conv1x1(y2)) + v)
// The TPU kernels keep the chain's intermediates in VMEM; the halo form
// tiles rows with k halo rows a side, and the sub-chain split of the flat
// form guards a VMEM estimate. None of that is carried over: one launch
// serves both entries (ops/tsm_block.py).
//
// Design. The 3k conv phases of a chain depend on each other through
// whole images (a 3x3 reads the rows of its neighbours' tiles, a shift
// reads other frames), so they are ordered by a barrier over the grid.
// Two ways were open: one thread-block cluster per 16-frame clip with
// cluster.sync() between phases (clips are independent), or one
// cooperative launch with a grid barrier. A cluster holds at most 8
// portable blocks, so 16 clips would run on 128 blocks, one per SM, with
// a conv phase of layer 1 (50,176 pixels a clip) walking 49 tiles per
// block. The cooperative launch (cudaLaunchCooperativeKernel) runs
// SMs x occupancy blocks over every tile of a phase, as the per-block
// kernels' own grids do, so it is the one taken. Its barrier is written
// here (a counter and a generation word in device memory, zeroed by the
// wrapper): cooperative_groups' grid sync is not used, since the kernels
// are compiled one file at a time without -rdc. The launch guarantees
// that every block is resident, so the barrier cannot wait on a block that
// has not started; a wait that outlasts ~10 s traps instead of hanging.
//
// Arithmetic. Every phase is a job of conv_gemm.cuh's conv_gemm_tile, with
// the same tile width rule and the same ConvJob fields as the per-block
// kernel (tsm_bottleneck.cu run_bottleneck at stride 1), so each output
// tile is computed by the same instructions from the same inputs: the
// chain equals the per-block K2/K3 sequence bit for bit. y1 and y2 go to
// scratch, the block outputs ping-pong between two scratch activations,
// and the last block writes the output; all of it allocated by the wrapper.
//
// What bounds it on the H100: the products, as for K2/K3 (2 * M * (C*F +
// 9*F*F + F*C) flops a block at a few bytes per flop). What the one launch
// saves is 3k - 1 kernel launches and their tails; the barrier costs a
// round trip to L2 per phase. Keeping a tile's chain on chip is not
// possible here (a 3x3 needs its neighbours' rows from the phase before).
#include <algorithm>

#include "conv_gemm.cuh"

namespace vcg {

constexpr int kMaxChain = 24;  // ResNet-101's layer3 chains 22 blocks

struct ChainBlock {
  const bf16 *w1, *w2, *w3;     // [c, f], [3, 3, f, f] HWIO, [f, c]
  const float *s1, *b1, *s2, *b2, *s3, *b3;
};

struct ChainParams {
  const bf16* x;      // [n, h, w, c] the chain's input
  bf16* out;          // [n, h, w, c] the last block's output
  bf16* y1;           // [n*h*w, f] scratch
  bf16* y2;           // [n*h*w, f] scratch
  bf16* buf[2];       // [n, h, w, c] scratch: block outputs, ping-pong
  unsigned* bar;      // [2] zeroed: arrival count, generation
  int nblk, n, h, w, c, f, t, fold;
  ChainBlock blk[kMaxChain];
};

__device__ ConvJob job(const bf16* x, const bf16* w, const float* scale,
                       const float* bias, const bf16* res, bf16* out, int n,
                       int h, int wd, int c, int ks, int pad, int t, int fold,
                       int nout) {
  ConvJob j;
  j.x = x; j.wt = w; j.scale = scale; j.bias = bias; j.res = res; j.out = out;
  j.n = n; j.h = h; j.w = wd; j.c = c;
  j.ho = h; j.wo = wd;
  j.ks = ks; j.stride = 1; j.pad = pad;
  j.t = t; j.fold = fold; j.nout = nout; j.relu = 1;
  j.m = n * h * wd;
  j.k = ks * ks * c;
  return j;
}

// Phase ph = 3 b + s of block b: s 0 conv1 (shifted), 1 conv2, 2 conv3 with
// the block's input as residual; the jobs of run_bottleneck at stride 1.
__device__ ConvJob phase_job(const ChainParams& p, int ph) {
  const int b = ph / 3, s = ph - 3 * (ph / 3);
  const ChainBlock& k = p.blk[b];
  const bf16* in = b == 0 ? p.x : p.buf[(b - 1) & 1];
  if (s == 0)
    return job(in, k.w1, k.s1, k.b1, nullptr, p.y1, p.n, p.h, p.w, p.c, 1, 0,
               p.t, p.fold, p.f);
  if (s == 1)
    return job(p.y1, k.w2, k.s2, k.b2, nullptr, p.y2, p.n, p.h, p.w, p.f, 3, 1,
               p.t, 0, p.f);
  bf16* out = b == p.nblk - 1 ? p.out : p.buf[b & 1];
  return job(p.y2, k.w3, k.s3, k.b3, in, out, p.n, p.h, p.w, p.f, 1, 0, p.t,
             0, p.c);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(a)
               : "memory");
  return v;
}

// All blocks of the grid meet here; what any of them wrote before is
// visible to all after.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      long long spins = 0;
      while (ld_acquire(bar + 1) == gen) {
        __nanosleep(64);
        if (++spins > (1ll << 27)) __trap();  // a lost block: fail, not hang
      }
    }
    __threadfence();
  }
  __syncthreads();
}

union ChainSmem {
  Smem<128> wide;
  Smem<64> narrow;
};

__global__ void __launch_bounds__(kThreads) chain_kernel(ChainParams p) {
  __shared__ ChainSmem sm;
  const int phases = 3 * p.nblk;
  for (int ph = 0; ph < phases; ++ph) {
    const ConvJob j = phase_job(p, ph);
    const bool wide = j.nout % 128 == 0;  // launch_jobs' tile width rule
    const int bn = wide ? 128 : 64;
    const int mt = (j.m + kBM - 1) / kBM;
    const int tiles = mt * (j.nout / bn);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt) * kBM;
      const int n0 = (tile / mt) * bn;
      ConvA al;
      al.init(j, m0);
      if (wide)
        conv_gemm_tile<128>(sm.wide, al, j.wt, j.k, j.nout, m0, n0, j.m,
                            j.scale, j.bias, j.res, j.out, true);
      else
        conv_gemm_tile<64>(sm.narrow, al, j.wt, j.k, j.nout, m0, n0, j.m,
                           j.scale, j.bias, j.res, j.out, true);
    }
    if (ph + 1 < phases) grid_barrier(p.bar);
  }
}

}  // namespace vcg

// x, out [n, h, w, c] bf16 (n = clips * t, frames time-major per clip);
// per block b (nblk of them, at most 24) w1[b] [c, f], w2[b] [3, 3, f, f],
// w3[b] [f, c] bf16 and s1/b1/s2/b2 [f], s3/b3 [c] f32, passed as arrays of
// device pointers on the host; y1, y2 [n*h*w, f], buf0, buf1 [n, h, w, c]
// bf16 scratch (buf0 used from 2 blocks, buf1 from 3); bar [2] u32 zeroed.
// Needs c % 32 == 0, f % 64 == 0, fold % 8 == 0. One cooperative launch.
extern "C" int vcg_tsm_bottleneck_chain(
    const void* x, const void* const* w1, const void* const* w2,
    const void* const* w3, const void* const* s1, const void* const* b1,
    const void* const* s2, const void* const* b2, const void* const* s3,
    const void* const* b3, void* y1, void* y2, void* buf0, void* buf1,
    void* bar, void* out, int nblk, int n, int h, int w, int c, int f, int t,
    int fold, void* stream) {
  using vcg::bf16;
  if (nblk < 1 || nblk > vcg::kMaxChain)
    return static_cast<int>(cudaErrorInvalidValue);
  vcg::ChainParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.y1 = static_cast<bf16*>(y1);
  p.y2 = static_cast<bf16*>(y2);
  p.buf[0] = static_cast<bf16*>(buf0);
  p.buf[1] = static_cast<bf16*>(buf1);
  p.bar = static_cast<unsigned*>(bar);
  p.nblk = nblk; p.n = n; p.h = h; p.w = w; p.c = c; p.f = f; p.t = t;
  p.fold = fold;
  for (int b = 0; b < nblk; ++b) {
    vcg::ChainBlock& k = p.blk[b];
    k.w1 = static_cast<const bf16*>(w1[b]);
    k.w2 = static_cast<const bf16*>(w2[b]);
    k.w3 = static_cast<const bf16*>(w3[b]);
    k.s1 = static_cast<const float*>(s1[b]);
    k.b1 = static_cast<const float*>(b1[b]);
    k.s2 = static_cast<const float*>(s2[b]);
    k.b2 = static_cast<const float*>(b2[b]);
    k.s3 = static_cast<const float*>(s3[b]);
    k.b3 = static_cast<const float*>(b3[b]);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vcg::chain_kernel, vcg::kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // enough blocks for the widest phase, at most what fits at once
  const int m = n * h * w;
  const int mt = (m + vcg::kBM - 1) / vcg::kBM;
  const int most = mt * (std::max(c, f) / 64);
  const int grid = std::max(1, std::min(sms * per_sm, most));
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(vcg::chain_kernel),
                                  dim3(grid), dim3(vcg::kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
