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
// reads other frames), so they are ordered by a barrier over the grid:
// one cooperative launch (cudaLaunchCooperativeKernel) of one block an
// SM, each phase a persistent walk over its tiles as the per-block
// kernels' grids walk them. Its barrier is written here (a counter and a
// generation word in device memory, zeroed by the wrapper):
// cooperative_groups' grid sync is not used, since the kernels are
// compiled one file at a time without -rdc. The launch guarantees that
// every block is resident, so the barrier cannot wait on a block that
// has not started; a wait that outlasts ~10 s traps instead of hanging.
// Around the barrier each thread fences its global writes to the async
// proxy, since the next phase reads them by TMA.
//
// Arithmetic. The phases run the tiles of the per-block launches
// (tsm_tiles.cuh): conv1 K5's shift_tiles, conv2 and conv3 (the block's
// input as the residual) conv_tiles, with the same tile width rules
// (shift_bn, conv_bn over the card's SMs), so each output tile is the
// same sequence of wgmmas and the same epilogue on the same inputs: the
// chain equals the per-block K2/K3 sequence bit for bit. Every operand
// arrives by TMA, as there: the tensor maps of the chain's activations and
// of every block's weights (at most 77, ~10 KB) travel in one
// __grid_constant__ kernel parameter. y1 and y2 go to scratch, the block
// outputs ping-pong between two scratch activations, and the last block
// writes the output; all of it allocated by the wrapper.
//
// What bounds it on the H100: what bounds K2/K3 (bytes at layer 1, the
// products at layers 3-4). What the one launch saves is 3k - 1 kernel
// launches and their tails; the barrier costs a round trip to L2 per
// phase, and each phase's last wave runs alone. Keeping a tile's chain on
// chip is not possible here (a 3x3 needs its neighbours' rows from the
// phase before).
#include <algorithm>
#include <initializer_list>

#include "tsm_tiles.cuh"

namespace vcg {

using namespace hop;

constexpr int kMaxChain = 24;  // ResNet-101's layer3 chains 22 blocks

struct ChainParams {
  const bf16* x;      // [n, h, w, c] the chain's input
  bf16* out;          // [n, h, w, c] the last block's output
  bf16* y1;           // [n*h*w, f] scratch
  bf16* y2;           // [n*h*w, f] scratch
  bf16* buf[2];       // [n, h, w, c] scratch: block outputs, ping-pong
  unsigned* bar;      // [2] zeroed: arrival count, generation
  int nblk, n, h, w, c, f, t, fold;
  int bn1, bn2, bn3;  // tile widths of conv1, conv2, conv3
  const float* vec[kMaxChain][6];  // s1, b1, s2, b2 [f]; s3, b3 [c]
};

// x, buf0, buf1 as [n h w][c] and y1, y2 as [n h w][f] (boxes 128 x 64);
// per block w1 [c][f], w2 [9 f][f], w3 [f][c] (boxes 64 x 64)
enum { kMapX = 0, kMapY1 = 3, kMapY2 = 4, kActMaps = 5 };

struct ChainMaps {
  CUtensorMap act[kActMaps];
  CUtensorMap w[kMaxChain][3];
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// All blocks of the grid meet here; what any of them wrote before is
// visible to all after, to plain loads and to TMA.
__device__ void grid_barrier(unsigned* bar) {
  fence_async_global();
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
  fence_async_global();
}

template <int BN>
__device__ void conv1_phase(uint8_t* sm, uint64_t* bars,
                            const ChainParams& p, const bf16* in,
                            const CUtensorMap* xmap, const CUtensorMap* wmap,
                            const float* s, const float* b) {
  const int m = p.n * p.h * p.w;
  ShiftSrc<BN> src = shift_src<BN>(in, m, p.h * p.w, p.c, p.f, p.t, p.fold);
  src.xmap = xmap;
  src.wmap = wmap;
  shift_tiles<BN>(sm, bars, src, ScaleBias{s, b, 1}, p.y1,
                  (m + kBM - 1) / kBM * src.ntn);
}

// conv2 (3x3 over y1 into y2) or, with kRes, conv3 (1x1 over y2 plus the
// residual res into out)
template <int BN, bool kRes>
__device__ void conv_phase(uint8_t* sm, uint64_t* bars, const ChainParams& p,
                           const bf16* a, const CUtensorMap* amap,
                           const CUtensorMap* wmap, const CUtensorMap* rmap,
                           const float* s, const float* b, bf16* out) {
  const int nout = kRes ? p.c : p.f;
  ConvSrc<BN, kRes> src =
      conv_src<BN, kRes>(a, p.n, p.h, p.w, p.f, kRes ? 1 : 3, 1, nout);
  src.xmap = amap;
  src.wmap = wmap;
  src.rmap = rmap;
  conv_tiles<BN, kRes>(sm, bars, src, ScaleBias{s, b, 1}, out,
                       (src.m + kBM - 1) / kBM * src.ntn);
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_kernel(const __grid_constant__ ChainParams p,
                 const __grid_constant__ ChainMaps maps) {
  __shared__ alignas(8) uint64_t bars[kMaxStages];
  uint8_t* sm = aligned_smem();
  for (int b = 0; b < p.nblk; ++b) {
    const int in = b == 0 ? kMapX : 1 + ((b - 1) & 1);
    const bf16* x = b == 0 ? p.x : p.buf[(b - 1) & 1];
    bf16* out = b == p.nblk - 1 ? p.out : p.buf[b & 1];
    const float* const* v = p.vec[b];
    const CUtensorMap* w = maps.w[b];
    if (p.bn1 == 256)
      conv1_phase<256>(sm, bars, p, x, &maps.act[in], &w[0], v[0], v[1]);
    else if (p.bn1 == 128)
      conv1_phase<128>(sm, bars, p, x, &maps.act[in], &w[0], v[0], v[1]);
    else
      conv1_phase<64>(sm, bars, p, x, &maps.act[in], &w[0], v[0], v[1]);
    grid_barrier(p.bar);
    if (p.bn2 == 256)
      conv_phase<256, false>(sm, bars, p, p.y1, &maps.act[kMapY1], &w[1],
                             nullptr, v[2], v[3], p.y2);
    else if (p.bn2 == 128)
      conv_phase<128, false>(sm, bars, p, p.y1, &maps.act[kMapY1], &w[1],
                             nullptr, v[2], v[3], p.y2);
    else
      conv_phase<64, false>(sm, bars, p, p.y1, &maps.act[kMapY1], &w[1],
                            nullptr, v[2], v[3], p.y2);
    grid_barrier(p.bar);
    if (p.bn3 == 128)
      conv_phase<128, true>(sm, bars, p, p.y2, &maps.act[kMapY2], &w[2],
                            &maps.act[in], v[4], v[5], out);
    else
      conv_phase<64, true>(sm, bars, p, p.y2, &maps.act[kMapY2], &w[2],
                           &maps.act[in], v[4], v[5], out);
    if (b + 1 < p.nblk) grid_barrier(p.bar);
  }
}

constexpr int kChainSmem = std::max(
    {shift_smem<256>(), shift_smem<128>(), shift_smem<64>(),
     conv_smem<256, false>(), conv_smem<128, false>(), conv_smem<64, false>(),
     conv_smem<128, true>(), conv_smem<64, true>()});

}  // namespace vcg

// x, out [n, h, w, c] bf16 (n = clips * t, frames time-major per clip);
// per block b (nblk of them, at most 24) w1[b] [c, f], w2[b] [3, 3, f, f],
// w3[b] [f, c] bf16 and s1/b1/s2/b2 [f], s3/b3 [c] f32 (8-byte aligned),
// passed as arrays of device pointers on the host; y1, y2 [n*h*w, f],
// buf0, buf1 [n, h, w, c] bf16 scratch (buf0 used from 2 blocks, buf1
// from 3); bar [2] u32 zeroed. Needs c % 64 == 0, f % 64 == 0, fold % 8
// == 0. One cooperative launch.
extern "C" int vcg_tsm_bottleneck_chain(
    const void* x, const void* const* w1, const void* const* w2,
    const void* const* w3, const void* const* s1, const void* const* b1,
    const void* const* s2, const void* const* b2, const void* const* s3,
    const void* const* b3, void* y1, void* y2, void* buf0, void* buf1,
    void* bar, void* out, int nblk, int n, int h, int w, int c, int f, int t,
    int fold, void* stream) {
  using namespace vcg;
  if (nblk < 1 || nblk > kMaxChain)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainParams p{};
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.y1 = static_cast<bf16*>(y1);
  p.y2 = static_cast<bf16*>(y2);
  p.buf[0] = static_cast<bf16*>(buf0);
  p.buf[1] = static_cast<bf16*>(buf1);
  p.bar = static_cast<unsigned*>(bar);
  p.nblk = nblk; p.n = n; p.h = h; p.w = w; p.c = c; p.f = f; p.t = t;
  p.fold = fold;
  const void* const* vecs[6] = {s1, b1, s2, b2, s3, b3};
  for (int b = 0; b < nblk; ++b)
    for (int i = 0; i < 6; ++i)
      p.vec[b][i] = static_cast<const float*>(vecs[i][b]);
  const int m = n * h * w;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.bn1 = shift_bn(f);
  p.bn2 = conv_bn(m, f, sms, false);
  p.bn3 = conv_bn(m, c, sms, true);
  ChainMaps maps{};
  const void* acts[kActMaps] = {x, buf0, buf1, y1, y2};
  for (int i = 0; i < kActMaps && e == cudaSuccess; ++i)
    if (acts[i] != nullptr)
      e = tensor_map(&maps.act[i], acts[i], m, i < kMapY1 ? c : f, kBM);
  for (int b = 0; b < nblk && e == cudaSuccess; ++b) {
    e = tensor_map(&maps.w[b][0], w1[b], c, f, kHBK);
    if (e == cudaSuccess) e = tensor_map(&maps.w[b][1], w2[b], 9 * f, f, kHBK);
    if (e == cudaSuccess) e = tensor_map(&maps.w[b][2], w3[b], f, c, kHBK);
  }
  int held = 0;
  if (e == cudaSuccess) e = resident<chain_kernel>(kChainSmem, &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (held < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  // enough blocks for the widest phase, at most what fits at once
  const int mt = (m + kBM - 1) / kBM;
  const int most = mt * std::max({f / p.bn1, f / p.bn2, c / p.bn3});
  const int grid = std::max(1, std::min(held, most));
  void* args[] = {&p, &maps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(chain_kernel), dim3(grid), dim3(kThreads), args,
      kChainSmem, static_cast<cudaStream_t>(stream)));
}
