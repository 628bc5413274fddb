// BigBird block-sparse attention of the middle query blocks, for Hopper
// (sm_90a).
//
// Replaces video_chapter_generation_tpu/ops/sparse_attention_pallas.py:108
// sparse_band_attention_pallas (its `_kernel`, :81-103). For query block
// qi in 1..nb-2 of one (batch, head) it attends the P key blocks of row
// qi-1 of the structured id table, [0, qi-1, qi, qi+1, nb-1, rand...]:
//
//   s   = (q . k) / sqrt(hd) + (1 - mask[key] * valid[slot]) * -10000
//   out = softmax(s) . v        (float32 scores, sums and context)
//
// with an online softmax over the parts in the table's order (running max
// and sum in float32, in log2 units: one ex2 a probability; the
// probabilities rounded to bf16 for the value product, the context
// divided by the sum and rounded once). The TPU kernel's
// scalar-prefetched id table, per-part BlockSpecs, 8-sublane penalty copy
// and head-major transposes are TPU mechanics and are not carried over.
// Three kernels; route_for picks one a shape. Two are on hopper_gemm.cuh's
// wgmma (S = Q K^T with both operands K-major 128-byte-swizzled tiles,
// O += P V with P from registers, the score accumulators rounded to bf16
// pairs, and V an MN-major tile), their copies completing on mbarriers:
//
// sparse_band_wgmma_kernel, the serving shape (bs 64, hd 64, P 8):
// a persistent block (two warpgroups, one block an SM) walks a range of
// the (batch, head, query block) rows in order, so consecutive query
// blocks of one (b, h) share their key/value blocks: the two global
// blocks stay resident for the row, the band lives in a ring of 4 slots
// (slot = block % 4) and slides, so each query block brings in one new
// band block and its r random blocks (4 loads at P 8, not 8), by TMA from
// the [B L, H hd] view of k and v onto the mbarrier of its query block,
// one query block ahead (q and the mask rows by cp.async beside them).
// The two warpgroups take the first and the second half of the parts
// (the first global and the band; the last global and the random blocks)
// with an online softmax each; a part's softmax runs while the next
// part's scores and the last part's context product are in flight. Both
// warpgroups issue the same products, unbranched (a product under a
// branch is serialized by the compiler). Then the warpgroups merge the
// two softmaxes by rows, each warp of one handing its context, row max
// and row sum through shared memory to the warp of the same rows in the
// other, which rescales both to the larger max and stores them. The
// block's ranges split the 128 (b, h) rows of 46 query blocks of the
// serving shape evenly over the 132 SMs.
//
// sparse_band_ring_kernel<BS, HDP, GH>, which takes every shape the
// wrapper takes (bs 16, 32, 48, 64; hd 16..128 in steps of 16; any P >= 5;
// any table) and is routed bs 48 hd 64 and bs 64 at hd 64, 112 and 128,
// where it is the faster: what bounds it is bytes as well. At the bs-32
// hold (B 8, L 3072, H 16, hd 64, P 8) q, k, v and the output are 201 MB
// (0.060 ms at 3.35 TB/s) against 2.6e10 useful flops (0.026 ms at 989
// TFLOP/s; 0.052 ms padded to wgmma's 64 rows). What holds a kernel of
// one-warpgroup steps far from that is the latency of each step's chain
// (the scores' product, the softmax on them, the context product), of its
// copies and of the index arithmetic around them, and what the design
// does:
//   - a persistent block of one warpgroup (three blocks an SM at hd <= 64,
//     one at 80-128) walks a range of the (batch, head, query block) rows
//     in order, so the band and the two global blocks a query block shares
//     with its neighbours, and the row's random blocks, come from L2;
//   - a tile fills wgmma's 64 rows with bs-row (query block, head) blocks:
//     64 / bs consecutive query blocks, or at hd <= 32 up to 4 heads of
//     fewer query blocks, each head's q in its own columns of the panel
//     (zero elsewhere) so that one 64-column key box serves them all; step
//     s takes part s of each query block (the online softmax runs over the
//     parts in the table's order, one a step), S as one m64n(64 or 48)
//     wgmma over the step's parts (at hd > 64 one m64nBS a part), O as one
//     m64n(64|128) product, each warp's probabilities zero outside its own
//     part's keys; every row does useful work and a tile's fixed costs are
//     shared;
//   - every part streams through a ring of slots (48 KB a 64-column panel,
//     the slots' K tiles side by side so a step's parts are one tile): its
//     key and value boxes by TMA from the four warps' lane 0 (a box costs
//     its issuing thread a few hundred cycles), its mask row by cp.async
//     from bs / 4 lanes, all onto the slot's mbarrier, refilled as a step
//     is consumed; the refill cursor walks a tile's query blocks once a
//     tile and reads the table one refill ahead (a division by a runtime
//     value, or a table read, per load cost more than the copies);
//   - steps go in pairs: step i + 1's scores are in flight during step i's
//     softmax, the first step's context product runs on into the second,
//     and the pair ends with nothing in flight (ptxas serializes the
//     products of a pipeline that crosses the loop);
//   - parts past P or past the range are masked with -inf and read the q
//     tile (or a zeroed slot) as a finite stand-in; the table is read a row
//     a part, so it has no size cap; the context is rescaled only where a
//     row's max moved.
// It streams every part from L2: each query block loads all P of its key
// and value blocks, also those its neighbours loaded (the globals, two of
// the band): 0.79 GB a call at the bs-32 hold, four times the bound's
// bytes; a head dim short of a whole 64-column panel (16-48, 80-112) pays
// for the padding in bytes and products. Keeping the globals and the band
// resident across a row's tiles, as the serving kernel does, would halve
// the loads at P 8; it is not built, so the classes it loses go to:
//
// sparse_band_kernel<HD>, mma.sync, the other 28 classes: one block of bs
// / 16 warps a (query block, head, batch) reads its P parts through a
// double-buffered cp.async ring; mma.sync m16n8k16 for both products, a
// warp per 16 query rows, the softmax in natural-exponent units (__expf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"


namespace vcg_sa {

using bf16 = __nv_bfloat16;
constexpr float kPenalty = -10000.0f;
constexpr int kMaxBlock = 64;   // key rows a part
constexpr int kMaxHead = 128;   // head dimension

struct Params {
  const bf16* q;       // query row 0 of block 1 of batch 0; rows h*hd apart
  const bf16* k;       // [b, l, h, hd] contiguous
  const bf16* v;       // [b, l, h, hd] contiguous
  const int* mask;     // [b, l], 1 keep / 0 pad
  const int* ids;      // [nbq, np] attended key block per slot
  const int* valid;    // [nbq, np] 0 on a slot the band already covers
  bf16* out;           // output row 0 of block 1 of batch 0; rows h*hd apart
  int b, l, h, hd, bs, np;
  long long q_batch, o_batch;  // batch strides of q and out, in elements
  float scale;
};

// two floats -> bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (the softmax runs in log2 units: scores and penalty pre-scaled by
// log2 e, so one ex2 a probability)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPenL2 = kPenalty * kLog2e;

// Wait until at most N committed product groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

struct Walk {
  int bb, hh, qb, qi;  // batch, head, query block (0-based among nbq), qi
};

__device__ __forceinline__ Walk walk_at(const Params& p, int nbq, int t) {
  Walk w;
  w.qb = t % nbq;
  const int bh = t / nbq;
  w.hh = bh % p.h;
  w.bb = bh / p.h;
  w.qi = w.qb + 1;
  return w;
}


// ---------------------------------------------------------------------------
// The shapes where it is the faster of the two (see route_for) on
// mma.sync: bs 16..64, hd 16..128, any P
// ---------------------------------------------------------------------------

namespace ms {
namespace {  // internal linkage: each build of this file keeps its own statics

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// d += a . b: one m16n8k16 tile, bf16 operands, float32 sums
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}


// rows [row0, row0 + bs) of one head of a [*, h, HD] tensor -> smem tile
template <int HD>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          long long row_stride, int bs) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kLd = HD + 8;
  for (int c = threadIdx.x; c < bs * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int cc = c - r * kChunks;
    cp_async16(tile + r * kLd + cc * 8, base + r * row_stride + cc * 8);
  }
}

template <int HD>
__global__ void __launch_bounds__(128) sparse_band_kernel(Params p) {
  constexpr int kLd = HD + 8;  // padded smem pitch (elements)
  constexpr int kDT = HD / 8;  // n-tiles of the context
  constexpr int kKS = HD / 16; // k-steps of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bs = p.bs;
  // smem: q tile, k tiles (2 buffers), v tiles (2), penalty rows (2)
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  const int tile = bs * kLd;
  auto ks = [&](int buf) { return qs + (1 + buf) * tile; };
  auto vs = [&](int buf) { return qs + (3 + buf) * tile; };
  float* pen0 = reinterpret_cast<float*>(qs + 5 * tile);
  auto pen = [&](int buf) { return pen0 + buf * bs; };

  const int qb = blockIdx.x;  // middle query block index, 0..nbq-1
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int nt = bs / 8;   // key n-tiles per part
  const int kt = bs / 16;  // key k-steps per part
  const long long row_stride = static_cast<long long>(p.h) * HD;
  const int* ids = p.ids + qb * p.np;
  const int* valid = p.valid + qb * p.np;

  auto load_part = [&](int j, int buf) {
    const int blk = ids[j];
    const long long row0 = (static_cast<long long>(bb) * p.l + blk * bs) *
                               row_stride + hh * HD;
    load_tile<HD>(ks(buf), p.k + row0, row_stride, bs);
    load_tile<HD>(vs(buf), p.v + row0, row_stride, bs);
    const float val = static_cast<float>(valid[j]);
    const int* m = p.mask + static_cast<long long>(bb) * p.l + blk * bs;
    for (int r = threadIdx.x; r < bs; r += blockDim.x)
      pen(buf)[r] = (1.0f - static_cast<float>(m[r]) * val) * kPenalty;
  };

  load_tile<HD>(qs,
                p.q + bb * p.q_batch + qb * bs * row_stride + hh * HD,
                row_stride, bs);
  load_part(0, 0);
  cp_async_commit();

  uint32_t qa[kKS][4];
  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;        // this thread's share of the row sums

  for (int j = 0; j < p.np; ++j) {
    const int cur = j & 1;
    if (j + 1 < p.np) load_part(j + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (j == 0) {
      const bf16* q0 = qs + (warp * 16 + g) * kLd + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        qa[kk][0] = ld32(q0 + kk * 16);
        qa[kk][1] = ld32(q0 + 8 * kLd + kk * 16);
        qa[kk][2] = ld32(q0 + kk * 16 + 8);
        qa[kk][3] = ld32(q0 + 8 * kLd + kk * 16 + 8);
      }
    }

    // scores of this warp's 16 rows against the part's bs keys
    float s[kMaxBlock / 8][4];
#pragma unroll
    for (int n = 0; n < kMaxBlock / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if (n < nt) {
        const bf16* k0 = ks(cur) + (n * 8 + g) * kLd + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          const uint32_t bfr[2] = {ld32(k0 + kk * 16), ld32(k0 + kk * 16 + 8)};
          mma16816(s[n], qa[kk], bfr);
        }
      }
    }

    // scale, penalty, online softmax
    const float* pn = pen(cur);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kMaxBlock / 8; ++n) {
      if (n < nt) {
        const int c = n * 8 + 2 * t4;
        s[n][0] = s[n][0] * p.scale + pn[c];
        s[n][1] = s[n][1] * p.scale + pn[c + 1];
        s[n][2] = s[n][2] * p.scale + pn[c];
        s[n][3] = s[n][3] * p.scale + pn[c + 1];
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = __expf(m0 - mx0);
    const float a1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxBlock / 8; ++n) {
      if (n < nt) {
        s[n][0] = __expf(s[n][0] - m0);
        s[n][1] = __expf(s[n][1] - m0);
        s[n][2] = __expf(s[n][2] - m1);
        s[n][3] = __expf(s[n][3] - m1);
        rs0 += s[n][0] + s[n][1];
        rs1 += s[n][2] + s[n][3];
      }
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }

    // context += p . v; the score accumulators of two n-tiles are the
    // A fragment of one 16-key step
    const unsigned short* v16 = reinterpret_cast<const unsigned short*>(vs(cur));
#pragma unroll
    for (int kk = 0; kk < kMaxBlock / 16; ++kk) {
      if (kk < kt) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const unsigned short* v0 = v16 + (kk * 16 + 2 * t4) * kLd + g;
#pragma unroll
        for (int d = 0; d < kDT; ++d) {
          const unsigned short* vp = v0 + d * 8;
          const uint32_t bfr[2] = {
              vp[0] | (static_cast<uint32_t>(vp[kLd]) << 16),
              vp[8 * kLd] | (static_cast<uint32_t>(vp[9 * kLd]) << 16)};
          mma16816(o[d], pa, bfr);
        }
      }
    }
    __syncthreads();  // the next iteration loads into this buffer
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0;
  const float inv1 = 1.0f / l1;
  bf16* out = p.out + bb * p.o_batch +
              (static_cast<long long>(qb) * bs + warp * 16 + g) * row_stride +
              hh * HD + 2 * t4;
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    *reinterpret_cast<uint32_t*>(out + d * 8) =
        pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(out + 8 * row_stride + d * 8) =
        pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      5 * static_cast<size_t>(p.bs) * (HD + 8) * sizeof(bf16) +
      2 * p.bs * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sparse_band_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.l / p.bs - 2, p.h, p.b);
  sparse_band_kernel<HD><<<grid, p.bs / 16 * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ms

// ---------------------------------------------------------------------------
// The serving shape on wgmma: bs 64, hd 64, P <= 5 + kHRand
// ---------------------------------------------------------------------------

namespace hw {
namespace {  // internal linkage: each build of this file keeps its own statics

using namespace vcg::hop;

constexpr int kHB = 64;                 // block size: query rows, keys a part
constexpr int kHTile = kHB * 128;       // a [64][64] bf16 tile, 128B-swizzled
constexpr int kHKV = 2 * kHTile;        // a key block: K, then V
constexpr int kHRand = 3;               // random parts a query block, at most
constexpr int kHBand = 2;               // first band slot (0, 1: the globals)
constexpr int kHRand0 = kHBand + 4;     // first random slot: 2 sets of kHRand
constexpr int kHSlots = kHRand0 + 2 * kHRand;
constexpr int kHTable = 512;            // nbq * P entries of ids and valid
constexpr int kHThreads = 256;          // two warpgroups
// the second warpgroup's context rows 32-63 (float32; rows 0-31 go to the
// query block's q tile) and its row max and sum, for the merge
constexpr int kHXch = 32 * kHB * 4 + 2 * kHB * 4;
constexpr int kHSmem = 2 * kHTile + kHSlots * kHKV + kHSlots * kHB * 4 +
                       2 * kHTable * 4 + kHXch + kAlignSlack;

__device__ __forceinline__ int band_slot(int blk) {
  return kHBand + (blk & 3);
}

// The loads of query block t (it = t - t0 its index in the block's walk):
// its q tile and, by TMA onto bars[it & 1], the key blocks it is the
// first to need: with `restart` (the first of a row in this walk) the two
// globals and the band qi-1, qi, qi+1, else the band's new block qi+1;
// then its random blocks, into random set it & 1. The mask row of each
// loaded block goes beside its slot. Every thread calls it.
__device__ void issue(const Params& p, const Walk& w, int it, bool restart,
                      uint8_t* qs, uint8_t* kv, int* mk, const int* tids,
                      uint64_t* bars, const CUtensorMap* kmap,
                      const CUtensorMap* vmap) {
  const int nb = p.l / kHB;
  const int buf = it & 1;
  // entry e of the loads: 0-3 only with restart (the globals, the band's
  // qi - 1 and qi), 4 the band's qi + 1, 5.. the random blocks
  auto entry = [&](int e, int& blk, int& slot) {
    if (e < 5) {
      blk = e == 0 ? 0 : e == 1 ? nb - 1 : w.qi + e - 3;
      slot = e < 2 ? e : band_slot(blk);
    } else {
      blk = tids[w.qb * p.np + e];
      slot = kHRand0 + buf * kHRand + (e - 5);
    }
  };
  const int e0 = restart ? 0 : 4;
  const int row0 = w.bb * p.l;
  const int col = w.hh * kHB;
  if (threadIdx.x == 0) mbar_expect(&bars[buf], (5 + kHRand - e0) * kHKV);
  if ((threadIdx.x & 31) == 0 && threadIdx.x < 128) {  // warps 0-3
    for (int e = e0 + (threadIdx.x >> 5); e < 5 + kHRand; e += 4) {
      int blk, slot;
      entry(e, blk, slot);
      uint8_t* dst = kv + slot * kHKV;
      tma_load(dst, kmap, col, row0 + blk * kHB, &bars[buf]);
      tma_load(dst + kHTile, vmap, col, row0 + blk * kHB, &bars[buf]);
    }
  }
  // q: 64 rows x 8 chunks; the mask rows: 16 chunks a block
  const bf16* q = p.q + w.bb * p.q_batch +
                  static_cast<long long>(w.qb) * kHB * p.h * kHB + col;
  for (int c = threadIdx.x; c < kHB * 8; c += blockDim.x) {
    const int r = c >> 3, cc = c & 7;
    vcg::cp_async16(qs + buf * kHTile + swz(r, cc),
                    q + static_cast<long long>(r) * p.h * kHB + cc * 8, true);
  }
  const int e = e0 + (threadIdx.x >> 4), cc = threadIdx.x & 15;
  if (e < 5 + kHRand) {
    int blk, slot;
    entry(e, blk, slot);
    vcg::cp_async16(mk + slot * kHB + 4 * cc,
                    p.mask + row0 + blk * kHB + 4 * cc, true);
  }
  vcg::cp_async_commit();
}

__global__ void __launch_bounds__(kHThreads, 1)
    sparse_band_wgmma_kernel(Params p,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap) {
  __shared__ alignas(8) uint64_t bars[2];
  uint8_t* qs = aligned_smem();
  uint8_t* kv = qs + 2 * kHTile;
  int* mk = reinterpret_cast<int*>(kv + kHSlots * kHKV);
  int* tids = mk + kHSlots * kHB;
  int* tval = tids + kHTable;
  float* xo = reinterpret_cast<float*>(tval + kHTable);
  const int nb = p.l / kHB, nbq = nb - 2;
  const int total = p.b * p.h * nbq;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * total /
                                  gridDim.x);
  const int t1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * total / gridDim.x);
  if (t0 >= t1) return;
  for (int i = threadIdx.x; i < nbq * p.np; i += blockDim.x) {
    tids[i] = p.ids[i];
    tval[i] = p.valid[i];
  }
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    tma_prefetch(&kmap);
    tma_prefetch(&vmap);
  }
  __syncthreads();
  // the kernel takes slots 0-4 of every row from the structure; the
  // wrapper refuses a table that differs (ValueError), so this only
  // asserts it (a trap, never a silent wrong answer)
  for (int i = threadIdx.x; i < nbq; i += blockDim.x) {
    const int* r = tids + i * p.np;
    if (r[0] != 0 || r[1] != i || r[2] != i + 1 || r[3] != i + 2 ||
        r[4] != nb - 1)
      __trap();
  }
  // warpgroup wg takes parts jb .. jb + 3 of every query block with its
  // own online softmax; the two are merged at the end
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3, q4 = lane & 3;
  const int r = 16 * wq + (lane >> 2);  // this lane's rows r and r + 8
  const int jb = 4 * wg;
  const float scale2 = p.scale * kLog2e;
  issue(p, walk_at(p, nbq, t0), 0, true, qs, kv, mk, tids, bars, &kmap,
        &vmap);
  for (int t = t0; t < t1; ++t) {
    const int it = t - t0, buf = it & 1;
    const Walk w = walk_at(p, nbq, t);
    // this query block's q and mask rows are in; every thread is past the
    // products of the one before, so its slots may be refilled
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    const bool next_in_row = t + 1 < t1 && (t + 1) % nbq != 0;
    if (next_in_row)
      issue(p, walk_at(p, nbq, t + 1), it + 1, false, qs, kv, mk, tids, bars,
            &kmap, &vmap);
    mbar_wait(&bars[buf], (it >> 1) & 1);

    const uint32_t qa = smem_addr(qs + buf * kHTile);
    const int* vrow = tval + w.qb * p.np;
    // the part's key/value slot
    auto slot_of = [&](int jj) {
      return jj == 0   ? 0
             : jj == 4 ? 1
             : jj < 4  ? band_slot(w.qi - 2 + jj)
                       : kHRand0 + buf * kHRand + (jj - 5);
    };
    // S = Q K^T of part jj into s (both K-major), committed as one group
    auto issue_s = [&](float (&s)[32], int jj) {
      const uint32_t ka = smem_addr(kv + slot_of(jj) * kHKV);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_acc(s);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64<0, 0>(s, desc(qa + kk * 32, 16, 1024),
                           desc(ka + kk * 32, 16, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(s);
    };
    float o[32], sc[2][32];
    uint32_t pa[2][4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = -1e30f, m1 = -1e30f;  // running max of rows r and r + 8,
    float l0 = 0.f, l1 = 0.f;        // log2 units; this thread's row sums
    issue_s(sc[0], jb);
    // part i's softmax runs while part i + 1's scores and part i - 1's
    // context product are in flight (groups retire in order)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float (&s)[32] = sc[i & 1];
      if (i + 1 < 4) {
        issue_s(sc[(i + 1) & 1], jb + i + 1);
        if (i == 0)  // part i's scores
          wgmma_wait<1>();
        else
          wgmma_wait<2>();
      } else {
        wgmma_wait<1>();
      }
      fence_acc(s);
      // scale and penalty in log2 units, online softmax (rows r: s[4 n],
      // s[4 n + 1]; r + 8: s[4 n + 2], s[4 n + 3]; keys 8 n + 2 q4, + 1)
      const int jj = jb + i;
      const float val = static_cast<float>(vrow[jj]);
      const int* mrow = mk + slot_of(jj) * kHB + 2 * q4;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int2 mm = *reinterpret_cast<const int2*>(mrow + 8 * n);
        const float pn0 = (1.0f - static_cast<float>(mm.x) * val) * kPenL2;
        const float pn1 = (1.0f - static_cast<float>(mm.y) * val) * kPenL2;
        s[4 * n] = fmaf(s[4 * n], scale2, pn0);
        s[4 * n + 1] = fmaf(s[4 * n + 1], scale2, pn1);
        s[4 * n + 2] = fmaf(s[4 * n + 2], scale2, pn0);
        s[4 * n + 3] = fmaf(s[4 * n + 3], scale2, pn1);
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = ex2(m0 - mx0);
      const float a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[4 * n] = ex2(s[4 * n] - m0);
        s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
        s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
        s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
        rs0 += s[4 * n] + s[4 * n + 1];
        rs1 += s[4 * n + 2] + s[4 * n + 3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      // part i - 1's context product is done: o and its fragments are free
      if (i + 1 < 4)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_acc(o);
      uint32_t (&frag)[4][4] = pa[i & 1];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }
      // O += P V: the probabilities of keys 16 kk .. 16 kk + 15 are the
      // register A fragment of step kk; V MN-major (keys are its rows)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        frag[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        frag[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        frag[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        frag[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        fence_regs(frag[kk]);
      }
      const uint32_t va = smem_addr(kv + slot_of(jj) * kHKV + kHTile);
      fence_acc(o);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ra<1>(o, frag[kk], desc(va + kk * 2048, kPanel, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(o);
    }
    wgmma_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_regs(pa[h][k]);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    // the merge, split by rows: the warps of rows 0-31 of warpgroup 1 and
    // of rows 32-63 of warpgroup 0 hand their context (float32; rows 0-31
    // in the q tile, whose products are done, rows 32-63 in xo), row max
    // and row sum to the other warpgroup's warps of the same rows, which
    // rescale both to the larger max, divide by the merged sum and store
    // the rows as bf16
    __syncthreads();
    float* stage = reinterpret_cast<float*>(qs + buf * kHTile);
    float* ml = xo + 32 * kHB;
    auto orow = [&](int row) {
      return row < 32 ? stage + row * kHB : xo + (row - 32) * kHB;
    };
    const bool keep = (wg == 0) == (wq < 2);  // this warp stores its rows
    if (!keep) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(orow(r) + 8 * n + 2 * q4) =
            make_float2(o[4 * n], o[4 * n + 1]);
        *reinterpret_cast<float2*>(orow(r + 8) + 8 * n + 2 * q4) =
            make_float2(o[4 * n + 2], o[4 * n + 3]);
      }
      if (q4 == 0) {
        ml[r] = m0;
        ml[r + 8] = m1;
        ml[kHB + r] = l0;
        ml[kHB + r + 8] = l1;
      }
    }
    __syncthreads();
    if (keep) {
      const float mm0 = fmaxf(m0, ml[r]), mm1 = fmaxf(m1, ml[r + 8]);
      const float fa0 = ex2(m0 - mm0), fb0 = ex2(ml[r] - mm0);
      const float fa1 = ex2(m1 - mm1), fb1 = ex2(ml[r + 8] - mm1);
      const float inv0 = 1.0f / (l0 * fa0 + ml[kHB + r] * fb0);
      const float inv1 = 1.0f / (l1 * fa1 + ml[kHB + r + 8] * fb1);
      bf16* out = p.out + w.bb * p.o_batch +
                  (static_cast<long long>(w.qb) * kHB + r) * p.h * kHB +
                  w.hh * kHB + 2 * q4;
      const long long down8 = 8LL * p.h * kHB;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b0 =
            *reinterpret_cast<const float2*>(orow(r) + 8 * n + 2 * q4);
        const float2 b1 =
            *reinterpret_cast<const float2*>(orow(r + 8) + 8 * n + 2 * q4);
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_bf16((o[4 * n] * fa0 + b0.x * fb0) * inv0,
                      (o[4 * n + 1] * fa0 + b0.y * fb0) * inv0);
        *reinterpret_cast<uint32_t*>(out + down8 + 8 * n) =
            pack_bf16((o[4 * n + 2] * fa1 + b1.x * fb1) * inv1,
                      (o[4 * n + 3] * fa1 + b1.y * fb1) * inv1);
      }
    }
    if (t + 1 < t1 && !next_in_row) {  // a new row: reload after the merge
      __syncthreads();
      issue(p, walk_at(p, nbq, t + 1), it + 1, true, qs, kv, mk, tids, bars,
            &kmap, &vmap);
    }
  }
}

// The serving shape's kernel applies: bs 64, hd 64, 8 parts (kHRand
// random ones: both warpgroups issue the same products, a branch around
// a product would serialize them) and a table that fits its shared copy.
bool takes(int bs, int hd, int np, int nbq) {
  return bs == kHB && hd == kHB && np == 5 + kHRand && nbq * np <= kHTable;
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  const uint64_t rows = static_cast<uint64_t>(p.b) * p.l;
  const uint64_t cols = static_cast<uint64_t>(p.h) * kHB;
  cudaError_t e = tensor_map(&kmap, p.k, rows, cols, kHB);
  if (e == cudaSuccess) e = tensor_map(&vmap, p.v, rows, cols, kHB);
  if (e == cudaSuccess) e = allow_smem<sparse_band_wgmma_kernel>(kHSmem);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int total = p.b * p.h * (p.l / kHB - 2);
  const int grid = total < sms ? total : sms;
  sparse_band_wgmma_kernel<<<grid, kHThreads, kHSmem, stream>>>(p, kmap,
                                                                  vmap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hw

// ---------------------------------------------------------------------------
// Every other shape on wgmma: bs 16..64, hd 16..128, any P >= 5
// ---------------------------------------------------------------------------

namespace rk {
namespace {  // internal linkage: each build of this file keeps its own statics

using namespace vcg::hop;

constexpr int kRThreads = 128;  // one warpgroup a block
// ring bytes a 64-column panel: 48 KB leaves room for three blocks an SM
// at hd <= 64 (a 64 or 80 KB ring, two blocks an SM, timed slower)
constexpr int kRingKB = 48;

// S = Q K^T of one part: m64nNk16, N = bs keys, both operands K-major;
// acc 0 overwrites d (the first k-step), 1 adds to it
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int acc);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}


// m64n128k16 with A from registers (wgmma_m64n64_ra's layout)
template <int TB>
__device__ __forceinline__ void wgmma_m64n128_ra(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// O += P V over 16 keys: V MN-major, its hd panels lbo bytes apart
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&d)[HDP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HDP == 64)
    wgmma_m64n64_ra<1>(d, a, db);
  else
    wgmma_m64n128_ra<1>(d, a, db);
}

// An mbarrier that completes a phase after `count` arrivals.
__device__ __forceinline__ void mbar_init_n(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// This thread's arrival on bar once all of its cp.async copies issued so
// far have landed (the barrier's count includes it: noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The shape class of a launch: BS keys a part, HDP the head dimension
// padded to 64-column panels, GH heads a tile (GH hd <= 64). A tile packs
// GH heads of kM = 64 / (BS GH) consecutive query blocks of the walk into
// the m64 rows (bs 48: one, rows 48-63 padding), bs rows a (query block,
// head), each head's q in its own columns of the panel (zero elsewhere),
// so one key box of 64 columns serves its GH heads; a step takes part s
// of each query block (kKeys keys), each warp's rows using only their own
// query block's part. kRing slots hold the parts: the three steps a pair
// of steps holds at once (see the step loop), and kRing / kM - 3 steps of
// copies ahead of the products.
template <int BS, int HDP, int GH>
struct Ring {
  static constexpr int kPanels = HDP / 64;
  static constexpr int kM = BS == 48 ? 1 : 64 / BS / GH;  // query blocks
  static constexpr int kKeys = kM * BS;              // keys a step
  static constexpr int kTile = kPanels * BS * 128;   // a K or V part
  static constexpr int kSlot = 2 * kTile;            // K, then V
  static constexpr int kQ = kPanels * 64 * 128;      // a q tile, 64 rows
  // kRingKB of slots a panel
  static constexpr int kRing = kM * (kRingKB * 1024 * kPanels / kSlot / kM);
  static constexpr int kSmem =
      2 * kQ + kRing * kSlot + kRing * BS * 4 + kAlignSlack;
  static_assert(kRing >= 3 * kM, "the ring must hold three steps");
  static_assert(kSmem <= 232448, "over the shared memory of a block");
};

template <int BS, int HDP, int GH>
__global__ void __launch_bounds__(kRThreads, HDP == 64 ? 3 : 1)
    sparse_band_ring_kernel(Params p,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap) {
  using C = Ring<BS, HDP, GH>;
  constexpr int M = C::kM, NR = C::kRing;
  constexpr int S2 = C::kKeys / 2;   // score registers a lane (a step)
  constexpr int KS = C::kKeys / 16;  // k-steps of a step's context product
  constexpr int SP = BS / 2;         // score registers of one part
  constexpr int kMaskLanes = BS / 4; // lanes copying a part's mask row
  __shared__ alignas(8) uint64_t bars[NR + 2];  // the slots', the q tiles'
  uint64_t* qbars = bars + NR;
  uint8_t* qs = aligned_smem();                 // two q tiles
  // the slots' K tiles, then their V tiles (a step's parts lie in
  // consecutive slots: at hd <= 64 their keys are one tile), then their
  // mask rows
  uint8_t* ks = qs + 2 * C::kQ;
  uint8_t* vs = ks + NR * C::kTile;
  int* mk = reinterpret_cast<int*>(vs + NR * C::kTile);
  const int hd = p.hd, np = p.np;
  const int cpr = hd / 8;  // 16-byte chunks of a row of one head
  const int nbq = p.l / BS - 2;
  const int nhg = p.h / GH;  // head groups
  const int total = p.b * nhg * nbq;
  // the walk's t-th query block of a head group: w.hh is the group
  auto walk = [&](int t) {
    Walk w;
    w.qb = t % nbq;
    const int bh = t / nbq;
    w.hh = bh % nhg;
    w.bb = bh / nhg;
    w.qi = w.qb + 1;
    return w;
  };
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * total /
                                  gridDim.x);
  const int t1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * total / gridDim.x);
  if (t0 >= t1) return;
  const long long ld = static_cast<long long>(p.h) * hd;  // a token's row
  // the q tiles' columns >= hd (and rows 48-63 at bs 48) are never
  // copied: zero, so the key boxes' columns past hd add nothing to S; the
  // slots start zero too, so a slot a part past t1 leaves unfilled holds
  // finite values (its products are discarded or multiplied by 0)
  for (int i = threadIdx.x; i < (2 * C::kQ + NR * C::kSlot) / 16;
       i += kRThreads)
    reinterpret_cast<uint4*>(qs)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NR; ++s) mbar_init_n(&bars[s], 1 + kMaskLanes);
    for (int s = NR; s < NR + 2; ++s) mbar_init_n(&bars[s], kRThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    tma_prefetch(&kmap);
    tma_prefetch(&vmap);
  }
  __syncthreads();

  // Part s of query block g of the block's tt-th tile is ring load
  // m = (tt * np + s) * M + g, into slot m % NR: its key and value boxes
  // ([bs] rows x 64 columns, a box a panel) by TMA, and its mask row by
  // cp.async from bs / 4 lanes of warps 1-3, onto the slot's barrier (one
  // arrival with the boxes' bytes, one a mask lane), whose k-th phase is
  // the slot's k-th fill. A TMA copy costs its issuing thread a few
  // hundred cycles, so the kBoxes boxes of a part, and a step's M parts,
  // are spread over the four warps' lane 0. Only the last tile can hold
  // query blocks past t1: their loads (every NR-th, as NR % M == 0) are
  // never issued nor waited for.
  const int n_tiles = (t1 - t0 + M - 1) / M;
  constexpr int kBoxes = 2 * C::kPanels;
  // The copies of part g of step fs of local tile ft (whose query block g
  // is walk w, if it lies before t1), table id blk, into slot s, whose turn
  // (box j of the step's part g: g * kBoxes + j) falls to this lane.
  auto ring_load = [&](int s, const Walk& w, bool real, int blk, int g) {
    if (!real) return;
    const int row = w.bb * p.l + blk * BS;
    // lanes 1 .. of warps 1-3 (warp 0's lane 0 issues boxes of every step)
    const int ml = (threadIdx.x & 31) - 1 - g / 3 * kMaskLanes;
    if ((threadIdx.x >> 5) == 1 + g % 3 && ml >= 0 && ml < kMaskLanes) {
      vcg::cp_async16(mk + s * BS + 4 * ml, p.mask + row + 4 * ml, true);
      cp_async_arrive(&bars[s]);
    }
    if (threadIdx.x & 31) return;
    int j = ((threadIdx.x >> 5) - g * kBoxes) & 3;
    if (j >= kBoxes) return;
    for (; j < kBoxes; j += 4) {
      if (j == 0) mbar_expect(&bars[s], C::kSlot);
      const int v = j & 1, pn = j >> 1;
      tma_load((v ? vs : ks) + s * C::kTile + pn * BS * 128,
               v ? &vmap : &kmap, w.hh * GH * hd + 64 * pn, row, &bars[s]);
    }
  };
  // The refill cursor: load `fill` (M of them a step, in order) is part g
  // of step fs of local tile ft; fw[g] and freal[g] are that tile's query
  // blocks (walked once a tile, not once a load: a division by a runtime
  // value is tens of instructions), ids_next[g] their table ids, read one
  // refill ahead so that no refill waits on the table.
  int fill = 0, fs = 0, ft = 0;
  Walk fw[M];
  bool freal[M];
  int ids_next[M];
  auto fill_tile = [&] {
#pragma unroll
    for (int g = 0; g < M; ++g) {
      const int t = t0 + ft * M + g;
      freal[g] = ft < n_tiles && t < t1;
      fw[g] = walk(freal[g] ? t : t0);
    }
  };
  auto read_ids = [&] {
#pragma unroll
    for (int g = 0; g < M; ++g)
      ids_next[g] = freal[g] ? __ldg(p.ids + fw[g].qb * np + fs) : 0;
  };
  // issue the next step's M loads of the cursor and advance it
  auto fill_step = [&] {
#pragma unroll
    for (int g = 0; g < M; ++g)
      ring_load((fill + g) % NR, fw[g], freal[g], ids_next[g], g);
    fill += M;
    if (++fs == np) {
      fs = 0;
      ++ft;
      fill_tile();
    }
    read_ids();
  };
  fill_tile();
  read_ids();
  for (int k = 0; k < NR / M; ++k) fill_step();
  // q rows of tile tt (bs rows of each query block and head, head gh in
  // columns gh hd ..) into q tile buf, onto its barrier
  auto load_q = [&](int tt, int buf) {
    uint8_t* qt = qs + buf * C::kQ;
    for (int g = 0; g < M; ++g) {
      const int t = t0 + tt * M + g;
      if (t >= t1) break;
      const Walk w = walk(t);
      const bf16* q = p.q + w.bb * p.q_batch +
                      static_cast<long long>(w.qb) * BS * ld +
                      w.hh * GH * hd;
      for (int c = threadIdx.x; c < GH * BS * cpr; c += kRThreads) {
        const int rh = c / cpr, ch = c - rh * cpr;  // rh: head gh, row r
        const int gh = rh / BS, r = rh - gh * BS, cc = gh * cpr + ch;
        vcg::cp_async16(qt + (cc >> 3) * 8192 +
                            swz((g * GH + gh) * BS + r, cc & 7),
                        q + r * ld + gh * hd + ch * 8, true);
      }
    }
    cp_async_arrive(&qbars[buf]);
  };
  load_q(0, 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  const int r = 16 * warp + (lane >> 2);  // this lane's rows r and r + 8
  const int gw = 16 * warp / BS / GH;     // their query block in the tile
  const int gh = 16 * warp / BS % GH;     // and head in the group
  const int n_lo = gw * BS / 8, n_hi = n_lo + BS / 8;  // their keys' n-tiles
  const float scale2 = p.scale * kLog2e;
  const int steps2 = (np + 1) & ~1;  // walked two at a time
  float o[HDP / 2], sa[S2], sb[S2];
  uint32_t frag[KS][4];  // a step's probabilities, read by its O product

  for (int tt = 0; tt < n_tiles; ++tt) {
    const int buf = tt & 1;
    // every thread is past the tile before, so its q tile may be refilled
    __syncthreads();
    if (tt + 1 < n_tiles) load_q(tt + 1, buf ^ 1);
    mbar_wait(&qbars[buf], (tt >> 1) & 1);
    fence_async_smem();
    const uint8_t* qt = qs + buf * C::kQ;
    const uint32_t qa = smem_addr(qt);
    const int m0 = tt * np * M;  // the ring load of the tile's first part
    const int n_q = min(M, t1 - t0 - tt * M);  // its query blocks
    // this warp's query block: its valid row, or none (past t1, or the
    // padding rows of bs 48)
    const bool mine = gw < n_q;
    const int* vrow =
        mine ? p.valid + walk(t0 + tt * M + gw).qb * np : p.valid;
    // part g of step st: its K (v 0) or V tile, or the q tile (a finite
    // stand-in whose scores are masked with -inf: its products add
    // nothing) past P or t1
    auto slot_of = [&](int st, int g, int v) -> const uint8_t* {
      return st < np && g < n_q
                 ? (v ? vs : ks) + ((m0 + st * M + g) % NR) * C::kTile
                 : qt;
    };
    // S of step st (part st of each query block) into s, one group
    auto issue_s = [&](float (&s)[S2], int st) {
#pragma unroll
      for (int g = 0; g < M; ++g) {
        const int m = m0 + st * M + g;
        if (st < np && g < n_q) mbar_wait(&bars[m % NR], (m / NR) & 1);
      }
      fence_acc(s);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if constexpr (C::kPanels == 1) {
        // the step's M parts are one K tile of kKeys rows (a part past t1:
        // its zero or stale slot; past P: the q tile)
        const uint32_t ka = smem_addr(
            st < np ? ks + ((m0 + st * M) % NR) * C::kTile : qt);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<C::kKeys>(s, desc(qa + kk * 32, 16, 1024),
                             desc(ka + kk * 32, 16, 1024), kk > 0);
      } else {
#pragma unroll
        for (int g = 0; g < M; ++g) {
          float (&sg)[SP] = *reinterpret_cast<float(*)[SP]>(s + g * SP);
          const uint32_t ka = smem_addr(slot_of(st, g, 0));
#pragma unroll
          for (int pn = 0; pn < C::kPanels; ++pn)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<BS>(sg, desc(qa + pn * 8192 + kk * 32, 16, 1024),
                           desc(ka + pn * BS * 128 + kk * 32, 16, 1024),
                           pn + kk > 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(s);
    };
    // step st's parts are consumed: refill their slots NR loads ahead
    // (loads m0 + st M + NR .., which are the cursor's next)
    auto release = [&](int st) {
      if (st >= np) return;
      __syncthreads();
      fill_step();
    };
    int valid_next = mine ? __ldg(vrow) : 0;  // step 0's valid flag
    float m_0 = -1e30f, m_1 = -1e30f;  // running max of rows r and r + 8,
    float l_0 = 0.f, l_1 = 0.f;        // log2 units; this thread's row sums
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;

    // step i: its softmax runs while step i + 1's scores are in flight.
    // The steps go in pairs: the first's context product runs on into the
    // second, which waits for it with its own scores; the second's is
    // waited before the pair ends, so no product is in flight across the
    // loop (ptxas serializes every product of a pipeline it cannot follow)
    auto step = [&](int i, float (&s)[S2], float (&nx)[S2], bool second) {
      const bool live = mine && i < np;  // this warp's part is real
      const int sl = (m0 + i * M + gw) % NR;
      const float val = static_cast<float>(valid_next);
      // the next step's flag, read while this one runs
      valid_next = mine && i + 1 < np ? __ldg(vrow + i + 1) : 0;
      issue_s(nx, i + 1);
      if (second) {  // this step's scores and the first's context product
        wgmma_wait<1>();
        fence_acc(o);
        fence_acc(s);
        release(i - 1);
      }
      float a0 = 1.0f, a1 = 1.0f;
      if (live) {
        // scale and penalty in log2 units over this warp's keys (rows r:
        // s[4 n], s[4 n + 1]; r + 8: s[4 n + 2], s[4 n + 3]; keys
        // 8 n + 2 q4, + 1 of the step)
        const int* mrow = mk + sl * BS - n_lo * 8 + 2 * q4;
        float mx0 = m_0, mx1 = m_1;
#pragma unroll
        for (int n = 0; n < S2 / 4; ++n) {
          if (n < n_lo || n >= n_hi) continue;
          const int2 mm = *reinterpret_cast<const int2*>(mrow + 8 * n);
          const float pn0 = (1.0f - static_cast<float>(mm.x) * val) * kPenL2;
          const float pn1 = (1.0f - static_cast<float>(mm.y) * val) * kPenL2;
          s[4 * n] = fmaf(s[4 * n], scale2, pn0);
          s[4 * n + 1] = fmaf(s[4 * n + 1], scale2, pn1);
          s[4 * n + 2] = fmaf(s[4 * n + 2], scale2, pn0);
          s[4 * n + 3] = fmaf(s[4 * n + 3], scale2, pn1);
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        a0 = ex2(m_0 - mx0);
        a1 = ex2(m_1 - mx1);
        m_0 = mx0;
        m_1 = mx1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int n = 0; n < S2 / 4; ++n) {
          if (n < n_lo || n >= n_hi) continue;
          s[4 * n] = ex2(s[4 * n] - m_0);
          s[4 * n + 1] = ex2(s[4 * n + 1] - m_0);
          s[4 * n + 2] = ex2(s[4 * n + 2] - m_1);
          s[4 * n + 3] = ex2(s[4 * n + 3] - m_1);
          rs0 += s[4 * n] + s[4 * n + 1];
          rs1 += s[4 * n + 2] + s[4 * n + 3];
        }
        l_0 = l_0 * a0 + rs0;
        l_1 = l_1 * a1 + rs1;
      }
      // the context to the new max, unless no row of this warp moved (a
      // multiply by 1 changes nothing)
      if (__any_sync(0xffffffffu, a0 != 1.0f || a1 != 1.0f)) {
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
          o[4 * n] *= a0;
          o[4 * n + 1] *= a0;
          o[4 * n + 2] *= a1;
          o[4 * n + 3] *= a1;
        }
      }
      // O += P V: the probabilities of keys 16 kk .. 16 kk + 15 are the
      // register A fragment of step kk (zero outside this warp's keys); V
      // MN-major (keys are its rows)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bool own = live && 2 * kk >= n_lo && 2 * kk < n_hi;
        frag[kk][0] = own ? pack_bf16(s[8 * kk], s[8 * kk + 1]) : 0u;
        frag[kk][1] = own ? pack_bf16(s[8 * kk + 2], s[8 * kk + 3]) : 0u;
        frag[kk][2] = own ? pack_bf16(s[8 * kk + 4], s[8 * kk + 5]) : 0u;
        frag[kk][3] = own ? pack_bf16(s[8 * kk + 6], s[8 * kk + 7]) : 0u;
        fence_regs(frag[kk]);
      }
      // the V rows of keys 16 kk ..: at hd <= 64 the step's parts are one
      // tile (as for S), else part by part
      uint32_t va[M];
#pragma unroll
      for (int g = 0; g < M; ++g)
        va[g] = C::kPanels == 1
                    ? smem_addr(i < np ? vs + ((m0 + i * M) % NR) * C::kTile
                                       : qt) + g * BS * 128
                    : smem_addr(slot_of(i, g, 1));
      fence_acc(o);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_pv<HDP>(o, frag[kk],
                      desc(va[16 * kk / BS] + (16 * kk % BS) * 128,
                           BS * 128, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(o);
      if (second) {
        wgmma_wait<0>();  // step i + 1's scores and step i's context
        fence_acc(o);
        fence_acc(nx);
        release(i);
      }
    };

    issue_s(sa, 0);
    wgmma_wait<0>();
    fence_acc(sa);
    for (int i = 0; i < steps2; i += 2) {
      step(i, sa, sb, false);
      step(i + 1, sb, sa, true);
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) fence_regs(frag[k]);

    if (mine) {
      l_0 += __shfl_xor_sync(0xffffffffu, l_0, 1);
      l_0 += __shfl_xor_sync(0xffffffffu, l_0, 2);
      l_1 += __shfl_xor_sync(0xffffffffu, l_1, 1);
      l_1 += __shfl_xor_sync(0xffffffffu, l_1, 2);
      const float inv0 = 1.0f / l_0;
      const float inv1 = 1.0f / l_1;
      const Walk w = walk(t0 + tt * M + gw);
      // this head's columns gh hd .. of the panel
      bf16* out = p.out + w.bb * p.o_batch +
                  (static_cast<long long>(w.qb) * BS + r % BS) * ld +
                  w.hh * GH * hd + 2 * q4;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        if (8 * n < gh * hd || 8 * n >= gh * hd + hd) continue;
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
        *reinterpret_cast<uint32_t*>(out + 8 * ld + 8 * n) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    }
  }
}

template <int BS, int HDP, int GH = 1>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Ring<BS, HDP, GH>;
  CUtensorMap kmap, vmap;
  const uint64_t rows = static_cast<uint64_t>(p.b) * p.l;
  const uint64_t cols = static_cast<uint64_t>(p.h) * p.hd;
  cudaError_t e = tensor_map(&kmap, p.k, rows, cols, BS);
  if (e == cudaSuccess) e = tensor_map(&vmap, p.v, rows, cols, BS);
  int held = 0;
  if (e == cudaSuccess)
    e = resident<sparse_band_ring_kernel<BS, HDP, GH>, kRThreads>(C::kSmem,
                                                                  &held);
  if (e != cudaSuccess) return e;
  const int total = p.b * (p.h / GH) * (p.l / BS - 2);
  // every block at least one whole tile
  const int tiles = (total + C::kM - 1) / C::kM;
  const int grid = tiles < held ? tiles : held;
  sparse_band_ring_kernel<BS, HDP, GH>
      <<<grid, kRThreads, C::kSmem, stream>>>(p, kmap, vmap);
  return cudaGetLastError();
}

// The heads a tile packs: as many (4, 2 or 1) as fit 64 columns and 64
// rows and divide h.
int heads_a_tile(int bs, int hd, int h) {
  for (int gh = 4; gh > 1; gh /= 2)
    if (gh * hd <= 64 && gh * bs <= 64 && bs != 48 && h % gh == 0) return gh;
  return 1;
}

cudaError_t launch_any(const Params& p, cudaStream_t st) {
  const int hdp = p.hd <= 64 ? 64 : 128;
  const int gh = heads_a_tile(p.bs, p.hd, p.h);
  if (gh == 4) return launch<16, 64, 4>(p, st);
  if (gh == 2)
    return p.bs == 16 ? launch<16, 64, 2>(p, st) : launch<32, 64, 2>(p, st);
  switch (p.bs * 1000 + hdp) {
    case 16064: return launch<16, 64>(p, st);
    case 32064: return launch<32, 64>(p, st);
    case 48064: return launch<48, 64>(p, st);
    case 64064: return launch<64, 64>(p, st);
    case 16128: return launch<16, 128>(p, st);
    case 32128: return launch<32, 128>(p, st);
    case 48128: return launch<48, 128>(p, st);
    case 64128: return launch<64, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rk

}  // namespace vcg_sa

namespace vcg_sa {

enum Route { kServing = 0, kRing = 1, kMmaSync = 2 };

// The kernel a call at this shape takes: the serving kernel where it
// applies, else the faster of the ring and mma.sync kernels at the shape's
// (bs, hd) class as chip_smoke.py --time-kernels measured them at P 8 (B
// 8, L 3072, H 1024 / hd; device ms on an H100 SXM at 700 W): the ring
// kernel at bs 48 hd 64 (0.309 against 0.342), bs 64 hd 64 with other
// than 8 parts (0.272 against 0.400 at P 8), bs 64 hd 112 (0.400 against
// 0.470) and bs 64 hd 128 (0.334 against 0.460); the mma.sync kernel at
// the 28 other classes, by 1% (bs 48 hd 128) to 3.7x (bs 16 hd 80).
int route_for(int bs, int hd, int np, int nbq) {
  if (hw::takes(bs, hd, np, nbq)) return kServing;
  const bool ring = (bs == 48 && hd == 64) ||
                    (bs == 64 && (hd == 64 || hd == 112 || hd == 128));
  return ring ? kRing : kMmaSync;
}

}  // namespace vcg_sa

// q/out: the first middle row (row bs) of batch 0, rows h*hd apart,
// batches q_batch/o_batch elements apart (16-byte aligned); k/v contiguous
// [b, l, h, hd]; mask int32 [b, l] (1 keep, 0 pad; 16-byte aligned);
// ids/valid int32 [l/bs - 2, np]. bs in 16..64 and hd in 16..128,
// multiples of 16, np >= 1 (the wrapper checks). route: the kernel
// (vcg_sparse_band_route gives a shape's own): 0 the serving kernel, only
// where it applies, whose tables' first five columns must be
// structured_ids' (the wrapper checks; the kernel traps otherwise), 1 the
// ring kernel, 2 the mma.sync kernel; both take any shape and table.
extern "C" int vcg_sparse_band_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* ids, const void* valid, void* out, int b, int l, int h,
    int hd, int bs, int np, long long q_batch, long long o_batch, int route,
    void* stream) {
  using namespace vcg_sa;
  if (bs % 16 != 0 || bs < 16 || bs > kMaxBlock || hd % 16 != 0 ||
      hd < 16 || hd > kMaxHead || l % bs != 0 || l / bs < 3 || np < 1 ||
      (route == kServing && !hw::takes(bs, hd, np, l / bs - 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.mask = static_cast<const int*>(mask);
  p.ids = static_cast<const int*>(ids);
  p.valid = static_cast<const int*>(valid);
  p.out = static_cast<bf16*>(out);
  p.b = b; p.l = l; p.h = h; p.hd = hd; p.bs = bs; p.np = np;
  p.q_batch = q_batch; p.o_batch = o_batch;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kServing) return static_cast<int>(hw::launch(p, st));
  if (route == kRing) return static_cast<int>(rk::launch_any(p, st));
  switch (hd) {
    case 16: return static_cast<int>(ms::launch<16>(p, st));
    case 32: return static_cast<int>(ms::launch<32>(p, st));
    case 48: return static_cast<int>(ms::launch<48>(p, st));
    case 64: return static_cast<int>(ms::launch<64>(p, st));
    case 80: return static_cast<int>(ms::launch<80>(p, st));
    case 96: return static_cast<int>(ms::launch<96>(p, st));
    case 112: return static_cast<int>(ms::launch<112>(p, st));
    case 128: return static_cast<int>(ms::launch<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The route (0 serving, 1 ring, 2 mma.sync) of a call at this shape.
extern "C" int vcg_sparse_band_route(int bs, int hd, int np, int nbq) {
  return vcg_sa::route_for(bs, hd, np, nbq);
}
