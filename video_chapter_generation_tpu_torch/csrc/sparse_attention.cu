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
// and sum in float32, the probabilities rounded to bf16 for the value
// product, the context divided by the sum and rounded once; the serving
// shape's kernel runs two such softmaxes over the two halves of the parts
// and merges them). The TPU
// kernel's scalar-prefetched id table, per-part BlockSpecs, 8-sublane
// penalty copy and head-major transposes are TPU mechanics and are not
// carried over.
//
// What bounds it on the H100: bytes. At the BigBird-Pegasus serving shape
// (B 8, L 3072, H 16, hd 64, bs 64, P 8) one layer moves ~197 MB (q, k,
// v and the output once) against ~4.9e10 flops: ~0.059 ms at 3.35 TB/s
// against ~0.050 ms at the bf16 tensor-core peak.
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
// Both products are wgmma m64n64k16 from hopper_gemm.cuh: S = Q K^T with
// Q and K both K-major 128-byte-swizzled tiles (hd 64 = one row), and
// O += P V with P from registers (the score accumulators rounded to bf16
// pairs) and V an MN-major tile (the transpose bit). The two warpgroups
// take the first and the second half of the parts (the first global and
// the band; the last global and the random blocks) with an online softmax
// each, in log2 units (one ex2 a probability); a part's softmax runs while
// the next part's scores and the last part's context product are in
// flight. Both warpgroups issue the same products, unbranched (a product
// under a branch is serialized by the compiler). Then the warpgroups
// merge the two softmaxes by rows, each warp of one handing its context,
// row max and row sum through shared memory to the warp of the same rows
// in the other, which rescales both to the larger max and stores them.
// The block's ranges split the 128 (b, h) rows of 46 query blocks of the
// serving shape evenly over the 132 SMs (44 or 45 query blocks a block, a
// range crossing at most one row boundary, where the resident blocks are
// reloaded): whole rows would leave 4 SMs idle, shorter segments would
// reload the globals and band more often.
//
// sparse_band_kernel, every other shape (bs 16..64, hd 16..128): one
// thread block per (query block, head, batch) reads its P parts through a
// double-buffered cp.async ring; mma.sync m16n8k16 for both products, one
// warp per 16 query rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"


namespace vcg_sa {

using bf16 = __nv_bfloat16;
constexpr float kPenalty = -10000.0f;
constexpr int kMaxBlock = 64;  // key rows per part: 8 n-tiles of 8

struct Params {
  const bf16* q;       // query row 0 of block 1 of batch 0; rows h*hd apart
  const bf16* k;       // [b, l, h, hd] contiguous
  const bf16* v;       // [b, l, h, hd] contiguous
  const int* mask;     // [b, l], 1 keep / 0 pad
  const int* ids;      // [nbq, np] attended key block per slot
  const int* valid;    // [nbq, np] 0 on a slot the band already covers
  bf16* out;           // output row 0 of block 1 of batch 0; rows h*hd apart
  int b, l, h, bs, np;
  long long q_batch, o_batch;  // batch strides of q and out, in elements
  float scale;
};

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

// two floats -> bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
static cudaError_t launch(const Params& p, cudaStream_t stream) {
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

}  // namespace vcg_sa

// q/out: the first middle row (row bs) of batch 0, rows h*hd apart,
// batches q_batch/o_batch elements apart; k/v contiguous [b, l, h, hd];
// mask int32 [b, l] (1 keep, 0 pad); ids/valid int32 [l/bs - 2, np]. bs
// in 16..64 and hd in 16..128, multiples of 16 (the wrapper checks). bs 64
// and hd 64 with 8 parts take the wgmma kernel (vcg_sparse_band_wgmma),
// whose tables' first five columns must be structured_ids' (the wrapper
// checks; the kernel traps otherwise), every other shape the mma.sync
// kernel. k, v and q rows 16-byte aligned.
extern "C" int vcg_sparse_band_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* ids, const void* valid, void* out, int b, int l, int h,
    int hd, int bs, int np, long long q_batch, long long o_batch,
    void* stream) {
  using namespace vcg_sa;
  if (bs % 16 != 0 || bs < 16 || bs > kMaxBlock || l % bs != 0 ||
      l / bs < 3 || np < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.mask = static_cast<const int*>(mask);
  p.ids = static_cast<const int*>(ids);
  p.valid = static_cast<const int*>(valid);
  p.out = static_cast<bf16*>(out);
  p.b = b; p.l = l; p.h = h; p.bs = bs; p.np = np;
  p.q_batch = q_batch; p.o_batch = o_batch;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hw::takes(bs, hd, np, l / bs - 2))
    return static_cast<int>(hw::launch(p, st));
  switch (hd) {
    case 16: return static_cast<int>(launch<16>(p, st));
    case 32: return static_cast<int>(launch<32>(p, st));
    case 48: return static_cast<int>(launch<48>(p, st));
    case 64: return static_cast<int>(launch<64>(p, st));
    case 80: return static_cast<int>(launch<80>(p, st));
    case 96: return static_cast<int>(launch<96>(p, st));
    case 112: return static_cast<int>(launch<112>(p, st));
    case 128: return static_cast<int>(launch<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 1 where a call at this shape takes the wgmma kernel, 0 where it takes
// the mma.sync kernel.
extern "C" int vcg_sparse_band_wgmma(int bs, int hd, int np, int nbq) {
  return vcg_sa::hw::takes(bs, hd, np, nbq) ? 1 : 0;
}
