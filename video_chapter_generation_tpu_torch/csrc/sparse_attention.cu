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
// The TPU kernel's scalar-prefetched id table, per-part BlockSpecs,
// 8-sublane penalty copy and head-major transposes are TPU mechanics and
// are not carried over: one thread block per (query block, head, batch)
// reads its own row of the id and valid tables, q, k and v through their
// natural [B, L, H, hd] strides, and the [B, L] mask.
//
// What bounds it on the H100: bytes. At the BigBird-Pegasus serving shape
// (B 8, L 3072, H 16, hd 64, bs 64, P 8) one layer moves ~197 MB (q, k,
// v and the output once) against ~4.9e10 flops: ~0.059 ms at 3.35 TB/s
// against ~0.050 ms at the bf16 tensor-core peak. Each (b, h) slice of k
// and v is 786 KB, so the ~8 re-reads of every key block (its band
// neighbours, the globals and the random picks) come from L2. The design:
// one warp per 16 query rows keeps its q fragments in registers for the
// whole loop; the P parts stream through a double-buffered shared-memory
// ring (cp.async, the next part's K/V tile and penalty row loading while
// this one computes); scores and the value product are mma.sync
// m16n8k16 bf16 -> float32 with an online softmax (running max and sum
// in float32), so no score row touches device memory; the context is
// divided by the sum and rounded to bf16 once. wgmma, TMA and a
// persistent schedule are left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vcg_sa {

using bf16 = __nv_bfloat16;
constexpr float kPenalty = -10000.0f;
constexpr int kMaxBlock = 64;  // key rows per part: 8 n-tiles of 8

struct Params {
  const bf16* q;       // query row 0 of block 1 of batch 0; rows h*hd apart
  const bf16* k;       // [b, l, h, hd] contiguous
  const bf16* v;       // [b, l, h, hd] contiguous
  const float* mask;   // [b, l], 1 keep / 0 pad
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
    const float* m = p.mask + static_cast<long long>(bb) * p.l + blk * bs;
    for (int r = threadIdx.x; r < bs; r += blockDim.x)
      pen(buf)[r] = (1.0f - m[r] * val) * kPenalty;
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

}  // namespace vcg_sa

// q/out: the first middle row (row bs) of batch 0, rows h*hd apart,
// batches q_batch/o_batch elements apart; k/v contiguous [b, l, h, hd];
// mask float32 [b, l]; ids/valid int32 [l/bs - 2, np]. bs in 16..64 and
// hd in 16..128, multiples of 16 (the wrapper checks).
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
  p.mask = static_cast<const float*>(mask);
  p.ids = static_cast<const int*>(ids);
  p.valid = static_cast<const int*>(valid);
  p.out = static_cast<bf16*>(out);
  p.b = b; p.l = l; p.h = h; p.bs = bs; p.np = np;
  p.q_batch = q_batch; p.o_batch = o_batch;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
