// The strip walk of the ResNet stems on Hopper (sm_90a): one persistent
// launch of stem_kernel computes the 7x7/2 conv (pad 3) of 4x4
// space-to-depth frames as the TPU kernel's phase-packed product on
// hopper_gemm.cuh's wgmma mainloop, then either pools it (K1, K8: the
// folded BN, ReLU and 3x3/2 max pool in the epilogue; stem_s2d.cu) or
// stores it for batch-statistics BN (K11's forward: the conv output and
// its moments; stem_train.cu).
//
//   - the product: the 4 conv-output phases (2I + pr, 2J + pc) of s2d cell
//     (I, J) are one row of A[cells, 448] x W[448, 256], k = (tap_r, tap_c,
//     ch48) over the 3x3 cell neighbourhood (432, zero-padded to 7 stages
//     of 64), n = (pr * 2 + pc) * 64 + f. W is the phase-packed im2col
//     weight (ops/stem.py:stem_weight_im2col, 229 KB: it stays in L2, not
//     in shared memory), streamed by TMA through a ring of 3 stages;
//   - a tile is a strip of 2 cell rows of one frame (2 ws <= 128 of its 128
//     rows). Its neighbourhood (cell rows 2s - 1 .. 2s + 2, one cell of
//     padding each side) comes into shared memory once a tile: u8 cells by
//     16-byte cp.async, normalized there, with the cells outside the frame
//     set to 0 after the normalize (the reference pads normalized frames,
//     never normalize(0)); bf16 frames by 8-byte cp.async (a cell's pixel
//     row is 12 contiguous values) straight into the same bf16 layout,
//     zero-filled outside. Each stage's A panel is 16-byte copies from it
//     by the thread that owns the row: no index math per element, no global
//     load per stage. The next tile's copies run under this tile's epilogue;
//   - the pooling epilogue (kTrain false) pools in the registers: the 3x3/2
//     window of output (I, J) covers conv rows 2I - 1 .. 2I + 1 and columns
//     2J - 1 .. 2J + 1, that is both column phases of cell (I, J), column
//     phase 1 of cell (I, J - 1) (the row before: a warp shuffle, one row a
//     warp through shared memory), and the column-pooled row phase 1 of
//     cell row I - 1, kept in shared memory: from this strip for its second
//     cell row, from the strip before for its first. It keeps the plain
//     version's roundings (the fp32 sum rounded to bf16, __fadd_rn(
//     __fmul_rn(v, s), b), the ReLU, a round to bf16, then the max) but
//     pools first: that chain is monotone in v (non-increasing where s < 0,
//     so those filters pool the negated values), so the max commutes with
//     it exactly and the affine runs once an output, not once for each of 4
//     phases;
//   - the training epilogue (kTrain true) rounds each sum to bf16 and
//     stores the strip's rows of yc in the phase-packed form [cells, 256]
//     (row = cell (n, I, J), column n above), straight from the
//     accumulators (store_tile), adding the column sums of the stored
//     values and of their squares to per-warp moment slots; the block's
//     slots are summed over its warps in order into one row [2][256] of
//     partial moments at the end. No float atomics: every sum has a fixed
//     order for a given grid;
//   - a persistent block walks bands of consecutive strips of a frame from
//     top to bottom; for the pool, a band that starts below the frame's
//     top first recomputes the strip above it for that carried row and
//     stores nothing from it (the training epilogue needs no carry and
//     recomputes nothing). The wrapper picks the bands a frame
//     (ops/stem.py:stem_bands) to balance the blocks' tile counts.
#pragma once

#include <math.h>

#include <algorithm>

#include "hopper_gemm.cuh"
#include "train_gemm.cuh"

// VCG_STEM_SKIP, for timing builds only (chip_smoke.py --time-kernels
// splits the kernel's time by part with them): 1 leaves out the products,
// 2 the A-panel builds, 3 the epilogue; the part costs about the full
// kernel's time less that build's. 0, the default, is the kernel.
#ifndef VCG_STEM_SKIP
#define VCG_STEM_SKIP 0
#endif

namespace vcg {
namespace {

using namespace hop;

constexpr int kStemN = 256;                 // 4 phases x 64 filters
constexpr int kStemK = 448;                 // 9 cells x 48 channels, padded
constexpr int kStemStages = kStemK / kHBK;  // 7
constexpr int kStemRing = 3;
constexpr int kMaxCells = 64;  // cells a frame row: a strip fills <= 128 rows
constexpr int kNbPitch = kMaxCells + 2;          // neighbourhood cells a row
constexpr int kNbBytes = 4 * kNbPitch * 96;      // bf16 [4][ws + 2][48]
constexpr int kRawBytes = 4 * kNbPitch * 48;     // the same cells in u8
constexpr int kCarryLd = 72;                     // bf16 pitch of a carry row
constexpr int kCarryElems = kBM * kCarryLd;
constexpr int kCarryBytes = 2 * kCarryElems * 2;  // two strips' rows
constexpr int kXchBytes = 8 * 1024;  // the row exchange, then store staging

// The training epilogue's moment slots: per warp (sum, sum of squares) of
// each of the 256 phase-packed columns; they take the carry rows' place.
using StemMoments = MomSlots<kStemN, 2, 8>;
static_assert(sizeof(StemMoments) <= kCarryBytes, "moment slots");

struct StemSrc {
  static constexpr int kStageBytes = kATile + kStemN * 128;
  static constexpr bool kTma = true;
  const CUtensorMap* wmap;
  const uint8_t* nb;  // shared memory: the tile's normalized neighbourhood
  int ws, rows;       // cells a frame row; valid rows of the current tile

  __device__ void load(uint8_t* st, uint64_t* bar, int, int kt) {
    if (threadIdx.x == 0) mbar_expect(bar, kStemN * 128);
    tma_w<kStemN>(st + kATile, wmap, kt * kHBK, 0, bar, 1);
  }

  // Thread i builds A row i / 2 from channel groups g = 4 kt + 2 (i % 2)
  // and g + 1 (16 channels, two 16-byte bf16 chunks each): group g < 27
  // is channels 16 (g % 3) .. of tap g / 3 = (tap_r, tap_c), the cell
  // (I + tap_r - 1, J + tap_c - 1) of the row's cell (I, J); groups past
  // 27, and rows past the strip, are zero.
  __device__ void xform(uint8_t* st, int, int kt) const {
    if (VCG_STEM_SKIP == 2) return;
    const int r = threadIdx.x >> 1;
    const int lr = r / ws, j = r - lr * ws;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * (threadIdx.x & 1) + h;
      const int g = 4 * kt + u;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (r < rows && g < 27) {
        const int tap = g / 3, cc = g - 3 * tap;
        const int tr = tap / 3, tc = tap - 3 * tr;
        const uint4* src = reinterpret_cast<const uint4*>(
            nb + ((lr + tr) * (ws + 2) + j + tc) * 96 + cc * 32);
        lo = src[0];
        hi = src[1];
      }
      *reinterpret_cast<uint4*>(st + swz(r, 2 * u)) = lo;
      *reinterpret_cast<uint4*>(st + swz(r, 2 * u + 1)) = hi;
    }
  }
};

struct StemArgs {
  const void* x;       // u8 cells [n][hs][ws][48], or bf16 frames [n][4 hs][4 ws][3]
  const float* scale;  // [64] the folded BN (8-byte aligned); pool only
  const float* bias;
  const float* norm;   // [6]: normalized = u8 * norm[c] + norm[3 + c]
  bf16* out;           // pool: [n][hs][ws][64]; training: yc [n hs ws][256]
  float* part;         // training: [grid][2][256] partial moments
  int n, hs, ws, bands;  // bands: a frame's
};

// The strips [lo, hi) of band b (frame b / bands); sp strips a frame.
__device__ __forceinline__ void band_strips(const StemArgs& a, int sp, int b,
                                            int& lo, int& hi) {
  const int bi = b % a.bands;
  lo = bi * sp / a.bands;
  hi = (bi + 1) * sp / a.bands;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 8 : 0));
}

// Cell (ci, cj) of frame fr lies inside it.
__device__ __forceinline__ bool inside(const StemArgs& a, int ci, int cj) {
  return ci >= 0 && ci < a.hs && cj >= 0 && cj < a.ws;
}

// This thread's copies of the neighbourhood of strip s of frame fr: cell
// (2s - 1 + rho, sigma - 1) at [rho][sigma] (rho < 4, sigma < ws + 2); u8
// cells into raw, bf16 frame rows into nb, zero-filled outside the frame.
template <bool kU8>
__device__ void fetch(const StemArgs& a, uint8_t* raw, uint8_t* nb, int fr,
                      int s) {
  const int pitch = a.ws + 2;
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  if (kU8) {
    for (int i = threadIdx.x; i < 12 * pitch; i += kThreads) {
      const int cell = i / 3, cc = i - 3 * cell;
      const int rho = cell / pitch, ci = 2 * s - 1 + rho;
      const int cj = cell - rho * pitch - 1;
      const bool ok = inside(a, ci, cj);
      const size_t off =
          ok ? ((static_cast<size_t>(fr) * a.hs + ci) * a.ws + cj) * 48 +
                   cc * 16
             : 0;
      cp_async16(raw + cell * 48 + cc * 16, x + off, ok);
    }
  } else {
    // pixel row dy of a cell: 4 pixels x 3 channels, 24 bytes as 3 x 8
    const size_t row_bytes = static_cast<size_t>(a.ws) * 24;
    for (int i = threadIdx.x; i < 48 * pitch; i += kThreads) {
      const int cell = i / 12, rem = i - 12 * cell;
      const int dy = rem / 3, p = rem - 3 * dy;
      const int rho = cell / pitch, ci = 2 * s - 1 + rho;
      const int cj = cell - rho * pitch - 1;
      const bool ok = inside(a, ci, cj);
      const size_t off =
          ok ? (static_cast<size_t>(fr) * 4 * a.hs + 4 * ci + dy) * row_bytes +
                   cj * 24 + p * 8
             : 0;
      cp_async8(nb + cell * 96 + dy * 24 + p * 8, x + off, ok);
    }
  }
}

// The u8 neighbourhood of strip s normalized into nb as bf16 (two roundings,
// no FMA: the plain version's float ops), cells outside the frame 0.
__device__ void normalize(const StemArgs& a, const float (&na)[3],
                          const float (&nbias)[3], const uint8_t* raw,
                          uint8_t* nb, int s) {
  const int pitch = a.ws + 2;
  for (int i = threadIdx.x; i < 12 * pitch; i += kThreads) {
    const int cell = i / 3, cc = i - 3 * cell;
    const int rho = cell / pitch;
    uint32_t o[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (inside(a, 2 * s - 1 + rho, cell - rho * pitch - 1)) {
      const uint4 v = *reinterpret_cast<const uint4*>(raw + cell * 48 + cc * 16);
      const uint8_t* u = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        float f[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          // channel 16 cc + e + d has colour (cc + e + d) % 3 (16 = 1 mod 3)
          const int c = (cc + e + d) % 3;
          const float sc = c == 0 ? na[0] : (c == 1 ? na[1] : na[2]);
          const float bi = c == 0 ? nbias[0] : (c == 1 ? nbias[1] : nbias[2]);
          f[d] = __fadd_rn(__fmul_rn(static_cast<float>(u[e + d]), sc), bi);
        }
        o[e / 2] = pack2(f[0], f[1]);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(nb + cell * 96 + cc * 32);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// The normalize constants of a u8 input (zeros for bf16 frames).
__device__ __forceinline__ void norm_consts(const StemArgs& a, bool u8,
                                            float (&na)[3], float (&nbias)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    na[c] = u8 ? a.norm[c] : 0.0f;
    nbias[c] = u8 ? a.norm[3 + c] : 0.0f;
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue of one strip from the accumulators, in wgmma's layout at BN
// 256: a lane holds columns 8 j + 2 (lane % 4) and + 1 of rows r0 = 16 warp
// + lane / 4 (acc[4 j], acc[4 j + 1]) and r0 + 8 (acc[4 j + 2], + 3);
// phase j / 8, filter f = 8 (j % 8) + 2 (lane % 4) (+ 1). Tile row r is
// cell (I0 + r / ws, r % ws). The pool runs before the affine, on t = the
// conv output rounded to bf16, negated where the filter's BN scale is
// negative: y = bf16(relu(t' s + b)) is then non-decreasing in t, so the
// max of the y is y of the max of the t, exactly, and the affine runs on
// 64 values a row instead of 256. A missing neighbour counts as -inf.
// cur: this strip's carry rows (its column-pooled row phase 1), prev: the
// strip before's (used where up_prev).
__device__ void stem_epilogue(float (&acc)[kStemN / 2], const StemArgs& a,
                              float* xch, bf16* cur, const bf16* prev,
                              int valid, bool up_prev, bool store,
                              size_t cell0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
  const int ws = a.ws;
  const float lost = -INFINITY;
  if (VCG_STEM_SKIP == 3) {  // keeps the products: one value a tile
    if (threadIdx.x == 0 && store) a.out[cell0 * 64] = __float2bfloat16_rn(acc[0]);
    return;
  }
  // t: the conv output rounded to bf16, sign-flipped where s < 0
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 s = __ldg(reinterpret_cast<const float2*>(a.scale + 8 * jj +
                                                           2 * q));
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = acc[4 * (jj + 8 * ph) + e];
        v = bf16r(v);
        if (((e & 1) ? s.y : s.x) < 0.0f) v = -v;
      }
  }
  // row 16 warp + 15's column phase 1, for the next warp's first row
  if (lane >= 28) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int f = 8 * jj + 2 * q + d;
        xch[(2 * warp) * 64 + f] = acc[4 * (jj + 8) + 2 + d];
        xch[(2 * warp + 1) * 64 + f] = acc[4 * (jj + 24) + 2 + d];
      }
  }
  __syncthreads();
  // the column pool of each row phase: both column phases of the cell and
  // column phase 1 of the cell to its left (none at J = 0). Row phase 0's
  // goes to the phase-0 slots, row phase 1's to the phase-1 slots and to
  // the carry.
  const int src = (lane + 28) & 31;  // row r0 - 1 where lane >= 4
  const bool left_lo = r0 % ws != 0, left_hi = (r0 + 8) % ws != 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float cp[2][2][2];  // [row phase][lo / hi row][d]
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int i0 = 4 * (jj + 16 * pr) + d;      // column phase 0
        const int i1 = 4 * (jj + 16 * pr + 8) + d;  // column phase 1
        const float sl = __shfl_sync(0xffffffffu, acc[i1], src);
        const float sh = __shfl_sync(0xffffffffu, acc[i1 + 2], src);
        float l0 = lane >= 4 ? sl
                             : (warp > 0 ? xch[(2 * (warp - 1) + pr) * 64 +
                                               8 * jj + 2 * q + d]
                                         : lost);
        float l1 = lane >= 4 ? sh : sl;
        l0 = left_lo ? l0 : lost;
        l1 = left_hi ? l1 : lost;
        cp[pr][0][d] = fmaxf(fmaxf(acc[i0], acc[i1]), l0);
        cp[pr][1][d] = fmaxf(fmaxf(acc[i0 + 2], acc[i1 + 2]), l1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        acc[4 * jj + 2 * h + d] = cp[0][h][d];
        acc[4 * (jj + 8) + 2 * h + d] = cp[1][h][d];
      }
      *reinterpret_cast<uint32_t*>(cur + (r0 + 8 * h) * kCarryLd + 8 * jj +
                                   2 * q) = pack2(cp[1][h][0], cp[1][h][1]);
    }
  }
  __syncthreads();
  // the pool: the two row phases' column pools and row phase 1 of the cell
  // row above (this strip's first row, else the strip before's second);
  // then the affine, the ReLU and the round to bf16 (the plain version's
  // float operations: two roundings, no FMA)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int lr = r / ws;
    const bf16* up = r >= valid ? nullptr
                     : lr == 1  ? cur + (r - ws) * kCarryLd
                     : up_prev  ? prev + (ws + r) * kCarryLd
                                : nullptr;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 u =
          up != nullptr
              ? unpack2(*reinterpret_cast<const uint32_t*>(up + 8 * jj + 2 * q))
              : make_float2(lost, lost);
      const float2 s = __ldg(reinterpret_cast<const float2*>(a.scale + 8 * jj +
                                                             2 * q));
      const float2 b = __ldg(reinterpret_cast<const float2*>(a.bias + 8 * jj +
                                                             2 * q));
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float& v = acc[4 * jj + 2 * h + d];
        const float sc = d ? s.y : s.x;
        float t = fmaxf(fmaxf(v, acc[4 * (jj + 8) + 2 * h + d]),
                        d ? u.y : u.x);
        if (sc < 0.0f) t = -t;
        v = bf16r(fmaxf(__fadd_rn(__fmul_rn(t, sc), d ? b.y : b.x), 0.0f));
      }
    }
  }
  if (store)
    store_tile<64>(reinterpret_cast<uint8_t*>(xch) + warp * 1024,
                   reinterpret_cast<const float(&)[32]>(acc), Identity{},
                   a.out + cell0 * 64, 64, 16 * warp, valid, 0, nullptr,
                   nullptr);
}

constexpr int kStemSmem = kStemRing * StemSrc::kStageBytes + kNbBytes +
                          kRawBytes + kCarryBytes + kXchBytes + kAlignSlack;

// kTrain: no pool; the strip's conv output rounded to bf16 goes to yc =
// a.out as [cells][256] rows from cell0, and its column moments to this
// warp's slots in ms.
template <bool kU8, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
    stem_kernel(StemArgs a, const __grid_constant__ CUtensorMap wmap) {
  __shared__ alignas(8) uint64_t bars[kStemRing];
  uint8_t* sm = aligned_smem();
  uint8_t* nb = sm + kStemRing * StemSrc::kStageBytes;
  uint8_t* raw = nb + kNbBytes;
  bf16* carry = reinterpret_cast<bf16*>(raw + kRawBytes);
  float* xch = reinterpret_cast<float*>(raw + kRawBytes + kCarryBytes);
  StemMoments& ms = *reinterpret_cast<StemMoments*>(carry);
  if (threadIdx.x == 0) tma_prefetch(&wmap);
  if (kTrain) ms.zero();
  float na[3], nbias[3];
  norm_consts(a, kU8, na, nbias);
  // a band that starts below the frame's top is preceded by the strip
  // above it where the pool needs that strip's carry
  constexpr bool kHalo = !kTrain;
  const int sp = (a.hs + 1) / 2, bands = a.n * a.bands;
  int tiles = 0;
  for (int b = blockIdx.x; b < bands; b += gridDim.x) {
    int lo, hi;
    band_strips(a, sp, b, lo, hi);
    tiles += hi - lo + (kHalo && lo > 0);
  }
  StemSrc src{&wmap, nb, a.ws, 0};
  Mainloop<kStemN, kStemRing, 0, StemSrc> ml(sm, bars, src, tiles,
                                             kStemStages);
  int b = blockIdx.x, lo = 0, hi = 0;
  band_strips(a, sp, b, lo, hi);
  int s = kHalo && lo > 0 ? lo - 1 : lo;
  if (tiles > 0) fetch<kU8>(a, raw, nb, b / a.bands, s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (kU8 && tiles > 0) {
    normalize(a, na, nbias, raw, nb, s);
    __syncthreads();
  }
  float acc[kStemN / 2];
  for (int i = 0; i < tiles; ++i) {
    const int fr = b / a.bands;
    const int rows = min(2, a.hs - 2 * s) * a.ws;
    const bool halo = s < lo;
    src.rows = rows;
    if (VCG_STEM_SKIP == 1) {
      ml.k_loop([](const uint8_t*, int) {}, [] {});
#pragma unroll
      for (int k = 0; k < kStemN / 2; ++k) acc[k] = 0.0f;
    } else {
      ml.tile(acc);
    }
    // the next tile: this band's next strip, else the next band's first;
    // its copies run under this tile's epilogue
    int nb_ = b, ns = s + 1, nlo = lo, nhi = hi;
    if (ns >= hi) {
      nb_ = b + gridDim.x;
      if (nb_ < bands) {
        band_strips(a, sp, nb_, nlo, nhi);
        ns = kHalo && nlo > 0 ? nlo - 1 : nlo;
      }
    }
    if (i + 1 < tiles) fetch<kU8>(a, raw, nb, nb_ / a.bands, ns);
    cp_async_commit();
    const size_t cell0 = (static_cast<size_t>(fr) * a.hs + 2 * s) * a.ws;
    if (kTrain) {
      if (VCG_STEM_SKIP != 3)
        store_tile<kStemN>(reinterpret_cast<uint8_t*>(xch) +
                               (threadIdx.x >> 5) * 1024,
                           acc, Identity{}, a.out + cell0 * kStemN, kStemN,
                           16 * (threadIdx.x >> 5), rows, 0, ms.s0(),
                           ms.s1());
    } else {
      stem_epilogue(acc, a, xch, carry + (i & 1) * kCarryElems,
                    carry + ((i & 1) ^ 1) * kCarryElems, rows,
                    s > 0 && !halo, !halo, cell0);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (kU8 && i + 1 < tiles) {
      normalize(a, na, nbias, raw, nb, ns);
      __syncthreads();
    }
    b = nb_;
    s = ns;
    lo = nlo;
    hi = nhi;
  }
  ml.finish();
  if (kTrain) ms.store(a.part, kStemN, 0);
}

// One launch of the stem over a (x, out and the BN or the moments in a), w
// the phase-packed weight [448][256] bf16; a persistent grid of at most one
// block an SM. *grid: the blocks launched (the training moments' rows).
template <bool kU8, bool kTrain>
int launch_stem(const StemArgs& a, const void* w, cudaStream_t st,
                int* grid = nullptr) {
  if (a.ws > kMaxCells || a.ws < 1 || a.hs < 1 || a.bands < 1 ||
      a.bands > (a.hs + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap;
  cudaError_t e = tensor_map(&wmap, w, kStemK, kStemN, kHBK);
  int held = 0;
  if (e == cudaSuccess) e = resident<stem_kernel<kU8, kTrain>>(kStemSmem, &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::max(1, std::min(a.n * a.bands, held));
  if (grid != nullptr) *grid = blocks;
  stem_kernel<kU8, kTrain><<<blocks, kThreads, kStemSmem, st>>>(a, wmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vcg
