// The strip walk of the ResNet stems on Hopper (sm_90a): one persistent
// launch of stem_kernel computes the 7x7/2 conv (pad 3) of 4x4
// space-to-depth frames as the TPU kernel's phase-packed product on
// hopper_gemm.cuh's wgmma mainloop, then either pools it (K1, K8: the
// folded BN, ReLU and 3x3/2 max pool in the epilogue; stem_s2d.cu) or
// stores it for batch-statistics BN (K11's forward: the conv output and
// its moments; stem_train.cu). stem_i8_kernel, the third mode (K14b,
// stem_s2d.cu), walks the same tiles with an int8 product.
//
//   - the product: the 4 conv-output phases (2I + pr, 2J + pc) of s2d cell
//     (I, J) are one row of A[cells, 448] x W[448, 256], k = (tap_r, tap_c,
//     ch48) over the 3x3 cell neighbourhood (432, zero-padded to 7 stages
//     of 64), n = (pr * 2 + pc) * 64 + f. W is the phase-packed im2col
//     weight (ops/stem.py:stem_weight_im2col, 229 KB: it stays in L2, not
//     in shared memory), streamed by TMA through a ring of 3 stages;
//   - a tile is a strip of 2 cell rows of one column chunk of a frame (2 wt
//     <= 128 of its 128 rows): a frame row of up to 64 cells is one chunk,
//     a wider one is cut into chunks of at most 63 output cells
//     (stem_chunks), and for the pool a chunk after the first also
//     computes the cell left of its first, whose column phase 1 its first
//     window needs, and stores nothing of it. The tile's neighbourhood
//     (cell rows 2s - 1 .. 2s + 2, one cell beyond the chunk each side)
//     comes into shared memory once a tile, the real cells across a chunk
//     seam, zeros only outside the frame: u8 cells by 16-byte cp.async,
//     normalized there, with the cells outside the frame set to 0 after
//     the normalize (the reference pads normalized frames, never
//     normalize(0)); bf16 frames by 8-byte cp.async (a cell's pixel row is
//     12 contiguous values) straight into the same bf16 layout,
//     zero-filled outside. Each stage's A panel is 16-byte copies from it
//     by the thread that owns the row: no index math per element, no
//     global load per stage. The next tile's copies run under this tile's
//     epilogue;
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
//     accumulators (store_tile, the tile's two cell rows placed as two runs
//     of cells), adding the column sums of the stored values and of their
//     squares to per-warp moment slots; the block's slots are summed over
//     its warps in order into one row [2][256] of partial moments at the
//     end. Its chunks hold no extra cell. No float atomics: every sum has a
//     fixed order for a given grid;
//   - a persistent block walks bands of consecutive strips of a column
//     chunk from top to bottom; for the pool, a band that starts below the
//     frame's top first recomputes the strip above it for that carried row
//     and stores nothing from it (the training epilogue needs no carry and
//     recomputes nothing). The wrapper picks the bands a chunk
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
constexpr int kMaxCells = 64;  // cells a tile row: a strip fills <= 128 rows
constexpr int kNbPitch = kMaxCells + 2;          // neighbourhood cells a row
constexpr int kNbBytes = 4 * kNbPitch * 96;      // bf16 [4][wt + 2][48]
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
  int wt, rows;       // cells a tile row; valid rows of the current tile

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
    const int lr = r / wt, j = r - lr * wt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * (threadIdx.x & 1) + h;
      const int g = 4 * kt + u;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (r < rows && g < 27) {
        const int tap = g / 3, cc = g - 3 * tap;
        const int tr = tap / 3, tc = tap - 3 * tr;
        const uint4* src = reinterpret_cast<const uint4*>(
            nb + ((lr + tr) * (wt + 2) + j + tc) * 96 + cc * 32);
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
  const float* scale;  // pool: [64] the folded BN (8-byte aligned);
  const float* bias;   // int8: sv [256] and wb [10][256]
  const float* norm;   // [6]: normalized = u8 * norm[c] + norm[3 + c]
  bf16* out;           // pool: [n][hs][ws][64]; training: yc [n hs ws][256]
  float* part;         // training: [grid][2][256] partial moments
  int n, hs, ws;
  int chunks;          // column chunks a frame row (stem_chunks)
  int bands;           // bands of strips a column chunk
};

// Column chunks of a frame row: one up to kMaxCells cells, else chunks of
// at most kMaxCells - 1 output cells, so that a pooling tile also holds
// the cell left of its first (ops/stem.py:stem_chunks is the same rule).
__host__ __device__ __forceinline__ int stem_chunks(int ws) {
  return ws <= kMaxCells ? 1 : (ws + kMaxCells - 2) / (kMaxCells - 1);
}

// One tile of the walk: strip s (cell rows 2 s, 2 s + 1) of frame fr, over
// the output cells [c0, c1) of column chunk ck; it computes the cells
// [cb, c1), wt of them: for the pool (kPool) a chunk after the first
// starts one cell to the left, whose column phase 1 is the left
// neighbour of c0's window, and stores nothing of that cell. The kernels
// come in two builds: kWide false for one chunk a row (frames up to 256
// px: the tile width is the frame's, a kernel constant, so the index
// arithmetic that depends on it leaves the tile loop), true for more.
struct StemTile {
  int fr, s, c0, cb, wt;
};

template <bool kPool, bool kWide>
__device__ __forceinline__ StemTile stem_tile(const StemArgs& a, int unit,
                                              int s) {
  if (!kWide) return StemTile{unit, s, 0, 0, a.ws};
  const int fr = unit / a.chunks, ck = unit - fr * a.chunks;
  const int c0 = ck * a.ws / a.chunks, c1 = (ck + 1) * a.ws / a.chunks;
  const int cb = kPool && ck > 0 ? c0 - 1 : c0;
  return StemTile{fr, s, c0, cb, c1 - cb};
}

// store_tile's placement of a tile's rows: tile row r = (lr, j) (r =
// lr wt + j) is cell (2 s + lr, cb + j) of the frame; the columns left of
// c0 are stored nowhere.
struct StemRows {
  size_t row0;  // the cell (fr, 2 s, cb)
  int wt, ws, skip;

  __device__ StemRows(const StemArgs& a, const StemTile& t)
      : row0((static_cast<size_t>(t.fr) * a.hs + 2 * t.s) * a.ws + t.cb),
        wt(t.wt), ws(a.ws), skip(t.c0 - t.cb) {}
  __device__ bool ok(int r) const { return skip == 0 || r % wt >= skip; }
  __device__ size_t at(int r) const {
    if (wt == ws) return row0 + r;  // one chunk a row: one run of cells
    const int lr = r / wt;
    return row0 + static_cast<size_t>(lr) * ws + (r - lr * wt);
  }
};

// The strips [lo, hi) of band b (column chunk b / bands); sp strips a frame.
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

// Cell (ci, cj) lies inside the frame.
__device__ __forceinline__ bool inside(const StemArgs& a, int ci, int cj) {
  return ci >= 0 && ci < a.hs && cj >= 0 && cj < a.ws;
}

// This thread's copies of tile t's neighbourhood: cell (2s - 1 + rho,
// cb - 1 + sigma) at [rho][sigma] (rho < 4, sigma < wt + 2); u8 cells
// into raw, bf16 frame rows into nb, zero-filled outside the frame only
// (a chunk seam reads the real cells beyond it).
template <bool kU8>
__device__ void fetch(const StemArgs& a, uint8_t* raw, uint8_t* nb,
                      const StemTile& t) {
  const int pitch = t.wt + 2;
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  if (kU8) {
    for (int i = threadIdx.x; i < 12 * pitch; i += kThreads) {
      const int cell = i / 3, cc = i - 3 * cell;
      const int rho = cell / pitch, ci = 2 * t.s - 1 + rho;
      const int cj = t.cb + cell - rho * pitch - 1;
      const bool ok = inside(a, ci, cj);
      const size_t off =
          ok ? ((static_cast<size_t>(t.fr) * a.hs + ci) * a.ws + cj) * 48 +
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
      const int rho = cell / pitch, ci = 2 * t.s - 1 + rho;
      const int cj = t.cb + cell - rho * pitch - 1;
      const bool ok = inside(a, ci, cj);
      const size_t off =
          ok ? (static_cast<size_t>(t.fr) * 4 * a.hs + 4 * ci + dy) *
                       row_bytes +
                   cj * 24 + p * 8
             : 0;
      cp_async8(nb + cell * 96 + dy * 24 + p * 8, x + off, ok);
    }
  }
}

// The u8 neighbourhood of tile t normalized into nb as bf16 (two
// roundings, no FMA: the plain version's float ops), cells outside the
// frame 0.
__device__ void normalize(const StemArgs& a, const float (&na)[3],
                          const float (&nbias)[3], const uint8_t* raw,
                          uint8_t* nb, const StemTile& t) {
  const int pitch = t.wt + 2;
  for (int i = threadIdx.x; i < 12 * pitch; i += kThreads) {
    const int cell = i / 3, cc = i - 3 * cell;
    const int rho = cell / pitch;
    uint32_t o[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (inside(a, 2 * t.s - 1 + rho, t.cb + cell - rho * pitch - 1)) {
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

// The pooling epilogue of one tile from the accumulators, in wgmma's
// layout at BN 256: a lane holds columns 8 j + 2 (lane % 4) and + 1 of
// rows r0 = 16 warp + lane / 4 (acc[4 j], acc[4 j + 1]) and r0 + 8
// (acc[4 j + 2], + 3); phase j / 8, filter f = 8 (j % 8) + 2 (lane % 4)
// (+ 1). Tile row r is cell (2 s + r / wt, cb + r % wt). The pool runs
// before the affine, on t = the conv output rounded to bf16, negated
// where the filter's BN scale is negative: y = bf16(relu(t' s + b)) is
// then non-decreasing in t, so the max of the y is y of the max of the t,
// exactly, and the affine runs on 64 values a row instead of 256. A
// missing neighbour counts as -inf. cur: this tile's carry rows (its
// column-pooled row phase 1, by tile row); up_prev: the carry of the cell
// row above the tile's first, by column (null: none).
__device__ void stem_epilogue(float (&acc)[kStemN / 2], const StemArgs& a,
                              const StemTile& t, float* xch, bf16* cur,
                              const bf16* up_prev, int valid, bool store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
  const int wt = t.wt;
  const float lost = -INFINITY;
  if (VCG_STEM_SKIP == 3) {  // keeps the products: one value a tile
    if (threadIdx.x == 0 && store)
      a.out[StemRows(a, t).at(0) * 64] = __float2bfloat16_rn(acc[0]);
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
  // column phase 1 of the cell to its left (none at the tile's first
  // column: the frame's edge, or a column stored nowhere). Row phase 0's
  // goes to the phase-0 slots, row phase 1's to the phase-1 slots and to
  // the carry.
  const int src = (lane + 28) & 31;  // row r0 - 1 where lane >= 4
  const bool left_lo = r0 % wt != 0, left_hi = (r0 + 8) % wt != 0;
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
  // row above (this tile's first row, else the carry of the row above it);
  // then the affine, the ReLU and the round to bf16 (the plain version's
  // float operations: two roundings, no FMA)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int lr = r / wt;
    const bf16* up = r >= valid ? nullptr
                     : lr == 1  ? cur + (r - wt) * kCarryLd
                     : up_prev  ? up_prev + r * kCarryLd
                                : nullptr;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 u =
          up != nullptr
              ? unpack2(*reinterpret_cast<const uint32_t*>(up + 8 * jj + 2 * q))
              : make_float2(lost, lost);
      const float2 s =
          __ldg(reinterpret_cast<const float2*>(a.scale + 8 * jj + 2 * q));
      const float2 b =
          __ldg(reinterpret_cast<const float2*>(a.bias + 8 * jj + 2 * q));
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float& v = acc[4 * jj + 2 * h + d];
        const float sc = d ? s.y : s.x;
        float m = fmaxf(fmaxf(v, acc[4 * (jj + 8) + 2 * h + d]),
                        d ? u.y : u.x);
        if (sc < 0.0f) m = -m;
        v = bf16r(fmaxf(__fadd_rn(__fmul_rn(m, sc), d ? b.y : b.x), 0.0f));
      }
    }
  }
  if (store)
    store_tile<64>(reinterpret_cast<uint8_t*>(xch) + warp * 1024,
                   reinterpret_cast<const float(&)[32]>(acc), Identity{},
                   a.out, 64, 16 * warp, valid, 0, nullptr, nullptr,
                   StemRows(a, t));
}

constexpr int kStemSmem = kStemRing * StemSrc::kStageBytes + kNbBytes +
                          kRawBytes + kCarryBytes + kXchBytes + kAlignSlack;

// The walk's position: band b of strips [lo, hi) and strip s; its tile is
// the strip's column chunk of frame unit / chunks (unit = b / bands). A
// band that starts below the frame's top is preceded, where kHalo (the
// pool's carry), by the strip above it, which stores nothing.
template <bool kHalo, bool kWide>
struct StemWalk {
  int b, lo, hi, s;

  __device__ StemWalk(const StemArgs& a, int b0) : b(b0), lo(0), hi(0), s(0) {
    if (b < bands(a)) start(a);
  }
  __device__ static int bands(const StemArgs& a) {
    return a.n * a.chunks * a.bands;
  }
  __device__ void start(const StemArgs& a) {
    band_strips(a, (a.hs + 1) / 2, b, lo, hi);
    s = kHalo && lo > 0 ? lo - 1 : lo;
  }
  // this block's tiles over the whole walk
  __device__ static int count(const StemArgs& a) {
    int n = 0;
    for (int c = blockIdx.x; c < bands(a); c += gridDim.x) {
      int l, h;
      band_strips(a, (a.hs + 1) / 2, c, l, h);
      n += h - l + (kHalo && l > 0);
    }
    return n;
  }
  __device__ StemTile tile(const StemArgs& a) const {
    return stem_tile<kHalo, kWide>(a, b / a.bands, s);
  }
  __device__ bool halo() const { return s < lo; }
  __device__ int rows(const StemArgs& a, const StemTile& t) const {
    return min(2, a.hs - 2 * s) * t.wt;
  }
  // the next tile: this band's next strip, else the next band's first
  __device__ void next(const StemArgs& a) {
    if (++s >= hi) {
      b += gridDim.x;
      if (b < bands(a)) start(a);
    }
  }
};

// kTrain: no pool; the strip's conv output rounded to bf16 goes to yc =
// a.out as [cells][256] rows, and its column moments to this warp's slots
// in ms.
template <bool kU8, bool kTrain, bool kWide>
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
  using Walk = StemWalk<!kTrain, kWide>;
  Walk w(a, blockIdx.x);
  const int tiles = Walk::count(a);
  StemSrc src{&wmap, nb, 0, 0};
  Mainloop<kStemN, kStemRing, 0, StemSrc> ml(sm, bars, src, tiles,
                                             kStemStages);
  if (tiles > 0) {
    const StemTile t = w.tile(a);
    fetch<kU8>(a, raw, nb, t);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (kU8) {
      normalize(a, na, nbias, raw, nb, t);
      __syncthreads();
    }
  }
  float acc[kStemN / 2];
  for (int i = 0; i < tiles; ++i) {
    const StemTile here = w.tile(a);
    const int rows = w.rows(a, here);
    const bool halo = w.halo(), top = w.s == 0;
    src.wt = here.wt;
    src.rows = rows;
    if (VCG_STEM_SKIP == 1) {
      ml.k_loop([](const uint8_t*, int) {}, [] {});
#pragma unroll
      for (int k = 0; k < kStemN / 2; ++k) acc[k] = 0.0f;
    } else {
      ml.tile(acc);
    }
    // the next tile's copies run under this tile's epilogue
    w.next(a);
    if (i + 1 < tiles) fetch<kU8>(a, raw, nb, w.tile(a));
    cp_async_commit();
    if (kTrain) {
      if (VCG_STEM_SKIP != 3)
        store_tile<kStemN>(reinterpret_cast<uint8_t*>(xch) +
                               (threadIdx.x >> 5) * 1024,
                           acc, Identity{}, a.out, kStemN,
                           16 * (threadIdx.x >> 5), rows, 0, ms.s0(),
                           ms.s1(), StemRows(a, here));
    } else {
      bf16* cur = carry + (i & 1) * kCarryElems;
      const bf16* prev = carry + ((i & 1) ^ 1) * kCarryElems;
      stem_epilogue(acc, a, here, xch, cur,
                    top || halo ? nullptr : prev + here.wt * kCarryLd, rows,
                    !halo);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (kU8 && i + 1 < tiles) {
      normalize(a, na, nbias, raw, nb, w.tile(a));
      __syncthreads();
    }
  }
  ml.finish();
  if (kTrain) ms.store(a.part, kStemN, 0);
}

// The walk's arguments are usable: sizes, and bands a column chunk.
inline bool stem_args_ok(const StemArgs& a) {
  return a.ws >= 1 && a.hs >= 1 && a.n >= 1 && a.bands >= 1 &&
         a.bands <= (a.hs + 1) / 2;
}

// One launch of the stem over a (x, out and the BN or the moments in a), w
// the phase-packed weight [448][256] bf16; a persistent grid of at most one
// block an SM. *grid: the blocks launched (the training moments' rows).
template <bool kU8, bool kTrain, bool kWide>
int launch_stem_build(const StemArgs& a, const CUtensorMap& wmap,
                      cudaStream_t st, int* grid) {
  int held = 0;
  const cudaError_t e =
      resident<stem_kernel<kU8, kTrain, kWide>>(kStemSmem, &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::max(1, std::min(a.n * a.chunks * a.bands, held));
  if (grid != nullptr) *grid = blocks;
  stem_kernel<kU8, kTrain, kWide><<<blocks, kThreads, kStemSmem, st>>>(a,
                                                                       wmap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kU8, bool kTrain>
int launch_stem(const StemArgs& a, const void* w, cudaStream_t st,
                int* grid = nullptr) {
  if (!stem_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap;
  const cudaError_t e = tensor_map(&wmap, w, kStemK, kStemN, kHBK);
  if (e != cudaSuccess) return static_cast<int>(e);
  return a.chunks > 1 ? launch_stem_build<kU8, kTrain, true>(a, wmap, st, grid)
                      : launch_stem_build<kU8, kTrain, false>(a, wmap, st,
                                                              grid);
}

// ---------------------------------------------------------------------------
// K14b: the int8 stem on the same walk (tiles, chunks, bands, carry). The
// weight wq^T [256 n][512 k] s8 (K-major: 8-bit wgmma takes no transpose;
// k = (tap_r, tap_c, ch48), zero from 432, padded to four 128-byte swizzle
// rows) stays in shared memory for the block's whole walk: one TMA load of
// 128 KB a block instead of K1's L2 stream of its 229 KB a strip. A
// tile's A [128 rows][512 k] is built from its raw u8 neighbourhood as
// u ^ 0x80 = u - 128 (0 for a cell outside the frame) one 128-byte panel
// at a time, each panel's s8 wgmma m64n256k32 products issued as soon as
// it is built, so the next panel is built under them (14 k32 steps: k
// 448.. are skipped). The epilogue (stem_i8_epilogue) computes each
// phase's y = bf16(relu(f32(acc) sv + bias)), the bias that of the cell's
// validity class (which tap rows and tap columns lie inside the frame: at
// most 3 x 3 classes, their rows made once a block, adding the valid taps'
// wb rows in tap order from 0, then wb[9], as the plain version does),
// then pools as K1 does. Shared memory, 229,760 of 232,448 bytes: the
// weight 131,072, A 65,536 (after the product: the epilogue's carry rows
// and row exchange), the raw cells 12,672 (the next tile's copies land
// there once A is built), the carry of the tile's second cell row kept
// for the next strip 9,216, the class rows 9,216, sv 1,024.
// ---------------------------------------------------------------------------

constexpr int kI8Panel = kStemN * 128;    // a weight panel [256 n][128 k]
constexpr int kI8Weight = 4 * kI8Panel;   // 131072
constexpr int kI8APanel = kBM * 128;      // an A panel [128 rows][128 k]
constexpr int kI8A = 4 * kI8APanel;       // 65536
constexpr int kI8Keep = kMaxCells * kCarryLd * 2;
constexpr int kI8Classes = 9;
constexpr int kI8Bias = kI8Classes * kStemN * 4;
constexpr int kI8Smem = kI8Weight + kI8A + kRawBytes + kI8Keep + kI8Bias +
                        kStemN * 4 + kAlignSlack;
static_assert(kCarryElems * 2 + kXchBytes <= kI8A, "carry and exchange");
static_assert(kI8Smem <= 232448 - 64, "K14b's shared memory");

// The validity class of a cell coordinate i of n: bit 0 where tap 0 lies
// outside (i == 0), bit 1 where tap 2 does (i == n - 1); its slot in the
// table (0, 1, 2): class 3 happens only where n == 1, then in slot 0.
__device__ __forceinline__ int class_slot(int i, int n) {
  const int c = (i == 0 ? 1 : 0) | (i == n - 1 ? 2 : 0);
  return c == 3 ? 0 : c;
}

__device__ __forceinline__ int slot_class(int slot, int n) {
  return n == 1 ? 3 : slot;
}

// bf16(relu(lo)), bf16(relu(hi)) packed (lo in the low half): the ReLU
// and the round of the plain version in one instruction
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  using B2 = __nv_bfloat162;
  const B2 m = __hmax2(*reinterpret_cast<const B2*>(&a),
                       *reinterpret_cast<const B2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// K14b's epilogue from the s32 accumulators (stem_epilogue's layout): per
// phase y = bf16(relu(f32(acc) sv + bias)), bias the row's class row (bt:
// rows r0, r0 + 8), each product and sum rounded on its own; a lane's two
// filters 8 jj + 2 q, + 1 packed as bf16x2. The affine differs between
// the phases of a filter and between cells, so it runs before the pool;
// then stem_epilogue's pool on the packed y (y >= 0: a missing neighbour
// counts as 0).
__device__ void stem_i8_epilogue(const int (&iacc)[kStemN / 2],
                                 const StemArgs& a, const StemTile& t,
                                 const float* svs, const float* bt0,
                                 const float* bt1, float* xch, bf16* cur,
                                 const bf16* up_prev, int valid, bool store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
  const int wt = t.wt;
  uint32_t y[4][8][2];  // [phase][jj][row r0, r0 + 8]
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * ph + 8 * jj + 2 * q;
      const float2 sv = *reinterpret_cast<const float2*>(svs + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 b =
            *reinterpret_cast<const float2*>((h ? bt1 : bt0) + col);
        const int i = 4 * (jj + 8 * ph) + 2 * h;
        y[ph][jj][h] = relu_bf16x2(
            __fadd_rn(__fmul_rn(__int2float_rn(iacc[i]), sv.x), b.x),
            __fadd_rn(__fmul_rn(__int2float_rn(iacc[i + 1]), sv.y), b.y));
      }
    }
  // row 16 warp + 15's column phase 1, for the next warp's first row
  uint32_t* xu = reinterpret_cast<uint32_t*>(xch);
  if (lane >= 28) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      xu[(2 * warp) * 32 + 4 * jj + q] = y[1][jj][1];
      xu[(2 * warp + 1) * 32 + 4 * jj + q] = y[3][jj][1];
    }
  }
  __syncthreads();
  // the column pool of each row phase (stem_epilogue's); row phase 1's
  // also to the carry
  const int src = (lane + 28) & 31;  // row r0 - 1 where lane >= 4
  const bool left_lo = r0 % wt != 0, left_hi = (r0 + 8) % wt != 0;
  uint32_t cp[2][8][2];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const uint32_t c_lo = y[2 * pr + 1][jj][0], c_hi = y[2 * pr + 1][jj][1];
      const uint32_t sl = __shfl_sync(0xffffffffu, c_lo, src);
      const uint32_t sh = __shfl_sync(0xffffffffu, c_hi, src);
      uint32_t l0 = lane >= 4 ? sl
                              : (warp > 0 ? xu[(2 * (warp - 1) + pr) * 32 +
                                               4 * jj + q]
                                          : 0u);
      uint32_t l1 = lane >= 4 ? sh : sl;
      l0 = left_lo ? l0 : 0u;
      l1 = left_hi ? l1 : 0u;
      cp[pr][jj][0] = max_bf16x2(max_bf16x2(y[2 * pr][jj][0], c_lo), l0);
      cp[pr][jj][1] = max_bf16x2(max_bf16x2(y[2 * pr][jj][1], c_hi), l1);
    }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(cur + (r0 + 8 * h) * kCarryLd + 8 * jj +
                                   2 * q) = cp[1][jj][h];
  __syncthreads();
  // the pool: both row phases' column pools and row phase 1 of the cell
  // row above
  float out[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int lr = r / wt;
    const bf16* up = r >= valid ? nullptr
                     : lr == 1  ? cur + (r - wt) * kCarryLd
                     : up_prev  ? up_prev + r * kCarryLd
                                : nullptr;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const uint32_t u =
          up != nullptr
              ? *reinterpret_cast<const uint32_t*>(up + 8 * jj + 2 * q)
              : 0u;
      const float2 m = unpack2(
          max_bf16x2(max_bf16x2(cp[0][jj][h], cp[1][jj][h]), u));
      out[4 * jj + 2 * h] = m.x;
      out[4 * jj + 2 * h + 1] = m.y;
    }
  }
  if (store)
    store_tile<64>(reinterpret_cast<uint8_t*>(xch) + warp * 1024, out,
                   Identity{}, a.out, 64, 16 * warp, valid, 0, nullptr,
                   nullptr, StemRows(a, t));
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
    stem_i8_kernel(StemArgs a, const __grid_constant__ CUtensorMap wmap) {
  __shared__ alignas(8) uint64_t bar;
  uint8_t* sm = aligned_smem();
  uint8_t* wsm = sm;
  uint8_t* ap = sm + kI8Weight;
  uint8_t* raw = ap + kI8A;
  bf16* keep = reinterpret_cast<bf16*>(raw + kRawBytes);
  float* btab = reinterpret_cast<float*>(raw + kRawBytes + kI8Keep);
  float* svs = btab + kI8Classes * kStemN;
  bf16* cur = reinterpret_cast<bf16*>(ap);
  float* xch = reinterpret_cast<float*>(ap + kCarryElems * 2);
  using Walk = StemWalk<true, kWide>;
  Walk w(a, blockIdx.x);
  const int tiles = Walk::count(a);
  if (tiles == 0) return;
  if (threadIdx.x == 0) {
    tma_prefetch(&wmap);
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar, kI8Weight);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      tma_load(wsm + p * kI8Panel, &wmap, 128 * p, 0, &bar);
  }
  fetch<true>(a, raw, nullptr, w.tile(a));
  cp_async_commit();
  // the bias of each validity class, and sv
  for (int i = threadIdx.x; i < kI8Classes * kStemN; i += kThreads) {
    const int cls = i / kStemN, col = i - cls * kStemN;
    const int rc = slot_class(cls / 3, a.hs), cc = slot_class(cls % 3, a.ws);
    float bias = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int tr = tap / 3, tc = tap - 3 * tr;
      const bool ok = !(tr == 0 && (rc & 1)) && !(tr == 2 && (rc & 2)) &&
                      !(tc == 0 && (cc & 1)) && !(tc == 2 && (cc & 2));
      if (ok) bias = __fadd_rn(bias, a.bias[tap * kStemN + col]);
    }
    btab[i] = __fadd_rn(bias, a.bias[9 * kStemN + col]);
  }
  for (int i = threadIdx.x; i < kStemN; i += kThreads) svs[i] = a.scale[i];
  mbar_wait(&bar, 0);
  const int wg = threadIdx.x >> 7;
  const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  for (int i = 0; i < tiles; ++i) {
    const StemTile t = w.tile(a);
    const int rows = w.rows(a, t);
    const bool halo = w.halo(), top = w.s == 0;
    cp_async_wait<0>();
    __syncthreads();  // the raw cells are in; the last epilogue is done
    int iacc[kStemN / 2];
#pragma unroll
    for (int k = 0; k < kStemN / 2; ++k) iacc[k] = 0;
    // A by panel: panel p's product is issued once every thread built it,
    // and runs while the next panel is built. A row r = thread / 2, its
    // 16-byte chunks g = 8 p + 4 (thread % 2) .. + 3 (panel 3: g = 24 + 2
    // (thread % 2), + 1); g < 27 is channels 16 (g % 3) .. of tap g / 3
    // (StemSrc's groups), the rest zero
    const int ar = threadIdx.x >> 1;
    const int alr = ar / t.wt, aj = ar - alr * t.wt;
    const uint32_t a0 = smem_addr(ap) + wg * 64 * 128, b0 = smem_addr(wsm);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int per = p < 3 ? 4 : 2;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        const int g = 8 * p + per * (threadIdx.x & 1) + e;
        const int tap = g / 3, cc = g - 3 * tap;
        const int tr = tap / 3, tc = tap - 3 * tr;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ar < rows && g < 27 &&
            inside(a, 2 * t.s - 1 + alr + tr, t.cb - 1 + aj + tc)) {
          v = *reinterpret_cast<const uint4*>(
              raw + ((alr + tr) * (t.wt + 2) + aj + tc) * 48 + cc * 16);
          v.x ^= 0x80808080u;
          v.y ^= 0x80808080u;
          v.z ^= 0x80808080u;
          v.w ^= 0x80808080u;
        }
        *reinterpret_cast<uint4*>(ap + p * kI8APanel + swz(ar, g & 7)) = v;
      }
      fence_async_smem();
      __syncthreads();  // panel p is built (after panel 3: raw is free)
      fence_acc(iacc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < (p == 3 ? 2 : 4); ++kk)
        wgmma_s8_m64n256(iacc, desc(a0 + p * kI8APanel + kk * 32, 16, 1024),
                         desc(b0 + p * kI8Panel + kk * 32, 16, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(iacc);
    }
    // the next tile's raw cells come under this tile's product and epilogue
    const StemTile here = t;
    w.next(a);
    if (i + 1 < tiles) fetch<true>(a, raw, nullptr, w.tile(a));
    cp_async_commit();
    mma_wait<0>(iacc);
    __syncthreads();  // both warpgroups' products are done: A is free
    // the class rows of biases of this lane's two rows
    const float* bt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(r0 + 8 * h, rows - 1);
      const int lr = r / here.wt;
      bt[h] = btab +
              (3 * class_slot(2 * here.s + lr, a.hs) +
               class_slot(here.cb + r - lr * here.wt, a.ws)) *
                  kStemN;
    }
    stem_i8_epilogue(iacc, a, here, svs, bt[0], bt[1], xch, cur,
                     top || halo ? nullptr : keep, rows, !halo);
    __syncthreads();  // every read of the kept row is done
    // keep the carry of the tile's second cell row for the next strip
    for (int c = threadIdx.x; c < here.wt * 8; c += kThreads) {
      const int j = c >> 3, f8 = (c & 7) * 8;
      *reinterpret_cast<uint4*>(keep + j * kCarryLd + f8) =
          *reinterpret_cast<const uint4*>(cur + (here.wt + j) * kCarryLd + f8);
    }
  }
  if (threadIdx.x == 0) mbar_inval(&bar);
}

// One launch of K14b over a (x = s4, scale = sv, bias = wb, out), wt the
// weight [256][512] s8.
template <bool kWide>
int launch_stem_i8_build(const StemArgs& a, const CUtensorMap& wmap,
                         cudaStream_t st) {
  int held = 0;
  const cudaError_t e = resident<stem_i8_kernel<kWide>>(kI8Smem, &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = std::max(1, std::min(a.n * a.chunks * a.bands, held));
  stem_i8_kernel<kWide><<<blocks, kThreads, kI8Smem, st>>>(a, wmap);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_stem_i8(const StemArgs& a, const void* wt,
                          cudaStream_t st) {
  if (!stem_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap;
  const cudaError_t e = tensor_map_2d(&wmap, wt, kStemN, 512, 1, kStemN);
  if (e != cudaSuccess) return static_cast<int>(e);
  return a.chunks > 1 ? launch_stem_i8_build<true>(a, wmap, st)
                      : launch_stem_i8_build<false>(a, wmap, st);
}

}  // namespace
}  // namespace vcg
