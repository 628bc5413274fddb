// Training-mode ResNet stem on 4x4 space-to-depth frames, for Hopper
// (sm_90a).
//
// Replaces video_chapter_generation_tpu/ops/stem_train_pallas.py
// (stem_s2d_train / stem_frames_train: the SFK-A, SFK-B, SBK-A and SBK-B
// kernels). Input: u8 cells [N, H/4, W/4, 48] (raw pixels, normalized
// here; channel order (dy, dx, c)) or normalized bf16 frames [N, H, W, 3],
// read as their 4x4 cells in place. yc, the conv output, is kept in the
// TPU kernel's phase-packed form [cells, 256]: row = s2d cell (n, I, J),
// column (pr * 2 + pc) * 64 + f = conv pixel (2I + pr, 2J + pc), filter f.
//
// Forward (vcg_stem_train_fwd, 3 launches; split at the moments under a
// moment group, the statistics launch then twice: the fold, the rest):
//   SFK-A  stem_kernel<kU8, true, kWide> (stem_tiles.cuh): per strip of 2
//          cell rows (of one column chunk where the frame is wider than 64
//          cells) the phase-packed product A[cells, 448] x W[448, 256] on
//          hopper_gemm.cuh's wgmma mainloop, A copied from the strip's
//          normalized neighbourhood in shared memory; the epilogue rounds
//          each sum to bf16, stores yc and adds the column (sum, sum^2) of
//          the stored values to per-warp slots: one row [2][256] of partial
//          moments a block;
//   stats  one block sums the rows in order, folds the 4 phases (in order)
//          and computes mu, var and the affine sa, sb;
//   SFK-B  out = 3x3/2 max pool (pad 1) of relu(sa * yc + sb), rounded to
//          bf16, from the cell-phase form: output (I, J) pools the 4 phases
//          of cell (I, J), column phase 1 of cell (I, J - 1), row phase 1
//          of cell (I - 1, J) and phase (1, 1) of (I - 1, J - 1). It pools
//          the raw yc and applies the affine once an output: stem_act is
//          monotone in v (non-increasing where sa < 0: those channels pool
//          -yc), so the result is exactly stem_act of the window's largest
//          activation.
// Backward (vcg_stem_train_bwd, 4 launches, likewise split; the input is
// data: no dx):
//   SBK-A  route: per cell, the window gradient reaches each phase by
//          parity (phase (0, 0) lies in window (I, J) only, (0, 1) also in
//          (I, J + 1), (1, 0) also in (I + 1, J), (1, 1) in all four), to
//          every position equal to the window max (ties each receive it),
//          times relu'; da is stored phase-packed (a warp a cell, a lane 8
//          of its 256 columns), and the BN backward moments (sum da, sum
//          da (yc - mu)) per column go to one row of partial sums a block,
//          summed in a fixed order;
//   bwd    one block folds the moments' phases and computes the BN
//          backward vectors A, E, F and dgamma, dbeta;
//   SBK-B  dw2[448, 256] = z^T du, du = A da + E yc + F applied to each
//          arrived stage, on hopper_gemm.cuh's weight-gradient path (both
//          operands MN-major, the transpose bits set, as conv_train.cu's
//          conv_wgrad_kernel): grid (4 phases, 1, splits), each block
//          walking a range of the forward's tiles (strips, or strips of a
//          column chunk: two runs of cells), up to 64 cells a stage, and
//          owning the columns of one phase for all 448 rows, computed
//          transposed (du^T z: 64 channels x 256 patch columns a
//          warpgroup, m64n256 products), so da and yc are read once in
//          all; z, the 448 patch columns of a cell, is copied from the
//          tile's normalized neighbourhood in shared memory (the forward's
//          copy), da and yc come by TMA through a ring of 6 stages. Each
//          split writes its float32 partial dw2;
//   fold   dw7[7, 7, 3, 64] = the splits summed in order, then the
//          transpose of the phase selection (stem_train_pallas.py:314-319):
//          tap (dr, dc, c) of phase (pr, pc) is dw2 row (tr, tc, di, dj, c)
//          with 4 tr + di = dr + 2 pr + 1 (likewise columns), four terms
//          summed in phase order.
// No float atomics anywhere: two runs agree bit for bit.
//
// What bounds it on the H100: 128 frames at 224 px are 401 k cells; each
// product is 2 x 448 x 256 flops a cell (92 GFLOP, 0.09 ms at 989
// TFLOP/s); yc and da are 205 MB each, written once and read once or
// twice (0.06 ms a pass at 3.35 TB/s). The weight gradient builds z four
// times (once a phase block) from shared memory, not from device memory.
#include "stem_tiles.cuh"


namespace vcg {
namespace {

// relu(sa * yc + sb) rounded to bf16, the same ops in the pool and in the
// backward's recompute, so the tie test is exact.
__device__ __forceinline__ float stem_act(float v, float sa, float sb) {
  return __bfloat162float(__float2bfloat16_rn(fmaxf(fmaf(v, sa, sb), 0.0f)));
}

constexpr int kFoldThreads = 2 * kStemN;

// Sum rows [rows][2][256] of partial moments in a fixed order, then fold
// the 4 phases in order: red[64 k + f] = moment k of channel f after the call.
// Block of kFoldThreads threads; red: 2 * 256 floats of shared memory.
__device__ void fold_moments(const float* part, int rows, float* red) {
  const int j = threadIdx.x;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // rows r % 4, then in order
  for (int r = 0; r < rows; ++r)
    acc[r & 3] += part[static_cast<size_t>(r) * 512 + j];
  red[j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  float m = 0.0f;
  if (j < 128) {
    const float* row = red + (j >> 6) * kStemN + (j & 63);
    m = ((row[0] + row[64]) + row[128]) + row[192];
  }
  __syncthreads();
  if (j < 128) red[j] = m;
  __syncthreads();
}

// How a statistics launch takes its moments: folded from the rows of part
// and used (kFold, the whole entry), folded and stored into mom [2][64]
// only (kFoldOnly, the end of a split entry's first phase), or read from
// mom, where the caller may have summed them over ranks, and used
// (kFromMom). The stored moments are the folded values, so a split entry
// computes what the whole one does.
enum MomentMode { kFold = 0, kFoldOnly = 1, kFromMom = 2 };

// red[0, 128): the moments of the mode (a block of kFoldThreads threads);
// false where they were only stored.
__device__ bool take_moments(const float* part, int rows, float* mom,
                             int mode, float* red) {
  if (mode == kFromMom) {
    if (threadIdx.x < 128) red[threadIdx.x] = mom[threadIdx.x];
    __syncthreads();
    return true;
  }
  fold_moments(part, rows, red);
  if (mode == kFold) return true;
  if (threadIdx.x < 128) mom[threadIdx.x] = red[threadIdx.x];
  return false;
}

// The forward's statistics: mu, var [64] and the affine sa, sb [64]. mom
// is stats itself (its 128 floats hold the moments between the phases).
__global__ void __launch_bounds__(kFoldThreads)
    stem_stats_kernel(const float* part, int rows, float count,
                      const float* gb, float eps, float* stats, float* vec,
                      int mode) {
  __shared__ float red[2 * kStemN];
  if (!take_moments(part, rows, stats, mode, red)) return;
  const int i = threadIdx.x;
  if (i < 64)
    bn_stats_at(i, red[i], red[64 + i], count, gb, gb + 64, eps, stats,
                stats + 64, vec, vec + 64);
}

// The backward's BN vectors abc = A, E, F [3][64] and dgb = dgamma,
// dbeta [2][64] from the route's moments (mom: dgb itself).
__global__ void __launch_bounds__(kFoldThreads)
    stem_bwd_stats_kernel(const float* part, int rows, float count,
                          const float* gb, const float* stats, float eps,
                          float* abc, float* dgb, int mode) {
  __shared__ float red[2 * kStemN];
  if (!take_moments(part, rows, dgb, mode, red)) return;
  const int i = threadIdx.x;
  if (i < 64)
    bn_bwd_at(i, red[i], red[64 + i], count, gb, stats, stats + 64, eps, abc,
              abc + 64, abc + 128, dgb, dgb + 64);
}

// out [n, hs, ws, 64] from yc [n hs ws][256]: one thread per 8-channel
// chunk of one output pixel (= one cell).
__global__ void stem_pool_kernel(const bf16* yc, const float* sa,
                                 const float* sb, bf16* out, int n, int hs,
                                 int ws) {
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(n) * hs * ws * 8) return;
  const int ch = static_cast<int>(idx & 7) * 8;
  const size_t cell = idx >> 3;
  const int j = static_cast<int>(cell % ws);
  const int i = static_cast<int>((cell / ws) % hs);
  float s[8], b[8], t[8];
  vec8(sa + ch, s);
  vec8(sb + ch, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = -INFINITY;
  // (cell offset, phase) of the window's nine conv pixels
  auto take = [&](size_t c, int ph) {
    float v[8];
    unpack8(ldg16(yc + c * kStemN + ph * 64 + ch), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = fmaxf(t[e], s[e] < 0.0f ? -v[e] : v[e]);
  };
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) take(cell, ph);
  if (j > 0) {
    take(cell - 1, 1);
    take(cell - 1, 3);
  }
  if (i > 0) {
    take(cell - ws, 2);
    take(cell - ws, 3);
    if (j > 0) take(cell - ws - 1, 3);
  }
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    y[e] = stem_act(s[e] < 0.0f ? -t[e] : t[e], s[e], b[e]);
  *reinterpret_cast<uint4*>(out + cell * 64 + ch) = pack8(y);
}

constexpr int kRouteCells = kThreads / 32;  // cells a block takes a pass

// SBK-A: da [n hs ws][256] from dpool and the pooled out [n, hs, ws, 64],
// and the BN backward moments, one row [2][256] of partial sums a block.
// A warp takes one cell a pass, lane l its 8 columns 8 l .. (phase l / 8,
// channels 8 (l % 8) ..): the cell's 512 bytes of yc and of da in one
// access each; the lanes of a phase read only the windows it lies in.
// Each lane sums its columns' moments over its cells, the block's warps
// are summed in order.
__global__ void __launch_bounds__(kThreads)
    stem_route_kernel(const bf16* dpool, const bf16* pooled, const bf16* yc,
                      const float* sa, const float* sb, const float* mu,
                      bf16* da, float* part, int n, int hs, int ws) {
  __shared__ float red[kThreads / 32][2][kStemN];
  __shared__ alignas(16) float vecs[3][64];  // sa, sb, mu
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ph = lane >> 3, ch = (lane & 7) * 8;
  const int total = n * hs * ws;
  if (threadIdx.x < 64) {
    vecs[0][threadIdx.x] = sa[threadIdx.x];
    vecs[1][threadIdx.x] = sb[threadIdx.x];
    vecs[2][threadIdx.x] = mu[threadIdx.x];
  }
  __syncthreads();
  float s0[8] = {}, s1[8] = {};
  for (int cell = blockIdx.x * kRouteCells + warp; cell < total;
       cell += gridDim.x * kRouteCells) {
    const int j = cell % ws;
    const int i = (cell / ws) % hs;
    const bool right = (ph & 1) && j + 1 < ws, down = (ph & 2) && i + 1 < hs;
    const size_t off = static_cast<size_t>(cell) * kStemN + 8 * lane;
    float v[8], pm[8], dp[8], acc[8];
    unpack8(ldg16(yc + off), v);
    // the windows of this phase, in the TPU kernel's order: (I, J),
    // (I + 1, J), (I, J + 1), (I + 1, J + 1)
    const int win[4] = {cell, cell + ws, cell + 1, cell + ws + 1};
    const bool has[4] = {true, down, right, down && right};
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = stem_act(v[e], vecs[0][ch + e], vecs[1][ch + e]);
      acc[e] = 0.0f;
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (!has[w]) continue;
      const size_t wo = static_cast<size_t>(win[w]) * 64 + ch;
      unpack8(ldg16(pooled + wo), pm);
      unpack8(ldg16(dpool + wo), dp);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (y[e] == pm[e]) acc[e] = w == 0 ? dp[e] : acc[e] + dp[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[e] = y[e] > 0.0f ? acc[e] : 0.0f;
      s0[e] += acc[e];
      s1[e] += acc[e] * (v[e] - vecs[2][ch + e]);
    }
    *reinterpret_cast<uint4*>(da + off) = pack8(acc);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[warp][0][8 * lane + e] = s0[e];
    red[warp][1][8 * lane + e] = s1[e];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 2 * kStemN; q += kThreads) {
    float sum = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w)
      sum += red[w][q / kStemN][q % kStemN];
    part[static_cast<size_t>(blockIdx.x) * 2 * kStemN + q] = sum;
  }
}

// One wave at the three blocks an SM its registers allow.
static int route_blocks(int cells) {
  return std::max(1,
                  std::min(3 * 132, (cells + kRouteCells - 1) / kRouteCells));
}

// ---------------------------------------------------------------------------
// SBK-B: the weight gradient dw2 = z^T du on the wgmma mainloop
// ---------------------------------------------------------------------------

// z^T panels of 64 patch columns: 448 and a zero one, so both warpgroups
// issue the same products (a branch around a product would serialize them)
constexpr int kWgPanels = 8;
constexpr int kWgStages = 6;    // the ring of da / yc stages
constexpr int kWgSplitsMax = 132 / 4;  // 4 phase blocks a split

// The walk's units are the tiles of the forward's walk (stem_tiles.cuh:
// a strip of 2 cell rows of one column chunk, no overlap), unit u = (frame
// fr, strip s, chunk ck) in that order. The ring's stage: da of the block's
// phase ph for up to 64 cells of a unit, which becomes G = du, and yc's
// beside it, both by TMA, [64 cells][64] each: with one chunk a frame row
// the unit's rows are one run of cells, stage h its rows 64 h ..; with
// several, its two cell rows are two runs, stage h cell row h (h < 2). z^T,
// 7 MN-major panels [64 cells][64 patch columns] (all 448), is one buffer
// outside the ring, built in the transform of each stage: warpgroup w
// builds the panels its own products read (0-3, 4-7; 7 is zero), after its
// wait for its last product. A unit's neighbourhood comes by cp.async,
// issued in the first stage of the unit before (u8: raw cells into
// raw[unit % 2], normalized into nb[0] at the unit's first stage; bf16
// frames: straight into nb[unit % 2]).
template <bool kWide>
struct WgradSrc {
  static constexpr int kStageBytes = 2 * kPanel;
  static constexpr bool kTma = true;
  StemArgs a;
  const CUtensorMap* dmap;  // da and yc as [cells][256], boxes 64 x 64
  const CUtensorMap* vmap;
  uint8_t* zt;        // the z^T panels
  uint8_t* nbr;       // 2 kNbBytes: the neighbourhoods and raw cells
  const float* vecs;  // shared: A, E, F [3][64]
  float na[3], nbias[3];
  bool u8;
  int ph, g_lo, g_hi, sps, sp;

  // unit j of this split: its tile and cell rows
  __device__ StemTile unit(int j, int& nrows) const {
    const int gs = g_lo + j;
    const int fs = kWide ? gs / a.chunks : gs;  // frame fr strip s: fr sp + s
    const int fr = fs / sp, s = fs - fr * sp;
    nrows = min(2, a.hs - 2 * s);
    return stem_tile<false, kWide>(
        a, kWide ? fr * a.chunks + gs - fs * a.chunks : fr, s);
  }

  // stage h of unit t: its first cell's row of da and yc, and for stage
  // row cr the unit's row r = (r / wt, r % wt) and whether it is a cell
  __device__ int stage_row(const StemTile& t, int h) const {
    const size_t row0 = (static_cast<size_t>(t.fr) * a.hs + 2 * t.s) * a.ws;
    return static_cast<int>(kWide ? row0 + h * a.ws + t.cb : row0 + 64 * h);
  }
  __device__ bool cell_of(const StemTile& t, int nrows, int h, int cr,
                          int& r) const {
    if (!kWide) {
      r = 64 * h + cr;
      return r < nrows * t.wt;
    }
    r = h * t.wt + cr;
    return cr < t.wt && h < nrows;
  }

  // the bf16 neighbourhood strip j reads, and the raw cells of its copy
  __device__ uint8_t* nb_of(int j) const {
    return u8 ? nbr : nbr + (j & 1) * kNbBytes;
  }
  __device__ uint8_t* raw_of(int j) const {
    return nbr + kNbBytes + (j & 1) * kRawBytes;
  }

  // Every thread's copies of unit j's neighbourhood (then committed).
  __device__ void fetch_strip(int j) const {
    if (g_lo + j < g_hi) {
      int nrows;
      const StemTile t = unit(j, nrows);
      if (u8)
        fetch<true>(a, raw_of(j), nullptr, t);
      else
        fetch<false>(a, nullptr, nb_of(j), t);
    }
    cp_async_commit();
  }

  __device__ void load(uint8_t* st, uint64_t* bar, int, int q) {
    const int j = q / sps, h = q - j * sps;
    int nrows;
    const int row = stage_row(unit(j, nrows), h);
    if (threadIdx.x == 0) mbar_expect(bar, 2 * kPanel);
    if (tma_lane(0, 0)) tma_load(st, dmap, 64 * ph, row, bar);
    if (tma_lane(1, 0)) tma_load(st + kPanel, vmap, 64 * ph, row, bar);
  }

  __device__ void xform(uint8_t* st, int, int q) {
    const int j = q / sps, h = q - j * sps;
    int nrows;
    const StemTile ut = unit(j, nrows);
    if (h == 0) {
      // this unit's neighbourhood is in (every thread's copies); the
      // next unit's copies go out, into the buffers unit j - 1 used
      cp_async_wait<0>();
      __syncthreads();
      if (u8) {
        normalize(a, na, nbias, raw_of(j), nb_of(j), ut);
        __syncthreads();
      }
      fetch_strip(j + 1);
    }
    const uint8_t* nbh = nb_of(j);
    // z^T: warpgroup w's thread t fills cell rr = t / 2 of its panels p
    // with patch-column groups g = 4 p + 2 (t % 2) + e (16 channels each,
    // chunks 2 (g % 4), + 1 of the panel row): group g is channels
    // 16 (g % 3) .. of tap g / 3 (zero from 27 on)
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int rr = t >> 1;
    int r;
    const bool live = cell_of(ut, nrows, h, rr, r);
    const int lr = r / ut.wt, jc = r - lr * ut.wt;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int p = 4 * wg + pp;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = 2 * (t & 1) + e, g = 4 * p + u;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (live && g < 27) {
          const int tap = g / 3, cc = g - 3 * tap;
          const int tr = tap / 3, tc = tap - 3 * tr;
          const uint4* src = reinterpret_cast<const uint4*>(
              nbh + ((lr + tr) * (ut.wt + 2) + jc + tc) * 96 + cc * 32);
          lo = src[0];
          hi = src[1];
        }
        uint8_t* panel = zt + p * kPanel;
        *reinterpret_cast<uint4*>(panel + swz(rr, 2 * u)) = lo;
        *reinterpret_cast<uint4*>(panel + swz(rr, 2 * u + 1)) = hi;
      }
    }
    // du = A da + E yc + F on the cells of the strip: thread i takes
    // channels 8 (i % 8) .. of cells i / 8 and i / 8 + 32
    const int c8 = threadIdx.x & 7, f = 8 * c8;
    float ga[8], ge[8], gf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ga[e] = vecs[f + e];
      ge[e] = vecs[64 + f + e];
      gf[e] = vecs[128 + f + e];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int cr = (threadIdx.x >> 3) + 32 * k;
      int rk;
      if (!cell_of(ut, nrows, h, cr, rk)) continue;
      uint4& dch = *reinterpret_cast<uint4*>(st + swz(cr, c8));
      const uint4 vch =
          *reinterpret_cast<const uint4*>(st + kPanel + swz(cr, c8));
      float d[8], v[8];
      unpack8(dch, d);
      unpack8(vch, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = fmaf(ga[e], d[e], fmaf(ge[e], v[e], gf[e]));
      dch = pack8(d);
    }
  }
};

constexpr int kWgSmem = kWgStages * 2 * kPanel +
                        kWgPanels * kPanel + 2 * kNbBytes + kAlignSlack;

// Columns 64 ph .. of dw2 (phase ph = blockIdx.x, all 448 rows) over the
// units [g_lo, g_hi) of split blockIdx.z, into slice blockIdx.z of part
// [splits][448][256], computed transposed (64 channels x 256 patch
// columns, m64n256 products): warpgroup 0 owns patch columns 0-255 (z^T
// panels 0-3), warpgroup 1 256-511 (panels 4-7, 448.. zero and not
// stored). Each block reads da and yc of its phase once, so a split reads
// them once in all.
template <bool kU8, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
    stem_wgrad_kernel(StemArgs a, const float* abc, int strips, int splits,
                      float* part, const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap vmap) {
  __shared__ alignas(8) uint64_t bars[kWgStages];
  __shared__ alignas(16) float vecs[3 * 64];
  uint8_t* sm = aligned_smem();
  const int z = blockIdx.z;
  const int g_lo =
      static_cast<int>(static_cast<long long>(z) * strips / splits);
  const int g_hi =
      static_cast<int>(static_cast<long long>(z + 1) * strips / splits);
  if (g_lo >= g_hi) return;
  for (int i = threadIdx.x; i < 3 * 64; i += kThreads) vecs[i] = abc[i];
  WgradSrc<kWide> src;
  src.a = a;
  src.dmap = &dmap;
  src.vmap = &vmap;
  src.zt = sm + kWgStages * WgradSrc<kWide>::kStageBytes;
  src.nbr = src.zt + kWgPanels * kPanel;
  src.vecs = vecs;
  norm_consts(a, kU8, src.na, src.nbias);
  src.u8 = kU8;
  src.ph = blockIdx.x;
  src.g_lo = g_lo;
  src.g_hi = g_hi;
  src.sps = kWide ? 2 : (2 * a.ws + 63) / 64;
  src.sp = (a.hs + 1) / 2;
  if (threadIdx.x == 0) {
    tma_prefetch(&dmap);
    tma_prefetch(&vmap);
  }
  src.fetch_strip(0);
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  float acc[kStemN / 2];
#pragma unroll
  for (int i = 0; i < kStemN / 2; ++i) acc[i] = 0.0f;
  {
    Mainloop<kStemN, kWgStages, 1, WgradSrc<kWide>> ml(sm, bars, src, 1,
                                                (g_hi - g_lo) * src.sps);
    // dw2^T of the phase: du^T [64 channels][64 cells] (MN-major A) times
    // z [64 cells][256 patch columns] (MN-major B, the warpgroup's panels)
    ml.k_loop(
        [&](const uint8_t* st, int) {
          const uint32_t g0 = smem_addr(st);
          const uint32_t z0 = smem_addr(src.zt) + 4 * wg * kPanel;
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kHBK / 16; ++kk)
            wgmma<kStemN, 1, 1>(acc, desc(g0 + kk * 2048, kPanel, 1024),
                                desc(z0 + kk * 2048, kPanel, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          fence_acc(acc);
        },
        [&] { mma_wait<0>(acc); });
    ml.finish();
  }
  // straight from the accumulators: a lane holds patch columns 256 wg +
  // 8 j + 2 (lane % 4), + 1 of channels 16 (warp % 4) + lane / 4 and + 8
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int f = 16 * wq + (lane >> 2);
  float* slice = part + static_cast<size_t>(z) * kStemK * kStemN +
                 64 * blockIdx.x + f;
#pragma unroll
  for (int j = 0; j < kStemN / 8; ++j) {
    const int k = 256 * wg + 8 * j + 2 * (lane & 3);
    if (k >= kStemK) break;
    float* dst = slice + static_cast<size_t>(k) * kStemN;
    dst[0] = acc[4 * j];
    dst[kStemN] = acc[4 * j + 1];
    dst[8] = acc[4 * j + 2];
    dst[kStemN + 8] = acc[4 * j + 3];
  }
}

// dw7 [147][64]: the splits of part summed in order, folded through the
// transpose of the phase selection (four terms, in phase order).
__global__ void stem_fold_kernel(const float* part, int splits, float* dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 147 * 64) return;
  const int f = idx & 63, dd = idx >> 6;
  const int c = dd % 3, tap = dd / 3;
  const int dr = tap / 7, dc = tap - 7 * (tap / 7);
  float out = 0.0f;
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const int ur = dr + 2 * (ph >> 1) + 1, uc = dc + 2 * (ph & 1) + 1;
    const int rk = (ur >> 2) * 144 + (uc >> 2) * 48 + (ur & 3) * 12 +
                   (uc & 3) * 3 + c;
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z)
      acc += part[(static_cast<size_t>(z) * kStemK + rk) * kStemN + ph * 64 +
                  f];
    out += acc;
  }
  dw[idx] = out;
}

static int wgrad_splits(int strips) {
  return std::max(1, std::min(kWgSplitsMax, strips));
}

template <bool kU8, bool kWide>
int launch_wgrad(const StemArgs& a, const float* abc, const void* da,
                 const void* yc, float* part, cudaStream_t st) {
  const int cells = a.n * a.hs * a.ws;
  const int strips = a.n * ((a.hs + 1) / 2) * a.chunks;
  CUtensorMap dmap, vmap;
  cudaError_t e = allow_smem<stem_wgrad_kernel<kU8, kWide>>(kWgSmem);
  if (e == cudaSuccess) e = tensor_map(&dmap, da, cells, kStemN, 64);
  if (e == cudaSuccess) e = tensor_map(&vmap, yc, cells, kStemN, 64);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int splits = wgrad_splits(strips);
  stem_wgrad_kernel<kU8, kWide>
      <<<dim3(4, 1, splits), kThreads, kWgSmem, st>>>(a, abc, strips, splits,
                                                      part, dmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the `part` scratch of the forward and backward: the moment
// rows of at most one block a band (the forward), of the route's blocks,
// and the weight gradient's splits.
size_t stem_workspace(int n, int hs, int ws, int bands) {
  const int chunks = stem_chunks(ws);
  const size_t rows = std::max<size_t>(
      static_cast<size_t>(n) * chunks * bands, route_blocks(n * hs * ws));
  return std::max(rows * 2 * kStemN,
                  static_cast<size_t>(
                      wgrad_splits(n * ((hs + 1) / 2) * chunks)) *
                      kStemK * kStemN);
}

#define VCG_TRY(expr)                      \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return int(e_); \
  } while (0)

}  // namespace
}  // namespace vcg

// Floats of the `part` scratch of vcg_stem_train_fwd and _bwd.
extern "C" long long vcg_stem_train_workspace(int n, int hs, int ws,
                                              int bands) {
  return static_cast<long long>(vcg::stem_workspace(n, hs, ws, bands));
}

// x: u8 cells [n, hs, ws, 48] (u8 != 0; 16-byte aligned) or bf16 frames
// [n, 4 hs, 4 ws, 3] (8-byte aligned); w [448, 256] bf16 the phase-packed
// weight (ops/stem.py:stem_weight_im2col, rows 432.. zero); gb = gamma
// [64], beta [64] f32; norm [6] f32 (u8 only). Outputs: yc [n hs ws, 256]
// bf16 phase-packed, out [n, hs, ws, 64] bf16, stats = mu [64], var [64]
// f32, vec = sa [64], sb [64] f32; scratch part (vcg_stem_train_workspace).
// bands a column chunk (stem_chunks(ws) chunks a frame row) in
// 1 .. (hs + 1) / 2. Phases [from, to): 0 SFK-A and the moments (left in
// stats [2][64] as sums and sums of squares when the call stops there),
// 1 the statistics from them and SFK-B; (0, 2) is the whole forward.
// count_scale multiplies the pixel count (1 on one card).
extern "C" int vcg_stem_train_fwd(const void* x, int u8, const void* w,
                                  const void* gb, const void* norm, void* yc,
                                  void* out, void* stats, void* vec,
                                  void* part, int n, int hs, int ws,
                                  int bands, float eps, int from, int to,
                                  double count_scale, void* stream) {
  using namespace vcg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* vv = static_cast<float*>(vec);
  const StemArgs a{x, nullptr, nullptr, static_cast<const float*>(norm),
                   static_cast<bf16*>(yc), pa, n, hs, ws, stem_chunks(ws),
                   bands};
  int grid = 0;
  if (from == 0) {
    VCG_TRY(static_cast<cudaError_t>(
        u8 ? launch_stem<true, true>(a, w, st, &grid)
           : launch_stem<false, true>(a, w, st, &grid)));
  }
  stem_stats_kernel<<<1, kFoldThreads, 0, st>>>(
      pa, grid,
      static_cast<float>(n) * 4 * hs * ws * static_cast<float>(count_scale),
      static_cast<const float*>(gb), eps, static_cast<float*>(stats), vv,
      from == 1 ? kFromMom : to == 1 ? kFoldOnly : kFold);
  VCG_TRY(cudaGetLastError());
  if (to < 2) return 0;
  const size_t total = static_cast<size_t>(n) * hs * ws * 8;
  stem_pool_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(yc), vv, vv + 64, static_cast<bf16*>(out), n,
      hs, ws);
  return static_cast<int>(cudaGetLastError());
}

// dpool, out [n, hs, ws, 64] bf16; x, yc, stats, vec as the forward had or
// wrote them. Outputs: dw [147, 64] f32 (HWIO rows (kh, kw, c)), dgb =
// dgamma [64], dbeta [64] f32. Scratch: da [n hs ws, 256] bf16, abc 192 f32,
// part (vcg_stem_train_workspace). Phases [from, to): 0 SBK-A and the
// moments (left in dgb [2][64] as sum da, sum da (yc - mu) when the call
// stops there), 1 the BN vectors from them, SBK-B and the fold; (0, 2) is
// the whole backward. count_scale multiplies the pixel count (1 on one
// card).
extern "C" int vcg_stem_train_bwd(const void* dpool, const void* out,
                                  const void* yc, const void* x, int u8,
                                  const void* norm, const void* gb,
                                  const void* stats, const void* vec,
                                  void* da, void* dw, void* dgb, void* abc,
                                  void* part, int n, int hs, int ws,
                                  float eps, int from, int to,
                                  double count_scale, void* stream) {
  using namespace vcg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vv = static_cast<const float*>(vec);
  const float* sv = static_cast<const float*>(stats);
  float* pa = static_cast<float*>(part);
  float* ab = static_cast<float*>(abc);
  const int cells = n * hs * ws;
  const int blocks = route_blocks(cells);
  if (from == 0) {
    stem_route_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(dpool), static_cast<const bf16*>(out),
        static_cast<const bf16*>(yc), vv, vv + 64, sv,
        static_cast<bf16*>(da), pa, n, hs, ws);
    VCG_TRY(cudaGetLastError());
  }
  stem_bwd_stats_kernel<<<1, kFoldThreads, 0, st>>>(
      pa, blocks,
      static_cast<float>(n) * 4 * hs * ws * static_cast<float>(count_scale),
      static_cast<const float*>(gb), sv, eps, ab, static_cast<float*>(dgb),
      from == 1 ? kFromMom : to == 1 ? kFoldOnly : kFold);
  VCG_TRY(cudaGetLastError());
  if (to < 2) return 0;
  const StemArgs a{x, nullptr, nullptr, static_cast<const float*>(norm),
                   nullptr, nullptr, n, hs, ws, stem_chunks(ws), 1};
  const bool wide = a.chunks > 1;
  VCG_TRY(static_cast<cudaError_t>(
      u8 ? (wide ? launch_wgrad<true, true>(a, ab, da, yc, pa, st)
                 : launch_wgrad<true, false>(a, ab, da, yc, pa, st))
         : (wide ? launch_wgrad<false, true>(a, ab, da, yc, pa, st)
                 : launch_wgrad<false, false>(a, ab, da, yc, pa, st))));
  stem_fold_kernel<<<(147 * 64 + 255) / 256, 256, 0, st>>>(
      pa, wgrad_splits(n * ((hs + 1) / 2) * a.chunks),
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}
