// Frame normalize (K6) and the temporal shift (K7) for Hopper (sm_90a).
//
// Replaces video_chapter_generation_tpu/ops/preprocess.py:
// normalize_frames_pallas and ops/temporal_shift.py:temporal_shift_pallas.
//
//   normalize: out = (float(u8) * a[c] + b[c]) in float32, stored as float32
//              or bf16; c = element index % 3 (NHWC frames, 3 channels)
//   shift:     out[t, :fold] = x[t + 1], out[t, fold:2 fold] = x[t - 1],
//              zero past the clip ends, the other channels copied; with
//              `reverse` the two folds move the other way (the transpose
//              shift, which is the shift's gradient)
//
// What bounds both on the H100: bytes. Each reads its input once and
// writes its output once and does no arithmetic worth counting (K6 at
// [16, 16, 224, 224, 3]: 38.5 MB in, 77 MB of bf16 out, 0.035 ms at 3.35
// TB/s).
//
// The normalize is a persistent grid (a few blocks an SM) whose threads
// walk vectors of V elements, four a step (their loads issued together):
// V = 8 for bf16 out (an 8-byte load, one 16-byte store), 4 for float32
// (a 4-byte load, one 16-byte store), so a warp's loads and its stores
// each cover one contiguous run of memory. Element V v + e has colour
// (V v + e) % 3: the vector's first colour p = V v % 3 picks the order of
// the six constants (registers) once a vector. Vectors follow the output,
// which the wrapper allocates (16-byte aligned); an input that starts m
// bytes past a V-byte boundary is read at that fixed offset from two
// aligned words a vector (a funnel shift), so it is never copied. The
// elements past the last whole vector (fewer than V) are one a thread.
// The multiply and add are separate roundings (__fmul_rn, __fadd_rn:
// nvcc would otherwise contract them into one FMA), so the kernel equals
// its plain version bit for bit.
//
// The shift is one vector of up to 16 bytes per thread, neighbouring
// threads on neighbouring addresses. Its vector never straddles a fold
// boundary: its width divides both the row and the fold in bytes, so a
// whole vector comes from one source frame.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;  // device ordinals with a cache slot

// normalized = u8 * a[c] + b[c]
struct Norm {
  float a[3], b[3];
};

__device__ __forceinline__ float norm1(uint32_t u, float a, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(u), a), b);
}

// V elements of one vector, as the V bytes of an unsigned word
template <int V>
struct Vec;

template <>
struct Vec<8> {  // bf16 out
  using Word = unsigned long long;
  using Out = __nv_bfloat16;
  __device__ static Word shift(Word lo, Word hi, int m) {
    return (lo >> (8 * m)) | (hi << (64 - 8 * m));
  }
  __device__ static void store(Out* out, const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<4> {  // float32 out
  using Word = uint32_t;
  using Out = float;
  __device__ static Word shift(Word lo, Word hi, int m) {
    return __funnelshift_r(lo, hi, 8 * m);
  }
  __device__ static void store(Out* out, const float (&f)[4]) {
    *reinterpret_cast<float4*>(out) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kSteps = 4;  // vectors a thread takes a step

// x [n] u8 starting m bytes past a V-byte boundary (kShift: m != 0), out
// [n] (16-byte aligned): vector v is elements V v .. V v + V - 1.
template <int V, bool kShift>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const uint8_t* __restrict__ x,
                     typename Vec<V>::Out* __restrict__ out, long long n,
                     Norm k, int m) {
  using Word = typename Vec<V>::Word;
  const long long vecs = n / V;
  const Word* base = reinterpret_cast<const Word*>(x - m);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
       v0 < vecs; v0 += kSteps * stride) {
    Word w[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const long long v = v0 + j * stride;
      if (v < vecs) {
        w[j] = __ldg(base + v);
        if (kShift) w[j] = Vec<V>::shift(w[j], __ldg(base + v + 1), m);
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const long long v = v0 + j * stride;
      if (v >= vecs) break;
      // the colours of elements e = 0, 1, 2 (mod 3) of this vector
      const int p = static_cast<int>(
          (static_cast<unsigned long long>(v) % 3) * (V % 3) % 3);
      float a[3], b[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int q = p + c;  // (p + c) % 3 without a division
        const int col = q >= 3 ? q - 3 : q;
        a[c] = col == 0 ? k.a[0] : (col == 1 ? k.a[1] : k.a[2]);
        b[c] = col == 0 ? k.b[0] : (col == 1 ? k.b[1] : k.b[2]);
      }
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        f[e] = norm1(static_cast<uint32_t>(w[j] >> (8 * e)) & 0xffu,
                     a[e % 3], b[e % 3]);
      Vec<V>::store(out + V * v, f);
    }
  }
  // the elements past the last whole vector
  if (blockIdx.x == 0) {
    const long long i = V * vecs + threadIdx.x;
    if (threadIdx.x < V && i < n) {
      const int c = static_cast<int>(i % 3);
      store1(out + i, norm1(x[i], k.a[c], k.b[c]));
    }
  }
}

template <int V>
cudaError_t launch_normalize(const uint8_t* x, typename Vec<V>::Out* out,
                             long long n, const Norm& k, cudaStream_t st) {
  // the SM count of each device, found on its first launch (one slot a
  // device ordinal, written once: safe from several host threads)
  static std::atomic<int> sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms_of[dev].store(sms, std::memory_order_release);
  }
  const long long per_block = static_cast<long long>(kThreads) * kSteps;
  const long long want = (n / V + per_block - 1) / per_block;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want < 8LL * sms ? want : 8LL * sms));
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(x) % V);
  if (m == 0)
    normalize_kernel<V, false><<<blocks, kThreads, 0, st>>>(x, out, n, k, 0);
  else
    normalize_kernel<V, true><<<blocks, kThreads, 0, st>>>(x, out, n, k, m);
  return cudaGetLastError();
}

// x and out are [n_pix, row] vectors of V (row = C channels in vectors);
// a frame is hw pixels, a clip t frames.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    shift_kernel(const V* __restrict__ x, V* __restrict__ out, long long n,
                 int row, int fold, long long hw, int t, int reverse) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (q >= n) return;
  const long long pix = q / row;
  const int cv = static_cast<int>(q - pix * row);
  long long src = q;
  bool ok = true;
  if (cv < 2 * fold) {
    const int tt = static_cast<int>((pix / hw) % t);
    const long long frame = hw * row;  // vectors in one frame
    if ((cv < fold) != (reverse != 0)) {  // reads frame t + 1
      ok = tt < t - 1;
      src = q + frame;
    } else {  // reads frame t - 1
      ok = tt > 0;
      src = q - frame;
    }
  }
  out[q] = ok ? x[src] : V{};
}

template <typename V>
cudaError_t launch_shift(const void* x, void* out, long long n_pix, int c_bytes,
                         int fold_bytes, long long hw, int t, int reverse,
                         cudaStream_t stream) {
  const int row = c_bytes / static_cast<int>(sizeof(V));
  const long long n = n_pix * row;
  const long long blocks = (n + kThreads - 1) / kThreads;
  shift_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), n, row,
      fold_bytes / static_cast<int>(sizeof(V)), hw, t, reverse);
  return cudaGetLastError();
}

}  // namespace

// x [n] u8 (any alignment); out [n] float32 or bf16 (out_bf16), 16-byte
// aligned; normalized = u8 * a[c] + b[c], c = i % 3.
extern "C" int vcg_normalize_frames(const void* x, void* out, long long n,
                                    int out_bf16, float a0, float a1, float a2,
                                    float b0, float b1, float b2,
                                    void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(x);
  const Norm k{{a0, a1, a2}, {b0, b1, b2}};
  return static_cast<int>(
      out_bf16 ? launch_normalize<8>(in, static_cast<__nv_bfloat16*>(out), n,
                                     k, st)
               : launch_normalize<4>(in, static_cast<float*>(out), n, k, st));
}

// x, out: [n_pix, c] elements of elem_bytes each, frames time-major within
// clips of t frames of hw pixels; fold channels shift each way. The
// caller picks vec_bytes (16, 8, 4, 2 or 1), which must divide c and fold
// in bytes and both pointers' alignment.
extern "C" int vcg_temporal_shift(const void* x, void* out, long long n_pix,
                                  int c, int fold, int elem_bytes,
                                  int vec_bytes, long long hw, int t,
                                  int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cb = c * elem_bytes, fb = fold * elem_bytes;
  cudaError_t e;
  switch (vec_bytes) {
    case 16: e = launch_shift<uint4>(x, out, n_pix, cb, fb, hw, t, reverse, st); break;
    case 8: e = launch_shift<uint2>(x, out, n_pix, cb, fb, hw, t, reverse, st); break;
    case 4: e = launch_shift<uint32_t>(x, out, n_pix, cb, fb, hw, t, reverse, st); break;
    case 2: e = launch_shift<uint16_t>(x, out, n_pix, cb, fb, hw, t, reverse, st); break;
    case 1: e = launch_shift<uint8_t>(x, out, n_pix, cb, fb, hw, t, reverse, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
