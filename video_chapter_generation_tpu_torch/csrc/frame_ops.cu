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
// writes its output once and does no arithmetic worth counting, so the
// design is one element (normalize) or one vector of up to 16 bytes
// (shift) per thread, neighbouring threads on neighbouring addresses.
// The normalize multiply and add are separate roundings (__fmul_rn,
// __fadd_rn: nvcc would otherwise contract them into one FMA), so the
// kernel equals its plain version bit for bit. The shift vector never
// straddles a fold boundary: its width divides both the row and the fold
// in bytes, so a whole vector comes from one source frame.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out,
                     long long n, const float* __restrict__ consts) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % 3);
  const float v = static_cast<float>(x[i]);
  store(out + i, __fadd_rn(__fmul_rn(v, consts[c]), consts[3 + c]));
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

extern "C" int vcg_normalize_frames(const void* x, void* out, long long n,
                                    int out_bf16, const void* consts,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const uint8_t* in = static_cast<const uint8_t*>(x);
  const float* k = static_cast<const float*>(consts);
  if (out_bf16)
    normalize_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads,
                                      0, st>>>(
        in, static_cast<__nv_bfloat16*>(out), n, k);
  else
    normalize_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        in, static_cast<float*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
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
