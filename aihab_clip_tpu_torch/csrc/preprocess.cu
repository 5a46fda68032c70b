// Hopper (sm_90a) kernel for the uint8 -> normalized conversion of the eval
// path (K18).
//
// It replaces the Pallas TPU kernel of aihab_clip_tpu/ops/pallas_preprocess.py:
//   normalize_u8_pallas (:79; _normalize_kernel :49, pallas_call :61) =
//       y = x * scale_c + shift_c over uint8 NHWC, scale_c = 1 / (255 std_c),
//       shift_c = -mean_c / std_c, in fp32, stored bf16 or fp32.
// The TPU kernel laid the batch out as rows of 384 lanes (3 channels x 128)
// so that each vector register holds one channel phase; that is a fact of its
// 128-lane registers.  Here element i of the flat NHWC array has channel
// i % 3, and each thread converts 16 consecutive bytes (one 16-byte load,
// two or four 16-byte stores), taking the channel of each from the phase of
// its first.
//
// Bound.  Pure data movement: at 64 x 224 x 224 x 3 it reads 9.6 MB and
// writes 19.3 MB of bf16, 0.0086 ms at 3.35 TB/s.  The multiply and the add
// are separately rounded (__fmul_rn, __fadd_rn), so nvcc's FMA contraction
// cannot make the result differ from the plain version's two roundings.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Preconditions the Python wrapper checks: x and y contiguous and 16-byte
// aligned.

#include "common.cuh"

namespace {

constexpr int NORM_THREADS = 256;

template <typename TO>
__global__ void __launch_bounds__(NORM_THREADS)
normalize_u8_kernel(const unsigned char* __restrict__ x, TO* __restrict__ y, long long n,
                    float s0, float s1, float s2, float h0, float h1, float h2) {
  const long long stride = static_cast<long long>(gridDim.x) * NORM_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * NORM_THREADS + threadIdx.x;
  const long long nv = n / 16;
  for (long long v = first; v < nv; v += stride) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + v * 16);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
    int c = static_cast<int>((v * 16) % 3);
    float o[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float sc = c == 0 ? s0 : (c == 1 ? s1 : s2);
      const float sh = c == 0 ? h0 : (c == 1 ? h1 : h2);
      o[j] = __fadd_rn(__fmul_rn(static_cast<float>(b[j]), sc), sh);
      c = c == 2 ? 0 : c + 1;
    }
    store8(y + v * 16, o);
    store8(y + v * 16 + 8, o + 8);
  }
  for (long long i = nv * 16 + first; i < n; i += stride) {  // the ragged tail
    const int c = static_cast<int>(i % 3);
    const float sc = c == 0 ? s0 : (c == 1 ? s1 : s2);
    const float sh = c == 0 ? h0 : (c == 1 ? h1 : h2);
    store1(y + i, __fadd_rn(__fmul_rn(static_cast<float>(x[i]), sc), sh));
  }
}

template <typename TO>
int launch_normalize_u8(const void* x, void* y, long long n, const float* s, const float* h,
                        cudaStream_t stream) {
  long long blocks = (n / 16 + NORM_THREADS - 1) / NORM_THREADS;
  blocks = blocks < 1 ? 1 : (blocks > 65535 ? 65535 : blocks);
  normalize_u8_kernel<TO><<<static_cast<int>(blocks), NORM_THREADS, 0, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<TO*>(y), n, s[0], s[1], s[2], h[0],
      h[1], h[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y[i] = x[i] * scale[i % 3] + shift[i % 3] over n uint8 values x (NHWC,
// 3 channels), y bf16, or fp32 with y_is_f32.
int aihab_normalize_u8(const void* x, void* y, int y_is_f32, long long n, float s0, float s1,
                       float s2, float h0, float h1, float h2, void* stream) {
  const float s[3] = {s0, s1, s2}, h[3] = {h0, h1, h2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_is_f32) return launch_normalize_u8<float>(x, y, n, s, h, st);
  return launch_normalize_u8<bf16>(x, y, n, s, h, st);
}

}  // extern "C"
