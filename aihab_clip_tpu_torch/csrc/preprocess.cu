// Hopper (sm_90a) kernel for the uint8 -> normalized conversion of the eval
// path (K18).
//
// It replaces the Pallas TPU kernel of aihab_clip_tpu/ops/pallas_preprocess.py:
//   normalize_u8_pallas (:79; _normalize_kernel :49, pallas_call :61) =
//       y = x * scale_c + shift_c over uint8 NHWC, scale_c = 1 / (255 std_c),
//       shift_c = -mean_c / std_c, in fp32, stored bf16 or fp32.
// The TPU kernel laid the batch out as rows of 384 lanes (3 channels x 128)
// so that each vector register holds one channel phase; that is a fact of its
// 128-lane registers.
//
// Bound.  Pure data movement: at 64 x 224 x 224 x 3 it reads 9.6 MB and
// writes 19.3 MB of bf16, 0.0086 ms at 3.35 TB/s.  The design follows from
// that:
//   * a warp converts tiles of 1,536 bytes, 48 bytes a thread: thread t
//     takes the six 8-byte pieces at 256k + 8t (k = 0..5).  Each warp load
//     reads 256 contiguous bytes and each warp store writes 512 contiguous
//     bytes of bf16 (the 8 outputs of a piece, one 16-byte store), so every
//     sector is written whole by one instruction.  A tile starts at a
//     multiple of 3, so piece k's first byte has channel (k + 2t) % 3 in
//     every tile: each thread rotates the scale and shift triples once,
//     before its loop, and the channel of each of its bytes is then a
//     compile-time index (no per-element i % 3 select);
//   * the loads do not allocate in L1 (each byte is read once); the stores
//     are plain, so the output stays in L2 for the next kernel, which reads
//     it (streaming, evict-first stores measured 3-5% slower here, cold and
//     warm: tools/k18_time.py);
//   * one tile a warp: the grid holds every tile (a grid-stride loop past
//     MAX_BLOCKS blocks), so the SMs keep many blocks in flight and a
//     thread's six loads are issued before its first convert.
// The multiply and the add are separately rounded (__fmul_rn, __fadd_rn), so
// nvcc's FMA contraction cannot make the result differ from the plain
// version's two roundings.  The ragged end (n not a multiple of 1,536) is
// converted a byte a thread with the channel i % 3.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Preconditions the Python wrapper checks: x and y contiguous and 16-byte
// aligned.

#include "common.cuh"

namespace {

constexpr int NORM_THREADS = 256;
constexpr int TILE = 1536;          // bytes a warp converts: 32 threads x 48
constexpr int PIECES = 6;           // 8-byte pieces a thread takes per tile
constexpr long long MAX_BLOCKS = 65535;

struct Phase {
  float s[3], h[3];
};

// 8 bytes, read once: no L1 allocation, through the non-coherent path
__device__ __forceinline__ uint2 load_once(const unsigned char* p) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p));
  return r;
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const unsigned*>(&v);
}

// byte J of a piece whose first byte has the rotated triples' channel 0
template <int J>
__device__ __forceinline__ float convert(const uint2& q, const float (&s)[3],
                                         const float (&h)[3]) {
  const unsigned word = J < 4 ? q.x : q.y;
  const float v = static_cast<float>((word >> (8 * (J % 4))) & 0xffu);
  return __fadd_rn(__fmul_rn(v, s[J % 3]), h[J % 3]);
}

// the 8 outputs of one piece: one 16-byte store of bf16, two of fp32
__device__ __forceinline__ void store_piece(const uint2& q, const float (&s)[3],
                                            const float (&h)[3], bf16* y) {
  uint4 o;
  o.x = pack_bf16(convert<0>(q, s, h), convert<1>(q, s, h));
  o.y = pack_bf16(convert<2>(q, s, h), convert<3>(q, s, h));
  o.z = pack_bf16(convert<4>(q, s, h), convert<5>(q, s, h));
  o.w = pack_bf16(convert<6>(q, s, h), convert<7>(q, s, h));
  *reinterpret_cast<uint4*>(y) = o;
}

__device__ __forceinline__ void store_piece(const uint2& q, const float (&s)[3],
                                            const float (&h)[3], float* y) {
  *reinterpret_cast<float4*>(y) = make_float4(
      convert<0>(q, s, h), convert<1>(q, s, h), convert<2>(q, s, h), convert<3>(q, s, h));
  *reinterpret_cast<float4*>(y + 4) = make_float4(
      convert<4>(q, s, h), convert<5>(q, s, h), convert<6>(q, s, h), convert<7>(q, s, h));
}

template <typename TO>
__global__ void __launch_bounds__(NORM_THREADS)
normalize_u8_kernel(const unsigned char* __restrict__ x, TO* __restrict__ y, long long n,
                    Phase p) {
  const int lane = threadIdx.x & 31;
  // piece k of this thread starts at channel (k + 2 lane) % 3 in every tile:
  // rotate the triples once (pieces k and k + 3 share a rotation)
  float s[3][3], h[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = (r + 2 * lane + i) % 3;
      s[r][i] = c == 0 ? p.s[0] : (c == 1 ? p.s[1] : p.s[2]);
      h[r][i] = c == 0 ? p.h[0] : (c == 1 ? p.h[1] : p.h[2]);
    }
  }
  const long long tiles = n / TILE;
  const long long warps = static_cast<long long>(gridDim.x) * (NORM_THREADS / 32);
  const long long first = static_cast<long long>(blockIdx.x) * (NORM_THREADS / 32) +
                          (threadIdx.x >> 5);
  const long long own = 8LL * lane;  // this thread's offset in a 256-byte row
  for (long long w = first; w < tiles; w += warps) {
    const unsigned char* src = x + w * TILE + own;
    TO* dst = y + w * TILE + own;
    uint2 q[PIECES];
#pragma unroll
    for (int k = 0; k < PIECES; ++k) q[k] = load_once(src + 256 * k);
#pragma unroll
    for (int k = 0; k < PIECES; ++k) store_piece(q[k], s[k % 3], h[k % 3], dst + 256 * k);
  }
  const long long stride = warps * 32;  // the ragged end, a byte a thread
  for (long long i = tiles * TILE + first * 32 + lane; i < n; i += stride) {
    const int c = static_cast<int>(i % 3);
    store1(y + i, __fadd_rn(__fmul_rn(static_cast<float>(x[i]), p.s[c]), p.h[c]));
  }
}

template <typename TO>
int launch_normalize_u8(const void* x, void* y, long long n, const Phase& p,
                        cudaStream_t stream) {
  constexpr long long per_block = NORM_THREADS / 32;
  long long blocks = (n / TILE + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  normalize_u8_kernel<TO><<<static_cast<int>(blocks), NORM_THREADS, 0, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<TO*>(y), n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y[i] = x[i] * scale[i % 3] + shift[i % 3] over n uint8 values x (NHWC,
// 3 channels), y bf16, or fp32 with y_is_f32.
int aihab_normalize_u8(const void* x, void* y, int y_is_f32, long long n, float s0, float s1,
                       float s2, float h0, float h1, float h2, void* stream) {
  const Phase p = {{s0, s1, s2}, {h0, h1, h2}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_is_f32) return launch_normalize_u8<float>(x, y, n, p, st);
  return launch_normalize_u8<bf16>(x, y, n, p, st);
}

}  // extern "C"
