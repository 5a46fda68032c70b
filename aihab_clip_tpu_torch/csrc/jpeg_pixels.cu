// Hopper (sm_90a) kernels of the fast JPEG decode's pixel stage
// (ops/jpeg.py), after the host's Huffman decode (csrc/jpeg_entropy.cpp).
// No TPU kernel stands behind them: the JAX package decodes with libjpeg on
// the host (native/image_pipeline.cpp:58-111).  All are integer arithmetic,
// bit for bit with data/decode.py, which is libjpeg's.
//
// J1 jpeg_idct: every block of every photo of a batch, one thread a block:
//   dequantize (int16 coefficient x uint16 table), then libjpeg's islow
//   IDCT (jidctint.c, s = 8) or its reduced IDCTs (jidctred.c: 4x4, 2x2,
//   1x1) with their descales, as libjpeg-turbo runs them on x86: its SIMD
//   forms for s = 8, 4, 2 hold the dequantized inputs in int16 lanes
//   (islow also adds c0 +- c4, c7 + c3, c5 + c1 in 16 bits) and their sums
//   in int32 lanes, saturate the first pass's outputs to int16 (but for
//   the 2x2's column 0) and the outputs to 0..255, and the islow and 4x4
//   take a block with no AC rows through a shortcut (each column's DC
//   times 4, in 16 bits); its C 1x1 range-limits through libjpeg's
//   wrapping table.  Otherwise exact in int64, so on any photo's
//   coefficients these are the C routines' pixels.  The
//   coefficients arrive packed: only the 64 / 49 / 25 / 1 that the IDCT of
//   size s reads (the 4x4's followed by the flag of its zero test).  A
//   segment table (one row per photo and component) gives each run of
//   blocks its offsets, size and table; a thread finds its segment by
//   binary search over the rows' first blocks.
//   Bound: bytes (the packed coefficients read, the planes written; the
//   arithmetic is ~700 integer operations a block).
//
// J2 jpeg_color_resize: every output pixel of [N, D, D, 3], one thread a
//   pixel: the native path's bilinear resize (half-pixel centres, 11-bit
//   weights, one rounding at 22 bits) over the upright image, whose four
//   taps are each mapped through the EXIF orientation to the decoded
//   image, where each component is read through its upsampling (h2v1,
//   h1v2, h2v2 "fancy" with libjpeg's biases and edge replication, or box
//   replication) and the three go through libjpeg's fixed-point YCbCr ->
//   RGB (SCALEBITS 16).  Only the samples the resize reads are computed: a
//   12 MP photo resized to 224 touches ~4 x 224^2 of its 12 M pixels.
//   Its instance for four components (FOUR) takes Adobe CMYK, or YCCK
//   through libjpeg's ycck_cmyk_convert (255 minus the YCbCr -> RGB of the
//   first three), then cv2's CMYK -> BGR (k - ((255 - c) * k >> 8)).
//   Bound: bytes (the output, and the plane samples the taps read).
//
// They launch once for a whole batch of photos and take their layouts from
// tables the wrapper builds (ops/jpeg.py plan_batch).  Interface: plain C
// functions, loaded with ctypes; each launches on the stream it is given,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ops/jpeg.py's table layouts
enum { SEG_COEF = 0, SEG_PLANE, SEG_BW, SEG_NB, SEG_S, SEG_QT, SEG_FIRST, SEG_FIELDS = 8 };
enum { PH_OUT = 0, PH_NCOMP, PH_COLOR, PH_ORIENT, PH_W, PH_H, PH_SLOT, SLOT_FIELDS = 7 };
constexpr int PH_FIELDS = PH_SLOT + 4 * SLOT_FIELDS;
enum { SL_OFF = 0, SL_STRIDE, SL_DW, SL_DH, SL_HR, SL_VR, SL_MODE };
enum { MODE_NONE = 0, MODE_BOX, MODE_H2V1, MODE_H1V2, MODE_H2V2 };
enum { COLOR_YCC = 0, COLOR_RGB, COLOR_GRAY, COLOR_CMYK, COLOR_YCCK };

// jidctint.c / jidctred.c constants (CONST_BITS 13)
constexpr long long F0_211 = 1730, F0_298 = 2446, F0_390 = 3196, F0_509 = 4176,
                    F0_541 = 4433, F0_601 = 4926, F0_720 = 5906, F0_765 = 6270,
                    F0_850 = 6967, F0_899 = 7373, F1_061 = 8697, F1_175 = 9633,
                    F1_272 = 10426, F1_451 = 11893, F1_501 = 12299, F1_847 = 15137,
                    F1_961 = 16069, F2_053 = 16819, F2_172 = 17799, F2_562 = 20995,
                    F3_072 = 25172, F3_624 = 29692;

// x wrapped to int16 or int32, and saturated to int16, as SIMD lanes hold it
__device__ __forceinline__ long long wrap16(long long x) {
  return static_cast<long long>(static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF)));
}
__device__ __forceinline__ long long wrap32(long long x) {
  return static_cast<long long>(static_cast<int32_t>(static_cast<uint32_t>(x & 0xFFFFFFFF)));
}
__device__ __forceinline__ long long sat16(long long x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}
// an output sample saturated to 0..255 (packsswb, then + 128)
__device__ __forceinline__ uint8_t sat_sample(long long x) {
  return static_cast<uint8_t>((x < -128 ? -128 : (x > 127 ? 127 : x)) + 128);
}

// libjpeg's range-limit table, indexed by x & 1023
__device__ __forceinline__ uint8_t range_limit(long long x) {
  const int i = static_cast<int>(x & 1023);
  return static_cast<uint8_t>(i < 128 ? i + 128 : (i < 512 ? 255 : (i < 896 ? 0 : i - 896)));
}

// jpeg_idct_islow's 1-D pass (before its descale), with the SIMD form's
// 16-bit sums c0 +- c4, c7 + c3 and c5 + c1
__device__ __forceinline__ void islow_1d(const long long* c, long long* o) {
  const long long z1e = (c[2] + c[6]) * F0_541;
  const long long tmp2 = z1e - c[6] * F1_847;
  const long long tmp3 = z1e + c[2] * F0_765;
  const long long tmp0 = wrap16(c[0] + c[4]) * 8192;
  const long long tmp1 = wrap16(c[0] - c[4]) * 8192;
  const long long t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const long long a0 = c[7], a1 = c[5], a2 = c[3], a3 = c[1];
  const long long z3w = wrap16(a0 + a2), z4w = wrap16(a1 + a3);
  const long long z5 = (z3w + z4w) * F1_175;
  const long long z1 = -(a0 + a3) * F0_899;
  const long long z2 = -(a1 + a2) * F2_562;
  const long long z3 = -z3w * F1_961 + z5;
  const long long z4 = -z4w * F0_390 + z5;
  const long long o0 = a0 * F0_298 + z1 + z3;
  const long long o1 = a1 * F2_053 + z2 + z4;
  const long long o2 = a2 * F3_072 + z2 + z3;
  const long long o3 = a3 * F1_501 + z1 + z4;
  o[0] = t10 + o3; o[7] = t10 - o3;
  o[1] = t11 + o2; o[6] = t11 - o2;
  o[2] = t12 + o1; o[5] = t12 - o1;
  o[3] = t13 + o0; o[4] = t13 - o0;
}

// jpeg_idct_4x4's 1-D pass (c[4] is never read)
__device__ __forceinline__ void red4_1d(const long long* c, long long* o) {
  const long long tmp0 = c[0] * 16384;
  const long long tmp2 = c[2] * F1_847 - c[6] * F0_765;
  const long long t10 = tmp0 + tmp2, t12 = tmp0 - tmp2;
  const long long z1 = c[7], z2 = c[5], z3 = c[3], z4 = c[1];
  const long long o0 = -z1 * F0_211 + z2 * F1_451 - z3 * F2_172 + z4 * F1_061;
  const long long o2 = -z1 * F0_509 - z2 * F0_601 + z3 * F0_899 + z4 * F2_562;
  o[0] = t10 + o2; o[3] = t10 - o2;
  o[1] = t12 + o0; o[2] = t12 - o0;
}

// jpeg_idct_2x2's 1-D pass (reads c[0, 1, 3, 5, 7])
__device__ __forceinline__ void red2_1d(const long long* c, long long* o) {
  const long long t10 = c[0] * 32768;
  const long long odd = -c[7] * F0_720 + c[5] * F0_850 - c[3] * F1_272 + c[1] * F3_624;
  o[0] = t10 + odd;
  o[1] = t10 - odd;
}

// packed position of natural row / column i (-1: the IDCT does not read it)
__device__ __forceinline__ int pack4(int i) { return i == 4 ? -1 : (i < 4 ? i : i - 1); }
__device__ __forceinline__ int pack2(int i) {
  return i == 0 ? 0 : ((i & 1) ? (i + 1) >> 1 : -1);
}

template <int S>
__device__ void idct_block(const int16_t* __restrict__ cf, const uint16_t* __restrict__ q,
                           uint8_t* __restrict__ out, long long stride) {
  if constexpr (S == 1) {
    out[0] = range_limit((static_cast<long long>(cf[0]) * q[0] + 4) >> 3);
  } else {
    constexpr int D1 = S == 8 ? 11 : (S == 4 ? 12 : 13);  // pass-1 descale
    constexpr int D2 = S == 8 ? 18 : (S == 4 ? 19 : 20);  // pass-2 descale
    constexpr int K = S == 8 ? 8 : (S == 4 ? 7 : 5);       // packed row length
    // the SIMD islow and 4x4 test the AC rows for zero (the 4x4's column 4,
    // which the packing drops, through its 50th value); with none, pass 1
    // is the DC x 4
    bool flat = S != 2;
    for (int i = K; i < (S == 4 ? 50 : K * K) && flat; ++i) flat = cf[i] == 0;
    long long ws[S][8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int px = S == 8 ? x : (S == 4 ? pack4(x) : pack2(x));
      if (px < 0) {
#pragma unroll
        for (int r = 0; r < S; ++r) ws[r][x] = 0;
        continue;
      }
      if (flat) {
        const long long dc = wrap16(wrap16(static_cast<long long>(cf[px]) * q[x]) * 4);
#pragma unroll
        for (int r = 0; r < S; ++r) ws[r][x] = dc;
        continue;
      }
      long long in[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int pr = S == 8 ? r : (S == 4 ? pack4(r) : pack2(r));
        in[r] = pr < 0 ? 0 : wrap16(static_cast<long long>(cf[pr * K + px]) * q[r * 8 + x]);
      }
      long long o[8];
      if constexpr (S == 8) islow_1d(in, o);
      else if constexpr (S == 4) red4_1d(in, o);
      else red2_1d(in, o);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const long long v = wrap32(o[r] + (1LL << (D1 - 1))) >> D1;
        ws[r][x] = S == 2 && x == 0 ? v : sat16(v);
      }
    }
#pragma unroll
    for (int y = 0; y < S; ++y) {
      long long o[8];
      if constexpr (S == 8) islow_1d(ws[y], o);
      else if constexpr (S == 4) red4_1d(ws[y], o);
      else red2_1d(ws[y], o);
#pragma unroll
      for (int x = 0; x < S; ++x) {
        out[y * stride + x] = sat_sample(wrap32(o[x] + (1LL << (D2 - 1))) >> D2);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
jpeg_idct_kernel(const int16_t* __restrict__ coef, const uint16_t* __restrict__ qt,
                 const long long* __restrict__ segs, uint8_t* __restrict__ planes, int n_seg,
                 long long total) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < total;
       g += step) {
    int lo = 0, hi = n_seg - 1;  // the last segment whose first block is <= g
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (segs[mid * SEG_FIELDS + SEG_FIRST] <= g) lo = mid;
      else hi = mid - 1;
    }
    const long long* sg = segs + lo * SEG_FIELDS;
    const long long b = g - sg[SEG_FIRST];
    const int s = static_cast<int>(sg[SEG_S]);
    const long long bw = sg[SEG_BW];
    const long long stride = bw * s;
    uint8_t* out = planes + sg[SEG_PLANE] + (b / bw) * s * stride + (b % bw) * s;
    const uint16_t* q = qt + sg[SEG_QT] * 64;
    const int k = s == 8 ? 64 : (s == 4 ? 50 : (s == 2 ? 25 : 1));
    const int16_t* cf = coef + sg[SEG_COEF] + b * k;
    switch (s) {
      case 8: idct_block<8>(cf, q, out, stride); break;
      case 4: idct_block<4>(cf, q, out, stride); break;
      case 2: idct_block<2>(cf, q, out, stride); break;
      default: idct_block<1>(cf, q, out, stride); break;
    }
  }
}

// component `slot` at unoriented output position (r, c), through its upsampling
__device__ __forceinline__ int sample(const uint8_t* __restrict__ planes,
                                      const long long* __restrict__ slot, long long r,
                                      long long c) {
  const uint8_t* p = planes + slot[SL_OFF];
  const long long stride = slot[SL_STRIDE], dw = slot[SL_DW], dh = slot[SL_DH];
  switch (static_cast<int>(slot[SL_MODE])) {
    case MODE_NONE:
      return p[r * stride + c];
    case MODE_BOX:
      return p[(r / slot[SL_VR]) * stride + c / slot[SL_HR]];
    case MODE_H2V1: {
      const long long x = c >> 1;
      const bool odd = c & 1;
      const long long nx = odd ? (x + 1 < dw ? x + 1 : dw - 1) : (x > 0 ? x - 1 : 0);
      return (3 * p[r * stride + x] + p[r * stride + nx] + (odd ? 2 : 1)) >> 2;
    }
    case MODE_H1V2: {
      const long long y = r >> 1;
      const bool odd = r & 1;
      const long long ny = odd ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0);
      return (3 * p[y * stride + c] + p[ny * stride + c] + (odd ? 2 : 1)) >> 2;
    }
    default: {  // MODE_H2V2
      const long long y = r >> 1, x = c >> 1;
      const long long ny = (r & 1) ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0);
      const bool oddc = c & 1;
      const long long nx = oddc ? (x + 1 < dw ? x + 1 : dw - 1) : (x > 0 ? x - 1 : 0);
      const int cs = 3 * p[y * stride + x] + p[ny * stride + x];
      const int cn = 3 * p[y * stride + nx] + p[ny * stride + nx];
      return (3 * cs + cn + (oddc ? 7 : 8)) >> 4;
    }
  }
}

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// libjpeg's fixed-point YCbCr -> RGB (build_ycc_rgb_table, SCALEBITS 16)
__device__ __forceinline__ void ycc_rgb(int y, int c2, int c3, int* px) {
  const int cb = c2 - 128, cr = c3 - 128;
  px[0] = clamp255(y + ((91881 * cr + 32768) >> 16));
  px[1] = clamp255(y + ((-22554 * cb - 46802 * cr + 32768) >> 16));
  px[2] = clamp255(y + ((116130 * cb + 32768) >> 16));
}

// the upright RGB pixel at oriented position (r, c) of the photo `row`
template <bool FOUR>
__device__ __forceinline__ void rgb_at(const uint8_t* __restrict__ planes,
                                       const long long* __restrict__ row, long long r,
                                       long long c, int* px) {
  const int orient = static_cast<int>(row[PH_ORIENT]);
  const bool transposed = orient >= 5;
  const long long wo = transposed ? row[PH_H] : row[PH_W];
  const long long ho = transposed ? row[PH_W] : row[PH_H];
  const long long r1 = (orient == 3 || orient == 4 || orient == 7 || orient == 8) ? ho - 1 - r : r;
  const long long c1 = (orient == 2 || orient == 3 || orient == 6 || orient == 7) ? wo - 1 - c : c;
  const long long ru = transposed ? c1 : r1, cu = transposed ? r1 : c1;
  const int color = static_cast<int>(row[PH_COLOR]);
  const int y = sample(planes, row + PH_SLOT, ru, cu);
  if (!FOUR && color == COLOR_GRAY) {
    px[0] = px[1] = px[2] = y;
    return;
  }
  const int c2 = sample(planes, row + PH_SLOT + SLOT_FIELDS, ru, cu);
  const int c3 = sample(planes, row + PH_SLOT + 2 * SLOT_FIELDS, ru, cu);
  if constexpr (FOUR) {
    const int k = sample(planes, row + PH_SLOT + 3 * SLOT_FIELDS, ru, cu);
    int cmy[3] = {y, c2, c3};
    if (color == COLOR_YCCK) {  // ycck_cmyk_convert
      int rgb[3];
      ycc_rgb(y, c2, c3, rgb);
      for (int ch = 0; ch < 3; ++ch) cmy[ch] = 255 - rgb[ch];
    }
    for (int ch = 0; ch < 3; ++ch) px[ch] = k - (((255 - cmy[ch]) * k) >> 8);
  } else if (color == COLOR_RGB) {
    px[0] = y; px[1] = c2; px[2] = c3;
  } else {
    ycc_rgb(y, c2, c3, px);
  }
}

template <bool FOUR>
__global__ void __launch_bounds__(kThreads)
jpeg_color_resize_kernel(const uint8_t* __restrict__ planes, const long long* __restrict__ photos,
                         const int* __restrict__ taps_x, const int* __restrict__ taps_y,
                         uint8_t* __restrict__ out, int n_photos, int dim) {
  const long long per = static_cast<long long>(dim) * dim;
  const long long total = per * n_photos;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < total;
       g += step) {
    const long long p = g / per;
    const int y = static_cast<int>((g % per) / dim), x = static_cast<int>(g % dim);
    const long long* row = photos + p * PH_FIELDS;
    const int* tx = taps_x + (p * dim + x) * 3;
    const int* ty = taps_y + (p * dim + y) * 3;
    long long acc[3] = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long wy = i ? ty[2] : 2048 - ty[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long wx = j ? tx[2] : 2048 - tx[2];
        int px[3];
        rgb_at<FOUR>(planes, row, ty[i], tx[j], px);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[ch] += px[ch] * wy * wx;
      }
    }
    uint8_t* o = out + ((row[PH_OUT] * dim + y) * dim + x) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const long long v = (acc[ch] + (1LL << 21)) >> 22;
      o[ch] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > 1048576 ? 1048576 : blocks));
}

}  // namespace

extern "C" {

// J1 over `total` blocks described by n_seg rows of `segs`.
int aihab_jpeg_idct(const void* coef, const void* qtables, const void* segs, void* planes,
                    int n_seg, long long total, void* stream) {
  jpeg_idct_kernel<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coef), static_cast<const uint16_t*>(qtables),
      static_cast<const long long*>(segs), static_cast<uint8_t*>(planes), n_seg, total);
  return static_cast<int>(cudaGetLastError());
}

// J2 over n_photos rows of `photos`, each into out[row[PH_OUT]] ([dim, dim, 3]).
int aihab_jpeg_color_resize(const void* planes, const void* photos, const void* taps_x,
                            const void* taps_y, void* out, int n_photos, int dim,
                            void* stream) {
  jpeg_color_resize_kernel<false><<<grid_for(static_cast<long long>(n_photos) * dim * dim),
                                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const long long*>(photos),
      static_cast<const int*>(taps_x), static_cast<const int*>(taps_y),
      static_cast<uint8_t*>(out), n_photos, dim);
  return static_cast<int>(cudaGetLastError());
}

// J2's four-component instance (CMYK, YCCK rows), as aihab_jpeg_color_resize.
int aihab_jpeg_color_resize_cmyk(const void* planes, const void* photos, const void* taps_x,
                                 const void* taps_y, void* out, int n_photos, int dim,
                                 void* stream) {
  jpeg_color_resize_kernel<true><<<grid_for(static_cast<long long>(n_photos) * dim * dim),
                                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const long long*>(photos),
      static_cast<const int*>(taps_x), static_cast<const int*>(taps_y),
      static_cast<uint8_t*>(out), n_photos, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
