// Hopper (sm_90a) int8 (W8A8 dynamic) kernels: the int8 serving towers of
// SigLIP and CLIP ViT and the int8 frozen prefixes of their PEFT steps.
//
// They replace the Pallas TPU kernels of aihab_clip_tpu/ops/quant_matmul.py:
//   quant_matmul_fused      (K8,  :376, pallas_call :415) = row_quant [+ LN] ->
//       int8_gemm (dequant + bias -> act [+ residual], stored in x's dtype);
//   quant_matmul_fused_qout (K9,  :130, :141) = row_quant + LN -> int8_gemm
//       (dequant + bias -> act, fp32 y) -> row_quant of y (int8 codes + scales);
//   quant_matmul_q8in       (K10, :165, :176) = int8_gemm on rows quantized
//       before (dequant + bias + residual);
//   quant_attn_block_split  (K13, :622, :656) = row_quant + LN -> int8_gemm over
//       every head group's q|k|v columns (bf16, q * 1/sqrt(d) in fp32 before its
//       store) -> attention (block_kernels.cu, fp32 output) -> row_quant per head
//       group -> int8_gemm with a dequant per group, the group partials summed in
//       fp32, in group order, onto part_0 + b_out + x;
//   quant_attn_block_fused  (K12, :490, :509) = K13 with one group, its
//       attention normalising P before the bf16 cast as the TPU kernel does:
//       the whole attention row requantized, out-proj + b_out + x;
//   quant_mlp_block_fused   (K11, :238, :262) = K9 -> K10 over the block's MLP;
//   quant_full_block_fused  (K14, :794, :817) = K12 with the mid-block residual
//       y1 stored in fp32 -> row_quant + LN2 -> int8_gemm (act, fp32 h) ->
//       row_quant per mlp_chunks slice of h -> int8_gemm in the residual-first
//       mode, out = (y1 + b2) + part_0 + part_1 ... (:779-790);
//   quant_convnext_mlp_block (K15, :319, :341) = K11's chain with ConvNeXt's
//       quirks: row_quant + LN (eps 1e-6) of the dwconv output y -> int8_gemm
//       (gelu_poly, fp32 h) -> row_quant of the whole hidden row -> int8_gemm
//       with the gamma epilogue, out = res + (part + b2) * gamma (:314-316),
//       the residual being the block input, not y.
// The Pallas programs keep a whole weight matrix (SO400M's c_fc: 5 MB int8)
// resident in VMEM and quantize, multiply and requantize one row tile in one
// program.  An SM has 227 KB, so the chain is cut at its GEMMs: a row's codes
// cross device memory once, in int8, and K9's fp32 y once each way.
//
// Bound (H100 SXM: 1,979 TOPS int8 dense, 3.35 TB/s).  At SO400M, batch 64
// (M = 36,864 rows, W = 1152, hidden 4304): K9 and K10 are 365.6 GOP each
// (0.185 ms at the int8 rate) and compute-bound; K13 is 391.4 GOP of int8 GEMM
// plus 97.8 GFLOP of bf16 attention (0.297 ms); K8, the patchify (K = 768),
// moves 142 MB (0.042 ms, bytes-bound).  The design is the simple one that is
// right: int8 tensor cores through mma.sync.m16n8k32 (exact int32
// accumulation), 128x128x32 block tiles fed by ldmatrix from a 4-stage
// cp.async ring, 8 warps of 64x32; no wgmma and no TMA.  Hopper's int8 MMA
// takes no transposed operand, so both operands are K-major: every weight is
// laid out once, at quantize time, as [N, K].  The row quantization is its own
// bytes-bound pass, one warp per row.  K9's requantize needs the whole
// 4304-wide row, which no GEMM tile sees: its GEMM stores fp32 y and a second
// row_quant pass reads it back (1.27 GB per block at batch 64, ~0.38 ms of
// bytes, which a fused design removes later).  At ViT-B/16, batch 64 (M =
// 12,608, W = 768, hidden 3072) K14 is 178.5 GOP of int8 GEMM plus 7.6 GFLOP
// of bf16 attention (0.098 ms), K12 59.5 GOP (0.038 ms) and K11 119 GOP
// (0.060 ms), all bound by operations.  At ConvNeXt base_w (batch 64, 256 px)
// every K15 launch is 68.7 GOP (0.035 ms at the int8 rate); at stage 0 (M =
// 262,144 rows of C = 128) its y, res and out alone move 201 MB (0.060 ms), so
// it is bound by bytes there, and its fp32 hidden row (4C wide) crosses device
// memory once each way (1.07 GB).  K13's groups are 144 columns
// wide, no multiple of the 32-byte k-step: row_quant pads each group's codes
// with zeros to 160, the out-proj weight is padded the same way, and the GEMM
// dequantizes its int32 sum at each group boundary with the group's row scale.
//
// Numerics: the rounding points of the TPU kernels.  LN and all scales in
// fp32; s = max(amax, 1e-12) * (1/127); codes = clip(rint(x / s), -127, 127)
// with an IEEE division and round-half-even (this source is never compiled
// with --use_fast_math); dequant acc * (s_x * s_w) in that association; no
// contraction into FMAs at these points (__fmul_rn, __fadd_rn).
//
// Interface: plain C functions, loaded with ctypes.  Each launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Preconditions the Python wrappers check: int8 operands row-major with K a
// multiple of 16 and every pointer 16-byte aligned, N a multiple of 8, the
// group span K / G a multiple of 32 when G > 1.

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// row_quant: per row r of x [M, K] (bf16 or fp32), an optional fp32 LN over
// all K columns, ((x - mean) * rstd) * ln_s + ln_b (quant_matmul.py:50-54),
// then per group g of KG columns: s[r, g] = max(amax, 1e-12) * (1/127) and
// codes q[r, g * KGP + j] = clip(rint(v / s), -127, 127) for j < KG, zeros for
// j in [KG, KGP).  One warp per row.
// ---------------------------------------------------------------------------

constexpr int RQ_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(RQ_THREADS)
row_quant_kernel(const T* __restrict__ x, int M, int K, int KG, int KGP,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_b, float eps,
                 int8_t* __restrict__ q, float* __restrict__ s) {
  const int r = blockIdx.x * (RQ_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const T* row = x + static_cast<size_t>(r) * K;
  const int G = K / KG;
  float mean = 0.f, rstd = 1.f;
  if (ln_s != nullptr) {  // two-pass mean and variance, as jnp.mean computes them
    float sum = 0.f;
    for (int c = lane; c < K; c += 32) sum = __fadd_rn(sum, to_f32(row[c]));
    mean = __fdiv_rn(warp_sum(sum), static_cast<float>(K));
    float sq = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __fsub_rn(to_f32(row[c]), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(K));
    rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  auto value = [&](int c) {
    const float v = to_f32(row[c]);
    if (ln_s == nullptr) return v;
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), ln_s[c]), ln_b[c]);
  };
  int8_t* qrow = q + static_cast<size_t>(r) * G * KGP;
  for (int g = 0; g < G; ++g) {
    float amax = 0.f;
    for (int j = lane; j < KG; j += 32) amax = fmaxf(amax, fabsf(value(g * KG + j)));
    const float sc = __fmul_rn(fmaxf(warp_max(amax), 1e-12f), 1.0f / 127.0f);
    for (int j = lane; j < KGP; j += 32) {
      float code = 0.f;
      if (j < KG) code = fminf(fmaxf(rintf(__fdiv_rn(value(g * KG + j), sc)), -127.f), 127.f);
      qrow[g * KGP + j] = static_cast<int8_t>(code);
    }
    if (lane == 0) s[static_cast<size_t>(r) * G + g] = sc;
  }
}

// ---------------------------------------------------------------------------
// int8_gemm: Y[M, N] = epilogue(A[M, K] . B[N, K]^T), A and B int8, K-major.
// K is G groups of K / G columns (G = 1: one group); group g's int32 sum is
// dequantized with its own row scale: part_g = float(acc_g) * (sa[m, g] * ws[n]).
//   G == 1: y = act(part_0 + bias); y *= q_scale on the q columns (n with
//           n % group_cols < q_cols); y *= gamma[n] (if given); y += R (if
//           given); stored as TO.
//   G > 1:  y = (part_0 + bias) + R, then y += part_g for g = 1 .. G-1 in order
//           (quant_matmul.py:609-615); stored as TO.
//   RES_FIRST (any G >= 1, R fp32): y = (R + bias) + part_0, then y += part_g
//           in order (K14's c_proj, quant_matmul.py:779-790); stored as TO.
// Block tile 128x128, k-step 32, 8 warps of 64x32 (4x4 m16n8k32 tiles); both
// operand tiles stream through a 4-stage cp.async ring into shared rows of 48
// bytes (32 + 16 of padding, which keeps ldmatrix free of bank conflicts).
// Two blocks share an SM, so a thread has at most 128 registers: at 132 (the
// gamma epilogue's, unbounded) one block fits and the GEMM ran ~2x slower.
// ---------------------------------------------------------------------------

constexpr int QBM = 128, QBN = 128, QBK = 32, QSTAGES = 4, QTHREADS = 256;
constexpr int QPITCH = QBK + 16;                     // bytes per shared row
constexpr int Q_STAGE = QBM * QPITCH;                // bytes of one operand stage
constexpr int QGEMM_SMEM = QSTAGES * 2 * Q_STAGE;   // 48 KB
static_assert(QBM == QBN, "the A and B stages share one size");
static_assert(QBM * QBK / 16 == QTHREADS, "one 16-byte copy per thread per operand");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c[0..3] += A(16x32, row) . B(32x8, col), s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool GROUPED, bool RES_FIRST, typename TR, typename TO>
__global__ void __launch_bounds__(QTHREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
                 const int8_t* __restrict__ B, const float* __restrict__ ws,
                 const float* __restrict__ bias, const float* __restrict__ gamma,
                 const TR* __restrict__ R, TO* __restrict__ Y,
                 int M, int N, int K, int G, int act, float q_scale, int q_cols,
                 int group_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;
  unsigned char* Bs = smem + QSTAGES * Q_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * QBM, n0 = blockIdx.x * QBN;
  const int nk = (K + QBK - 1) / QBK;
  const int kt_per_group = K / G / QBK;  // used when GROUPED

  auto load_stage = [&](int kt, int stage) {  // one 16-byte copy per operand
    const int r = tid >> 1, c = (tid & 1) * 16, gk = kt * QBK + c;
    const bool oka = m0 + r < M && gk < K, okb = n0 + r < N && gk < K;
    cp_async16(As + stage * Q_STAGE + r * QPITCH + c,
               oka ? A + static_cast<size_t>(m0 + r) * K + gk : A, oka);
    cp_async16(Bs + stage * Q_STAGE + r * QPITCH + c,
               okb ? B + static_cast<size_t>(n0 + r) * K + gk : B, okb);
  };

#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, columns wn*32
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix lane addresses: A matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31);
  // B matrices (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
  const int a_off = (wm * 64 + (lane & 15)) * QPITCH + (lane >> 4) * 16;
  const int b_off = (wn * 32 + ((lane >> 4) << 3) + (lane & 7)) * QPITCH + ((lane >> 3) & 1) * 16;

  float wsv[4][2], bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2 + e;
      wsv[ni][e] = col < N ? ws[col] : 0.f;
      bv[ni][e] = col < N ? bias[col] : 0.f;
    }

  int acc[4][4][4];
  float yv[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // yv (+)= float(acc) * (sa[row, g] * ws[col]); acc = 0.  Element e of a
  // fragment: row gid + (e / 2) * 8, column tig * 2 + e % 2.
  auto dequant = [&](int g) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + gid + h * 8;
        const float sr = row < M ? sa[static_cast<size_t>(row) * G + g] : 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int& a = acc[mi][ni][h * 2 + e];
            float& y = yv[mi][ni][h * 2 + e];
            const float part = __fmul_rn(__int2float_rn(a), __fmul_rn(sr, wsv[ni][e]));
            if (g == 0) {
              const int col = n0 + wn * 32 + ni * 8 + tig * 2 + e;
              const bool has_r = GROUPED && R != nullptr && row < M && col < N;
              const float r = has_r ? to_f32(R[static_cast<size_t>(row) * N + col]) : 0.f;
              if (RES_FIRST) {
                y = __fadd_rn(__fadd_rn(r, bv[ni][e]), part);
              } else {
                y = __fadd_rn(part, bv[ni][e]);
                if (has_r) y = __fadd_rn(y, r);
              }
            } else {
              y = __fadd_rn(y, part);
            }
            a = 0;
          }
      }
  };

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<QSTAGES - 2>();
    __syncthreads();  // tile kt is in shared memory; stage (kt-1) % QSTAGES is free
    const int nt = kt + QSTAGES - 1;
    if (nt < nk) load_stage(nt, nt % QSTAGES);
    cp_async_commit();
    const unsigned a_base = smem_u32(As + (kt % QSTAGES) * Q_STAGE) + a_off;
    const unsigned b_base = smem_u32(Bs + (kt % QSTAGES) * Q_STAGE) + b_off;
    unsigned af[4][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a_base + mi * 16 * QPITCH, af[mi]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned r[4];
      ldmatrix_x4(b_base + p * 16 * QPITCH, r);
      bfr[2 * p][0] = r[0];
      bfr[2 * p][1] = r[1];
      bfr[2 * p + 1][0] = r[2];
      bfr[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    if constexpr (GROUPED) {
      if ((kt + 1) % kt_per_group == 0) dequant((kt + 1) / kt_per_group - 1);
    }
  }
  cp_async_wait<0>();
  if constexpr (!GROUPED) dequant(0);

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + gid + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tig * 2;
        if (col >= N) continue;  // N is even: col + 1 < N too
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = yv[mi][ni][h * 2 + e];
          if constexpr (!GROUPED) {
            y = act_f32(y, act);
            if (q_cols > 0 && col % group_cols < q_cols) y = __fmul_rn(y, q_scale);
            if (gamma != nullptr) y = __fmul_rn(y, gamma[col + e]);
            if (R != nullptr)
              y = __fadd_rn(y, to_f32(R[static_cast<size_t>(row) * N + col + e]));
          }
          o[e] = y;
        }
        store2(Y + static_cast<size_t>(row) * N + col, o[0], o[1]);
      }
    }
}

template <bool GROUPED, bool RES_FIRST, typename TR, typename TO>
int launch_int8_gemm(const void* a, const float* sa, const void* w, const float* ws,
                     const float* bias, const float* gamma, const void* r, void* y, int M,
                     int N, int K, int G, int act, float q_scale, int q_cols, int group_cols,
                     cudaStream_t stream) {
  auto kernel = int8_gemm_kernel<GROUPED, RES_FIRST, TR, TO>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QGEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + QBN - 1) / QBN, (M + QBM - 1) / QBM);
  kernel<<<grid, QTHREADS, QGEMM_SMEM, stream>>>(
      static_cast<const int8_t*>(a), sa, static_cast<const int8_t*>(w), ws, bias, gamma,
      static_cast<const TR*>(r), static_cast<TO*>(y), M, N, K, G, act, q_scale, q_cols,
      group_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_row_quant(const void* x, int M, int K, int KG, int KGP, const float* ln_s,
                     const float* ln_b, float eps, void* q, void* s, cudaStream_t stream) {
  const int rows_per_block = RQ_THREADS / 32;
  row_quant_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, RQ_THREADS, 0, stream>>>(
      static_cast<const T*>(x), M, K, KG, KGP, ln_s, ln_b, eps, static_cast<int8_t*>(q),
      static_cast<float*>(s));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes q[M, (K / KG) * KGP] (int8) and scales s[M, K / KG] (fp32) of x[M, K]
// (bf16, or fp32 with x_f32), per group of KG columns, each group's codes
// padded with zeros to KGP; LN over the row first when ln_s is non-null.
int aihab_row_quant(const void* x, int x_f32, int M, int K, int KG, int KGP,
                    const float* ln_s, const float* ln_b, float eps, void* q, void* s,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32) return launch_row_quant<float>(x, M, K, KG, KGP, ln_s, ln_b, eps, q, s, st);
  return launch_row_quant<bf16>(x, M, K, KG, KGP, ln_s, ln_b, eps, q, s, st);
}

// y[M, N] = epilogue(a[M, K] . w[N, K]^T) (int8, K-major), dequantized with
// the row scales sa[M, groups] and column scales ws[N], + bias[N]; r (may be
// null) and y bf16 or fp32.  gamma[N] (may be null; groups 1 and not
// res_first only) scales each column before the residual: y = r + (part +
// bias) * gamma.  act is none, quick_gelu, gelu_tanh or gelu_poly's sig5
// form (the other forms run in block_kernels.cu's act_pass after a GEMM with
// no activation).  groups > 1: r and y share one dtype, act is none and q_cols
// is 0 (the wrappers check).  res_first (groups >= 1): r fp32 is added to the
// bias before the first partial; act none, q_cols 0.
int aihab_int8_gemm(const void* a, const float* sa, const void* w, const float* ws,
                    const float* bias, const float* gamma, const void* r, int r_f32, void* y,
                    int y_f32, int M, int N, int K, int groups, int res_first, int act,
                    float q_scale, int q_cols, int group_cols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (((res_first || groups > 1) && gamma != nullptr) || act > ACT_GELU_SIG5)
    return static_cast<int>(cudaErrorInvalidValue);  // act 4-6 run in act_pass
  if (res_first) {
    if (!r_f32) return static_cast<int>(cudaErrorInvalidValue);
    if (y_f32)
      return launch_int8_gemm<true, true, float, float>(a, sa, w, ws, bias, nullptr, r, y, M,
                                                        N, K, groups, ACT_NONE, 1.f, 0, 1, s);
    return launch_int8_gemm<true, true, float, bf16>(a, sa, w, ws, bias, nullptr, r, y, M, N,
                                                     K, groups, ACT_NONE, 1.f, 0, 1, s);
  }
  if (groups > 1) {
    if (y_f32)
      return launch_int8_gemm<true, false, float, float>(a, sa, w, ws, bias, nullptr, r, y, M,
                                                         N, K, groups, ACT_NONE, 1.f, 0, 1, s);
    return launch_int8_gemm<true, false, bf16, bf16>(a, sa, w, ws, bias, nullptr, r, y, M, N,
                                                     K, groups, ACT_NONE, 1.f, 0, 1, s);
  }
  if (r_f32 && y_f32)
    return launch_int8_gemm<false, false, float, float>(a, sa, w, ws, bias, gamma, r, y, M, N,
                                                        K, 1, act, q_scale, q_cols,
                                                        group_cols, s);
  if (r_f32)
    return launch_int8_gemm<false, false, float, bf16>(a, sa, w, ws, bias, gamma, r, y, M, N,
                                                       K, 1, act, q_scale, q_cols,
                                                       group_cols, s);
  if (y_f32)
    return launch_int8_gemm<false, false, bf16, float>(a, sa, w, ws, bias, gamma, r, y, M, N,
                                                       K, 1, act, q_scale, q_cols,
                                                       group_cols, s);
  return launch_int8_gemm<false, false, bf16, bf16>(a, sa, w, ws, bias, gamma, r, y, M, N, K,
                                                    1, act, q_scale, q_cols, group_cols, s);
}

}  // extern "C"
