// Hopper (sm_90a) kernels for the pre-LN CLIP and SigLIP transformer blocks.
//
// They replace the Pallas TPU kernels of aihab_clip_tpu/ops/block_kernel.py:
//   full_block_fused (:1056, pallas_call :1083)  = ln_gemm -> attention ->
//       gemm_residual -> ln_gemm(act) -> gemm_residual, residual y1 in fp32;
//   attn_block_fused (:85, :120)  = ln_gemm -> attention -> gemm_residual;
//   mlp_block_fused  (:613, :631) = ln_gemm(act) -> gemm_residual;
//   attn_block_split (:834, :861) = ln_gemm over every head group's q|k|v
//       columns at once, q scaled in the fp32 epilogue before its bf16 store
//       -> attention (grouped layout, scale 1) -> gemm_residual over the
//       out-proj rows of all groups (the TPU kernel's fp32 partial sum);
//   mlp_block_split  (:525, :577/:587) = per hidden chunk c: ln_gemm(act) over
//       c_fc's columns of c -> gemm_residual over c_proj's rows of c, whose
//       residual is x (chunk 0, + b_proj) or the previous partial, stored in
//       x's dtype (or fp32) as the TPU kernel stores it between chunks;
//   convnext_mlp_block (:688, :742/:752) = per hidden chunk c: ln_gemm (LN eps
//       1e-6 over the dwconv output y, gelu_poly) over fc1's columns of c ->
//       gemm_residual over fc2's rows of c with the per-column gamma epilogue:
//       chunk 0 stores res + (p_0 + b2) * gamma, chunk c > 0 acc + p_c * gamma,
//       in y's dtype (the residual is the block input, not y);
//   mlp_block_train  (:213; forward :239, backward :287) = K3's chain with the
//       c_fc pre-activation h_pre stored beside h (EPI_PRE), and a backward
//       of three launches: dy @ W_proj^T with the quick_gelu' epilogue
//       (EPI_DGELU) -> dh_pre, dh_pre @ W_fc^T -> dln (fp32), ln_bwd_kernel
//       -> dx = dy + LN_bwd(dln) and dln in bf16;
// and of aihab_clip_tpu/ops/fused_linear.py:
//   ln_matmul (:299; :159, :188) = ln_gemm, matmul_residual (:326; :227,
//       :255) = gemm_residual, over the same instances;
// and of aihab_clip_tpu/ops/attention.py:
//   _pallas_attention (:91, :113), fused_attention's forward (K6) = attention
//       over separate q, k, v, storing the row log-sum-exp for the backward
//       (fused_attention_bwd.cu).
// The Pallas program keeps a whole ViT-B block's 14 MB of weights resident in
// VMEM and runs one program per image.  A Hopper SM has 227 KB of shared
// memory, so the block is cut at its GEMM boundaries instead: the weights
// stream through shared memory tile by tile (from L2, which holds all 14 MB),
// and qkv, the attention output and the MLP hidden activation cross device
// memory once each, in bf16, which is where the TPU kernel rounds them too.
//
// Bound.  At ViT-B/16 (S=197, W=768, H=3072) a block costs 2.9 GFLOP per image
// against ~0.6 MB of activations per image plus 14 MB of weights per launch, so
// at batch >= 64 every launch is compute-bound (989 TFLOP/s bf16 dense on an
// H100 SXM).  The design answer is Hopper's: every bf16 GEMM is one persistent
// TMA + wgmma kernel (a producer warp keeping an mbarrier ring of k-steps in
// flight, two consumer warpgroups on 128 x 128 tiles, an epilogue that reads
// the accumulators through a shared-memory scratch and stores 16-byte rows),
// LN runs as a row pass that writes LN(x) in bf16 ahead of it, and the
// attention is a one-pass flash kernel on wgmma with P in registers.  The
// measured gap to the bound is in PERF.md.
//
// At SigLIP SO400M (S=576, W=1152, 16 heads of 72, hidden 4304) the same
// kernels run at other widths: head_dim 72 is a template instance of the
// attention kernels with the contraction zero-padded to 80, and the 2152-wide
// MLP chunks take the GEMM's ragged N and K edges (TMA's zero fill).  The
// LAION ViT-g/14 and ViT-bigG/14 towers (S=257; W=1408, 16 heads of 88,
// hidden 6144; W=1664, 16 heads of 104, hidden 8192) take head_dim 88 and
// 104 the same way: instances padded to 96 and 112 (the flash kernel's
// Q K^T) or 128 (bigG's P V).  At batch 64 a bigG block is
// 1.29 TFLOP (1.30 ms at 989 TFLOP/s), 28 GFLOP of it attention.
//
// At ConvNeXt base_w (batch 64, 256 px) every convnext_mlp_block launch is
// 16 M C^2 = 68.7 GFLOP (M C^2 is the same in every stage: M = 262,144 rows
// of C = 128 at stage 0, 4,096 of 1,024 at stage 3), 0.069 ms of operations;
// stage 0 also moves at least 201 MB of y, res and out (0.060 ms).  The split
// design writes the bf16 hidden h [M, 4C] through device memory (268 MB each
// way at stage 0), which the TPU kernel kept in VMEM.  Since the GEMM streams
// its weight tiles, the whole hidden width runs in one chunk.
//
// The train MLP (K17) at ViT-B/16 batch 16 (M = 3,152 rows): 29.8 GFLOP
// forward and 29.8 GFLOP for the backward's dx chain, 0.030 ms each at 989
// TFLOP/s; the weight gradients are cuBLAS products over the emitted h_pre,
// dh_pre and dln, as the TPU kernel left them to XLA.  The backward's row
// kernel needs the full-row means of the LN backward over W, so it cannot sit
// in a 128-column GEMM tile: it is a pass of its own, one warp per row.
// W_proj^T [W, H] and W_fc^T [H, W] are torch's c_proj.weight and
// c_fc.weight as they are stored, so the backward GEMMs read them row-major.
//
// Interface: plain C functions, loaded with ctypes.  Each launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Preconditions the Python wrappers check: K and N multiples of 8, every
// pointer 16-byte aligned, row-major tensors (a weight may be a column slice
// of a wider matrix: its row stride ldw, a multiple of 8, is an argument),
// head_dim 64, 72, 88 or 104; these are also every TMA precondition (16-byte aligned
// bases and row strides).  The qkv layout is grouped: head h of group h / g sits at
// columns (h / g) * 3gD + {0, gD, 2gD} + (h % g) * D for q, k and v, which
// with g = heads is the packed q | k | v of CLIP's in_proj.  The q-scale
// epilogue multiplies columns n with n % group_cols < q_cols by q_scale.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// LN rows: xn[r] = bf16((x[r] - mean) * rstd * ln_s + ln_b), the statistics
// two-pass fp32 (block_kernel.py:33), up to a warp per row (fewer lanes for
// K < 256).  ln_gemm's prologue: the LN is applied in fp32 and rounded to
// bf16 once, the plain version's rounding point, and the GEMM then reads
// bf16 A by TMA.  (Applied inside the GEMM, by each consumer on its stage or
// on wgmma's register-A fragments, it ran slower on an H100 than this pass,
// which moves M x K x (4 or 2, + 2) bytes.)
// ---------------------------------------------------------------------------

constexpr int STATS_THREADS = 256;
constexpr int LN_REG_CHUNKS = 5;  // rows of up to 5 x 8 values a lane stay in registers

// lpr lanes (a power of two <= 32) per row; rows past M only join the
// shuffles.  A row of up to LN_REG_CHUNKS x 8 values a lane is read once
// and kept in registers; a longer one is read three times.
template <typename TA>
__global__ void __launch_bounds__(STATS_THREADS)
ln_rows_kernel(const TA* __restrict__ A, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, bf16* __restrict__ xn, int M, int K, float eps,
               int lpr) {
  const int lane = threadIdx.x & 31, sub = lane & (lpr - 1);
  const int r = (blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5)) * (32 / lpr) + lane / lpr;
  const bool valid = r < M;
  const TA* row = A + static_cast<size_t>(valid ? r : 0) * K;
  auto group_sum = [&](float v) {
    for (int o = lpr / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  bf16* out = xn + static_cast<size_t>(r) * K;
  if (K <= LN_REG_CHUNKS * lpr * 8) {  // the row in registers: one read
    float x[LN_REG_CHUNKS][8], s = 0.f, q = 0.f;
#pragma unroll
    for (int c = 0; c < LN_REG_CHUNKS; ++c) {
      const int k = (c * lpr + sub) * 8;
      if (valid && k < K) {
        load8(row + k, x[c]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += x[c][j];
      }
    }
    const float mean = group_sum(s) / K;
#pragma unroll
    for (int c = 0; c < LN_REG_CHUNKS; ++c)
      if (valid && (c * lpr + sub) * 8 < K) {
#pragma unroll
        for (int j = 0; j < 8; ++j) q += (x[c][j] - mean) * (x[c][j] - mean);
      }
    const float rstd = rsqrtf(group_sum(q) / K + eps);
#pragma unroll
    for (int c = 0; c < LN_REG_CHUNKS; ++c) {
      const int k = (c * lpr + sub) * 8;
      if (valid && k < K) {
        float g[8], b[8];
        load8(ln_s + k, g);
        load8(ln_b + k, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[c][j] = (x[c][j] - mean) * rstd * g[j] + b[j];
        store8(out + k, x[c]);
      }
    }
    return;
  }
  float v[8], s = 0.f;
  for (int k = sub * 8; valid && k < K; k += lpr * 8) {
    load8(row + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  const float mean = group_sum(s) / K;
  float q = 0.f;
  for (int k = sub * 8; valid && k < K; k += lpr * 8) {
    load8(row + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) q += (v[j] - mean) * (v[j] - mean);
  }
  const float rstd = rsqrtf(group_sum(q) / K + eps);
  for (int k = sub * 8; valid && k < K; k += lpr * 8) {
    float g[8], b[8];
    load8(row + k, v);
    load8(ln_s + k, g);
    load8(ln_b + k, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] - mean) * rstd * g[j] + b[j];
    store8(out + k, v);
  }
}

// ---------------------------------------------------------------------------
// GEMM: Y[M,N] = epilogue(A[M,K] @ W[K,N] + bias), A and W bf16, W's rows
// ldw apart
//   epilogue:       act(...), * q_scale on the q columns, * gamma[n] (a
//                   per-column scale, when gamma is non-null), then + R (when
//                   R is non-null) in fp32, stored bf16 or fp32
//   EPI_PRE:        also store the pre-activation acc + bias, as bf16, to Y2
//                   (K17's forward: h_pre for the backward)
//   EPI_DGELU:      Y = acc * quick_gelu'(R) with R the bf16 pre-activation
//                   (K17's backward: dh_pre); no bias, act or residual
// (ln_gemm is ln_rows_kernel, then this GEMM on its bf16 output.)
// Replaces the function of JAX ops/fused_linear.py::ln_matmul (:299) and
// ::matmul_residual (:326) and the GEMMs of ops/block_kernel.py's blocks.
// TMA + wgmma, warp-specialised and persistent.  A block of two consumer
// warpgroups and a producer warp on one SM; the producer's first thread
// keeps a ring of k-steps (64 deep; 5 stages, 4 with a residual) in
// flight, per stage one TMA box of A ([128][64]) and two of W ([64 k][64
// n], N contiguous), all 128B-swizzled.  W is MN-major for wgmma (the
// transpose bit), so weights stay as stored.  The consumers share each 128
// x 128 output tile, 64 rows each: m64n128k16 wgmmas from shared memory
// (both operands by descriptor), one k-step's products in flight while the
// next is issued, and a stage released (an mbarrier arrival per thread)
// once the products that read it are done.  The block walks output tiles
// (blockIdx.x, + gridDim.x, ...) with the ring running across tiles, so the
// next tile's loads overlap this tile's epilogue.  The epilogue stages each
// warp's accumulators (16 rows x 64 columns at a time) through a scratch of
// its own and applies bias, act, q-scale, gamma and residual 8 columns a
// lane, with 16- or 32-byte loads and stores along rows; the tile's bias
// and gamma, and its residual rows (or K17's h_pre; all 128 columns in
// bf16, the first 64 in fp32), come by cp.async into blocks of the warp's
// own at the start of the tile, so they land during the main loop.  Ragged
// M, N and K edges are TMA's zero fill and the epilogue's masks.  Output
// and residual dtypes and the epilogue mode are runtime switches, resolved
// once a chunk, so one instance serves every caller.  At 288 threads ptxas
// allots 168 registers a thread (warps are allocated in fours).  Bound:
// operations at ViT-B/16's shapes; the epilogue, not overlapped with the
// tensor cores, and the ring's waits on L2 keep it from them (PERF.md).
// Tried on an H100 and not kept: 128 x 192 tiles (full waves at N = 768,
// but they spilled and gained nothing); stores of column pairs straight
// from the accumulators (slower than the staged 16-byte rows); ping-pong
// consumers on whole tiles (they spilled at 168 registers); a fourth
// warpgroup running the epilogue (slower with an activation); LN applied
// inside the GEMM (slower than the row pass).
// ---------------------------------------------------------------------------

constexpr int GBM = 128, GBN = 128, GBK = 64, GEMM_THREADS = 288;
constexpr int GEMM_SMEM_MAX = 232448;  // an H100 block's dynamic shared memory
constexpr int A_BYTES = GBM * GBK * 2, B_BOX = GBK * 128;  // B: one [64 k][64 n] box
constexpr int STAGE = A_BYTES + 2 * B_BOX, MAX_STAGES = 6;
constexpr int E_LD = 72;  // fp32 epilogue scratch row (64 + 8: no bank conflicts)
// past the ring, per consumer warp: the scratch [16][E_LD] fp32; the tile's
// bias and gamma, [128] fp32 each; with a residual, its staging block of 16
// rows x 256 bytes (the tile's 128 bf16 columns, or 64 fp32 at a time)
constexpr int E_WARP = 16 * E_LD * 4, BG_WARP = 1024, R_WARP = 16 * 256;
constexpr int E_BYTES = 8 * (E_WARP + BG_WARP), R_BYTES = 8 * R_WARP;

// the ring's depth: as many stages as fit beside the epilogue's blocks (5
// without a residual, 4 with one; a scratch of 8 rows, for a stage more,
// ran 5-20% slower on an H100)
inline int gemm_stages(bool residual) {
  const int fit = (GEMM_SMEM_MAX - 1024 - 2 * MAX_STAGES * 8 - E_BYTES -
                   (residual ? R_BYTES : 0)) / STAGE;
  return fit < MAX_STAGES ? fit : MAX_STAGES;
}
inline int gemm_smem(int stages, bool residual) {
  return 1024 + stages * STAGE + E_BYTES + (residual ? R_BYTES : 0) + 2 * MAX_STAGES * 8;
}
static_assert(E_BYTES % 1024 == 0 && R_BYTES % 1024 == 0, "shared memory layout");

enum Epi { EPI_STD = 0, EPI_PRE = 1, EPI_DGELU = 2 };

// what the GEMM does past the product (see above); r null: no residual
struct GemmEpi {
  const float* bias;   // [N] or null
  const float* gamma;  // [N] or null
  const void* r;       // [M, N] residual (or EPI_DGELU's h_pre), bf16 or fp32
  void* y;             // [M, N] bf16 or fp32
  bf16* y2;            // EPI_PRE's [M, N] pre-activation
  int mode, act, r_f32, y_f32;
  float q_scale;
  int q_cols, group_cols;
};

// d/dh of h * sigmoid(1.702 h) (block_kernel.py:_quick_gelu_grad_f32)
__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = 1.0f / (1.0f + expf(-1.702f * h));
  return s * (1.0f + 1.702f * h * (1.0f - s));
}

// The GEMM epilogue's activations: block_kernel.py::_act_f32's forms with
// the fast exponential, reciprocal and tanh (each within a few fp32 ulp, far
// inside the bf16 rounding that follows); act_f32's exact forms slowed the
// epilogue on an H100.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float act_fast(float h, int act) {
  if (act == ACT_QUICK_GELU) return __fdividef(h, 1.0f + __expf(-1.702f * h));
  if (act == ACT_GELU_TANH) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.0f + tanh_approx(k * (h + 0.044715f * h * h * h)));
  }
  if (act == ACT_GELU_SIG5) {
    const float hc = fminf(fmaxf(h, -7.5f), 7.5f);
    const float u = hc * hc;
    const float f = hc * (1.5953873f + u * (0.07364605f + u * -6.3791875e-4f));
    return __fdividef(h, 1.0f + __expf(-f));
  }
  return h;
}

// residual_fetch starts the copies of a warp's 16 residual rows (or h_pre)
// at rows r0.., 256 bytes a row from column n0 (128 bf16 columns, the whole
// tile, or 64 fp32), into its staging rows rb 256 bytes apart, 16 bytes a
// copy with the lanes along each row; rows past M load zeros.  The
// epilogue waits for them (cp.async.wait and a warp barrier).
__device__ __forceinline__ void residual_fetch(const GemmEpi& e, unsigned char* rb, int lane,
                                               int r0, int n0, int M, int N) {
  if (e.r == nullptr) return;
  const int esz = e.mode != EPI_DGELU && e.r_f32 ? 4 : 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = i * 32 + lane, rr = f >> 4, col = n0 + (f & 15) * (16 / esz);
    if (col >= N) continue;  // N is a multiple of 8: a copy is in or out
    const bool ok = r0 + rr < M;
    cp_async16(rb + rr * 256 + (f & 15) * 16,
               static_cast<const unsigned char*>(e.r) +
                   (static_cast<size_t>(ok ? r0 + rr : 0) * N + col) * esz,
               ok);
  }
}

// The epilogue's lane map over a warp's [16][64] block at rows r0..,
// columns n0..: lane l takes 8 columns (l % 8) * 8 of rows l / 8 + {0, 4,
// 8, 12}.
// the warp's [16][64] block from its scratch es (the accumulators) and
// staging rb (the residual), 8 columns a lane: 16- or 32-byte loads and
// stores along rows.  ACT, the residual's type RT (0 none, 1 bf16, 2 fp32),
// the output's and the mode are compile-time, so the row loop has no
// per-element branch (switched at run time inside it, the epilogue was
// slower on an H100).
template <int ACT, int RT, bool YF32, int MODE>
__device__ __forceinline__ void epilogue_rows(const GemmEpi& e, const float* es,
                                              const unsigned char* rb, int lane, int r0,
                                              int gn, int M, int N, const float* bv,
                                              const float* gv, bool qcol) {
  const bool gamma = e.gamma != nullptr;
  const float q = qcol ? e.q_scale : 1.f;
#pragma unroll 2  // two rows' loads in flight (4 spilled; 1 was slower)
  for (int i = 0; i < 4; ++i) {
    const int rr = i * 4 + (lane >> 3), gr = r0 + rr;
    if (gr >= M) break;
    const size_t off = static_cast<size_t>(gr) * N + gn;
    float x[8], r[8];
    load8(es + rr * E_LD + (lane & 7) * 8, x);
    if constexpr (RT == 1)
      load8(reinterpret_cast<const bf16*>(rb + rr * 256 + (lane & 7) * 16), r);
    if constexpr (RT == 2)
      load8(reinterpret_cast<const float*>(rb + rr * 256 + (lane & 7) * 32), r);
    if constexpr (MODE == EPI_DGELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] *= quick_gelu_grad(r[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = bv[j] + x[j];
      if constexpr (MODE == EPI_PRE) store8(e.y2 + off, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = act_fast(x[j], ACT) * q;
      if (gamma) {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] *= gv[j];
      }
      if constexpr (RT != 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] += r[j];
      }
    }
    if constexpr (YF32) store8(static_cast<float*>(e.y) + off, x);
    else store8(static_cast<bf16*>(e.y) + off, x);
  }
}

template <int ACT, bool YF32>
__device__ __forceinline__ void epilogue_act(const GemmEpi& e, const float* es,
                                             const unsigned char* rb, int lane, int r0, int gn,
                                             int M, int N, const float* bv, const float* gv,
                                             bool qcol) {
  if (e.r == nullptr)
    epilogue_rows<ACT, 0, YF32, EPI_STD>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
  else if (e.r_f32)
    epilogue_rows<ACT, 2, YF32, EPI_STD>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
  else
    epilogue_rows<ACT, 1, YF32, EPI_STD>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
}

template <bool YF32>
__device__ __forceinline__ void epilogue_act_of(const GemmEpi& e, const float* es,
                                                const unsigned char* rb, int lane, int r0,
                                                int gn, int M, int N, const float* bv,
                                                const float* gv, bool qcol) {
  switch (e.act) {
    case ACT_QUICK_GELU:
      epilogue_act<ACT_QUICK_GELU, YF32>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
      break;
    case ACT_GELU_TANH:
      epilogue_act<ACT_GELU_TANH, YF32>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
      break;
    case ACT_GELU_SIG5:
      epilogue_act<ACT_GELU_SIG5, YF32>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
      break;
    default:
      epilogue_act<ACT_NONE, YF32>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
  }
}

// (bg: the chunk's bias, its gamma GBN floats on)
__device__ __forceinline__ void epilogue_chunk(const GemmEpi& e, const float* es,
                                               const float* bg, const unsigned char* rb,
                                               int lane, int r0, int n0, int M, int N) {
  cp_async_wait<0>();  // this lane's residual rows have landed
  __syncwarp();        // and the warp's copies of the tile's bias and gamma
  const int gn = n0 + (lane & 7) * 8;
  if (gn >= N) return;  // N is a multiple of 8: 8 columns are in or out
  float bv[8], gv[8];
  if (e.mode != EPI_DGELU && e.bias) {
    load8(bg + (lane & 7) * 8, bv);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) bv[i] = 0.f;
  }
  if (e.gamma) load8(bg + GBN + (lane & 7) * 8, gv);
  const bool qcol = e.q_cols > 0 && gn % e.group_cols < e.q_cols;
  if (e.mode == EPI_DGELU) {
    epilogue_rows<ACT_NONE, 1, false, EPI_DGELU>(e, es, rb, lane, r0, gn, M, N, bv, gv,
                                                 qcol);
  } else if (e.mode == EPI_PRE) {
    epilogue_rows<ACT_QUICK_GELU, 0, false, EPI_PRE>(e, es, rb, lane, r0, gn, M, N, bv, gv,
                                                     qcol);
  } else if (e.y_f32) {
    epilogue_act_of<true>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
  } else {
    epilogue_act_of<false>(e, es, rb, lane, r0, gn, M, N, bv, gv, qcol);
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
            const GemmEpi e, int M, int N, int K, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* past_ring = smem + stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(past_ring + E_BYTES + (e.r ? R_BYTES : 0));
  uint64_t* empty = full + MAX_STAGES;

  const int tiles_n = (N + GBN - 1) / GBN;
  const int n_tiles = ((M + GBM - 1) / GBM) * tiles_n;
  const int nk = (K + GBK - 1) / GBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread reads every stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  if (wg == 2) {  // the producer warp
    if (t != 0) return;
    int s = 0, phase = 0;  // the ring position and the parity of its pass
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * GBM, n0 = (tile % tiles_n) * GBN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* a = smem + s * STAGE;
        tma_load_2d(a, &map_a, &full[s], kt * GBK, m0);
        tma_load_2d(a + A_BYTES, &map_w, &full[s], n0, kt * GBK);
        tma_load_2d(a + A_BYTES + B_BOX, &map_w, &full[s], n0 + 64, kt * GBK);
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumer wg: rows wg * 64 .. + 64 of each tile
  const int warp = t >> 5, lane = t & 31, c2 = (lane & 3) * 2, w8 = threadIdx.x >> 5;
  float* es = reinterpret_cast<float*>(past_ring + w8 * E_WARP);
  float* bg = reinterpret_cast<float*>(past_ring + 8 * E_WARP + w8 * BG_WARP);
  unsigned char* rb = past_ring + E_BYTES + w8 * R_WARP;  // with a residual only
  float acc[GBN / 2];
#pragma unroll
  for (int i = 0; i < GBN / 2; ++i) acc[i] = 0.f;
  int s = 0, phase = 0, prev = 0;  // the ring position, its pass's parity, the last one
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * GBM, n0 = (tile % tiles_n) * GBN;
    const int r0 = m0 + wg * 64 + warp * 16;  // the warp's 16 rows
    __syncwarp();  // the warp's lanes are done reading the last tile's bias and gamma
    residual_fetch(e, rb, lane, r0, n0, M, N);  // lands during the main loop
    {  // the tile's bias and gamma, 16 bytes a lane (columns past N: zeros)
      const bool in = n0 + lane * 4 < N;
      if (e.bias && e.mode != EPI_DGELU)
        cp_async16(bg + lane * 4, in ? e.bias + n0 + lane * 4 : e.bias, in);
      if (e.gamma) cp_async16(bg + GBN + lane * 4, in ? e.gamma + n0 + lane * 4 : e.gamma, in);
    }
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[s], phase);
      const unsigned char* a = smem + s * STAGE + wg * 64 * 128;
      const unsigned char* b = smem + s * STAGE + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<GBN, 1>(acc, smem_desc(a + kk * 32, 16, 1024, SW_128B),
                         smem_desc(b + kk * 2048, B_BOX, 1024, SW_128B), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products are done
      if (kt > 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // epilogue, 64 columns at a time: the warp's [16][64] block of the
    // accumulators (rows lane/4 + {0, 8}, columns 8 jj + c2 + {0, 1}) into
    // its scratch, then out along rows
#pragma unroll
    for (int c = 0; c < GBN / 64; ++c) {
      __syncwarp();  // the warp's lanes are done reading the scratch
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(es + ((lane >> 2) + 8 * hh) * E_LD + jj * 8 + c2) =
              make_float2(acc[(8 * c + jj) * 4 + 2 * hh], acc[(8 * c + jj) * 4 + 2 * hh + 1]);
      __syncwarp();
      const bool f32r = e.mode != EPI_DGELU && e.r_f32;  // staged 64 columns at a time
      epilogue_chunk(e, es, bg + c * 64, f32r ? rb : rb + c * 128, lane, r0, n0 + c * 64, M, N);
      if (f32r && c + 1 < GBN / 64) {  // the next 64 fp32 columns of the residual
        __syncwarp();                    // once every lane has read this chunk's
        residual_fetch(e, rb, lane, r0, n0 + (c + 1) * 64, M, N);
        cp_async_commit();
      }
    }
  }
}

// A bf16 [M, K] row-major, W bf16 [K, N] with rows ldw apart
int launch_gemm(const void* a, const void* w, int M, int N, int K, int ldw, const GemmEpi& e,
                cudaStream_t stream) {
  if (M < 1 || N < 8 || K < 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_w;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t a_stride[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t a_box[2] = {GBK, GBM};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t w_stride[1] = {static_cast<uint64_t>(ldw) * 2};
  const uint32_t w_box[2] = {64, GBK};
  int err = make_tensor_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, a_dims, a_stride,
                            a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_stride,
                          w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int stages = gemm_stages(e.r != nullptr), smem = gemm_smem(stages, e.r != nullptr);
  // the kernel's shared-memory limit, raised once a device to the most any
  // launch takes (set at every launch, its host time showed beside the
  // shortest GEMMs)
  static bool raised[64] = {};
  int device = 0;
  cudaError_t ce = cudaGetDevice(&device);
  if (ce == cudaSuccess && (device >= 64 || !raised[device])) {
    const int most = gemm_smem(gemm_stages(true), true) > gemm_smem(gemm_stages(false), false)
                         ? gemm_smem(gemm_stages(true), true)
                         : gemm_smem(gemm_stages(false), false);
    ce = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (ce == cudaSuccess && device < 64) raised[device] = true;
  }
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int tiles = ((M + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_kernel<<<grid, GEMM_THREADS, smem, stream>>>(map_a, map_w, e, M, N, K, stages);
  return static_cast<int>(cudaGetLastError());
}

inline GemmEpi gemm_epi(const float* bias, const float* gamma, const void* r, int r_f32,
                        void* y, int y_f32, int mode = EPI_STD, int act = ACT_NONE,
                        float q_scale = 1.f, int q_cols = 0, int group_cols = 1,
                        void* y2 = nullptr) {
  return GemmEpi{bias, gamma, r, y, static_cast<bf16*>(y2), mode, act, r_f32, y_f32,
                 q_scale, q_cols, group_cols};
}

// LN(x) into the bf16 scratch xn [M, K], then the GEMM on it
int launch_ln_gemm(const void* x, int x_f32, void* xn, const float* ln_s, const float* ln_b,
                   const void* w, int M, int N, int K, int ldw, float eps, const GemmEpi& e,
                   cudaStream_t stream) {
  int lpr = 32;  // lanes per row: all of a warp's 8-column slices busy
  while (lpr > 1 && lpr * 8 > K) lpr /= 2;
  const int rows_per_block = STATS_THREADS / 32 * (32 / lpr);
  const int blocks = (M + rows_per_block - 1) / rows_per_block;
  bf16* out = static_cast<bf16*>(xn);
  if (x_f32)
    ln_rows_kernel<float><<<blocks, STATS_THREADS, 0, stream>>>(static_cast<const float*>(x),
                                                                ln_s, ln_b, out, M, K, eps, lpr);
  else
    ln_rows_kernel<bf16><<<blocks, STATS_THREADS, 0, stream>>>(static_cast<const bf16*>(x),
                                                               ln_s, ln_b, out, M, K, eps, lpr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm(xn, w, M, N, K, ldw, e, stream);
}

// ---------------------------------------------------------------------------
// LN backward of K17 (block_kernel.py:200-210), one warp per row of x [M, K]:
//   xhat = (x - mean) * rstd (two-pass fp32 statistics, eps), dxhat = dln * g,
//   dx = dy + (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd,
// stored bf16, and dln (the fp32 output of the dh_pre @ W_fc^T GEMM) stored
// again in bf16 for the LN-parameter gradients, as the TPU kernel emits it.
// The row sums need the whole row, which a 128-column GEMM tile does not
// hold.  Bytes-bound: four reads of a row (L1-resident after the first).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(STATS_THREADS)
ln_bwd_kernel(const bf16* __restrict__ X, const bf16* __restrict__ DY,
              const float* __restrict__ DLN, const float* __restrict__ gamma,
              bf16* __restrict__ DX, bf16* __restrict__ DLN16, int M, int K, float eps) {
  const int r = blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const size_t off = static_cast<size_t>(r) * K;
  float v[8], d[8], g[8], s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    load8(X + off + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    load8(X + off + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) q += (v[j] - mean) * (v[j] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / K + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    load8(X + off + k, v);
    load8(DLN + off + k, d);
    load8(gamma + k, g);
    store8(DLN16 + off + k, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float dxh = d[j] * g[j];
      s1 += dxh;
      s2 += dxh * ((v[j] - mean) * rstd);
    }
  }
  const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
  for (int k = lane * 8; k < K; k += 256) {
    float dy[8], o[8];
    load8(X + off + k, v);
    load8(DLN + off + k, d);
    load8(gamma + k, g);
    load8(DY + off + k, dy);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = dy[j] + (d[j] * g[j] - m1 - ((v[j] - mean) * rstd) * m2) * rstd;
    store8(DX + off + k, o);
  }
}

// ---------------------------------------------------------------------------
// act_pass: y[i] = act(t[i]) [+ r[i]] over the fp32 output t of a GEMM run
// without its activation, for the gelu_poly forms the GEMM epilogues leave
// out (act 4-6, common.cuh).  The sum is the fused epilogue's, act(acc + b)
// then + r, so the result is the same.  Bytes-bound, one value a thread.
// ---------------------------------------------------------------------------

template <typename TR, typename TO>
__global__ void act_pass_kernel(const float* __restrict__ t, int act, const TR* __restrict__ r,
                                TO* __restrict__ y, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float v = gelu_other_f32(t[i], act);
    if (r != nullptr) v = __fadd_rn(v, to_f32(r[i]));
    store1(y + i, v);
  }
}

template <typename TR, typename TO>
int launch_act_pass(const float* t, int act, const void* r, void* y, int n,
                    cudaStream_t stream) {
  const int blocks = (n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536;
  act_pass_kernel<TR, TO><<<blocks, 256, 0, stream>>>(t, act, static_cast<const TR*>(r),
                                                      static_cast<TO*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Flash attention (K6f, the attention of K1, K2 and K5, K13's fp32-output
// grouped one, and with NORM_P K12's and K14's): out[b, q, h*D:(h+1)*D] =
// softmax(scale * q k^T, keys < seq_len) v, one pass over the keys with an
// fp32 online softmax (two with NORM_P, below).  One block
// of one warpgroup per (64-query tile, head, image).  Thread 0 brings the Q
// tile once and the K and V tiles (64 keys) by TMA into a two-stage mbarrier
// ring, the next tile loading while this one computes.  Q, K and V are
// addressed by 5-D tensor maps {d, head in group, group, row, image}, so a
// tile that runs past an image's S rows (or past D) loads zeros instead of
// the next image's rows.  S = Q K^T is a wgmma from shared memory (K-major,
// no transpose: a [keys][D] tile is B's K-major layout); the softmax runs on
// the accumulator registers (a row's 64 scores sit in the 4 threads of a
// quad: 16 each, reduced with two shuffles); P is rounded to bf16 in
// registers and is the register-A operand of O += P V, with V's [keys][D]
// tile MN-major (the transpose bit), so neither the scores nor P V touch
// shared memory.  D = 64 (CLIP ViT-B/L/H) is one 128B-swizzled box per
// tile.  D = 72 (SigLIP), 88 (ViT-g) and 104 (ViT-bigG), whose 144-, 176-
// and 208-byte rows fit no swizzle mode, are a 64-column 128B-swizzled box
// plus one tail box at column 64, TW = 16, 32 or 64 columns wide at the
// swizzle of its row bytes (32B, 64B, 128B), whose columns past D are TMA's
// zero fill: Q K^T contracts 64 columns and then the tail's k16 steps up to
// D rounded to 16 (80, 96, 112), and P V writes an n64 and an nTW product,
// of which the columns past D are dropped.  One tail box, not a 32 + 16
// pair at D = 104, keeps one code path; it costs D = 104 24 zero columns
// of P V (128 against 104) and none of Q K^T.
// Numerics: fp32 scores times scale, keys >= seq_len at -1e30, the row max
// and sum online in fp32 over unrounded P, P cast to bf16 before P V, 1/l on
// the output rows, stored as TO: bf16, or fp32 for K13, whose grouped
// requantize reads the P V product unrounded (its TPU kernel's one-pass
// form, quant_matmul.py:586).  With lse non-null each valid row also stores
// its fp32 log-sum-exp m + log(l) of the scaled scores at lse[(b * heads +
// h) * S + q], which the backward kernels (fused_attention_bwd.cu) rebuild P
// from.  Bound: bytes at SigLIP shapes (q, k, v and out cross device memory
// once; K and V re-read from L2 per query tile).
// NORM_P (fp32 output, no lse): K12's and K14's TPU kernels cast P to bf16
// normalised, P = exp(s - m) / l with the row's final max m and sum l
// (quant_matmul.py:750-757), and the int8 requantize that reads this output
// turns a difference in P's rounding into code flips, which K14's later
// requantizes multiply (at ViT-B/16: 6.8e-3 rel L2 against its plain version
// with the 1/l on the output rows, 2.0e-3 normalised).  A one-pass kernel has
// no final m and l before its casts, so the ring runs over the keys twice,
// as K6b rebuilds P from the log-sum-exp: sweep 1 loads K alone and keeps
// only the running (m, l) of Q K^T; sweep 2 loads K and V, recomputes the
// scores, forms P = exp(s - m) / l in registers (the division by div_rn,
// common.cuh), casts it to bf16 and sums P V on wgmma with no rescale and
// no 1/l on the rows.  K crosses L2 twice.
// ---------------------------------------------------------------------------

constexpr int FQ = 64, FKV = 64, FLASH_THREADS = 128;

template <int HD>
struct FlashCfg {
  static_assert(HD == 64 || HD == 72 || HD == 88 || HD == 104, "the head dims built");
  // the tail box past column 64: its width, its k16 steps of Q K^T, its
  // swizzle and the stride of its 8-row core groups
  static constexpr int TW = HD <= 64 ? 0 : HD <= 80 ? 16 : HD <= 96 ? 32 : 64;
  static constexpr bool TAIL = TW > 0;
  static constexpr int TK = (HD - 64 + 15) / 16;
  static constexpr int TSW = TW == 64 ? SW_128B : TW == 32 ? SW_64B : SW_32B;
  static constexpr int T_SBO = 8 * TW * 2;
  static constexpr int OT = TAIL ? TW / 2 : 8;  // tail accumulators a thread
  static constexpr int MAIN = FQ * 128, TAIL_BYTES = FQ * TW * 2;  // per tile
  // main boxes 1024-aligned first: Q, K0, V0, K1, V1; then their tails
  static constexpr int Q_MAIN = 0, KV_MAIN = MAIN;  // K stage s at KV_MAIN + 2s MAIN, V + MAIN
  static constexpr int TAILS = 5 * MAIN;
  static constexpr int Q_TAIL = TAILS, KV_TAIL = TAILS + TAIL_BYTES;
  static constexpr int BARS = TAILS + 5 * TAIL_BYTES;
  static constexpr int SMEM = 1024 + BARS + 3 * 8;
  static constexpr unsigned Q_TX = MAIN + TAIL_BYTES, KV_TX = 2 * (MAIN + TAIL_BYTES);
};

template <int HD, typename TO, bool NORM_P>
__global__ void __launch_bounds__(FLASH_THREADS, 3)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_qt,
                       const __grid_constant__ CUtensorMap map_kt,
                       const __grid_constant__ CUtensorMap map_vt, TO* __restrict__ out,
                       float* __restrict__ lse, int S, int seq_len, int heads,
                       int group_heads, float scale) {
  using C = FlashCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* full = qbar + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int hg = h % group_heads, grp = h / group_heads;
  const int n_tiles = (seq_len + FKV - 1) / FKV;
  // the ring's loads: the key tiles once, or with NORM_P twice (K alone,
  // then K and V)
  const int n_loads = NORM_P ? 2 * n_tiles : n_tiles;

  auto k_main = [&](int s) { return smem + C::KV_MAIN + 2 * s * C::MAIN; };
  auto v_main = [&](int s) { return smem + C::KV_MAIN + (2 * s + 1) * C::MAIN; };
  auto k_tail = [&](int s) { return smem + C::KV_TAIL + 2 * s * C::TAIL_BYTES; };
  auto v_tail = [&](int s) { return smem + C::KV_TAIL + (2 * s + 1) * C::TAIL_BYTES; };
  auto load_kv = [&](int t) {
    const int s = t & 1;
    if constexpr (NORM_P) {
      if (t < n_tiles) {  // sweep 1: K alone
        mbar_expect_tx(&full[s], C::KV_TX / 2);
        tma_load_5d(k_main(s), &map_k, &full[s], 0, hg, grp, t * FKV, b);
        if constexpr (C::TAIL) tma_load_5d(k_tail(s), &map_kt, &full[s], 64, hg, grp, t * FKV, b);
        return;
      }
      t -= n_tiles;
    }
    mbar_expect_tx(&full[s], C::KV_TX);
    tma_load_5d(k_main(s), &map_k, &full[s], 0, hg, grp, t * FKV, b);
    tma_load_5d(v_main(s), &map_v, &full[s], 0, hg, grp, t * FKV, b);
    if constexpr (C::TAIL) {
      tma_load_5d(k_tail(s), &map_kt, &full[s], 64, hg, grp, t * FKV, b);
      tma_load_5d(v_tail(s), &map_vt, &full[s], 64, hg, grp, t * FKV, b);
    }
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, C::Q_TX);
    tma_load_5d(smem + C::Q_MAIN, &map_q, qbar, 0, hg, grp, q0, b);
    if constexpr (C::TAIL) tma_load_5d(smem + C::Q_TAIL, &map_qt, qbar, 64, hg, grp, q0, b);
    load_kv(0);
    if (n_loads > 1) load_kv(1);
  }
  __syncthreads();

  const int c2 = (lane & 3) * 2;
  float o[32], ot[C::OT];  // P V columns 0-63 and (D > 64) 64 .. 64 + TW - 1
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::OT; ++i) ot[i] = 0.f;
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  if constexpr (NORM_P) {  // sweep 1: the row max and sum of the scores
    // (Q K^T and the mask as in the main loop below, whose code, and SASS,
    // the flag-off instances keep as it was)
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t & 1;
      mbar_wait(&full[s], (t >> 1) & 1);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 0>(sc, smem_desc(smem + C::Q_MAIN + kk * 32, 16, 1024, SW_128B),
                        smem_desc(k_main(s) + kk * 32, 16, 1024, SW_128B), kk > 0);
      if constexpr (C::TAIL) {
#pragma unroll
        for (int kk = 0; kk < C::TK; ++kk)
          wgmma_ss<64, 0>(sc, smem_desc(smem + C::Q_TAIL + kk * 32, 16, C::T_SBO, C::TSW),
                          smem_desc(k_tail(s) + kk * 32, 16, C::T_SBO, C::TSW), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = -1e30f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[j * 4 + h2 * 2 + e];
            v = (t * FKV + j * 8 + c2 + e < seq_len) ? v * scale : -1e30f;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h2], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += expf(sc[j * 4 + h2 * 2 + e] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[h2] = l_run[h2] * expf(m_run[h2] - m_new) + sum;
        m_run[h2] = m_new;
      }
      __syncthreads();  // every warp is done with stage s
      if (tid == 0 && t + 2 < n_loads) load_kv(t + 2);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int it = NORM_P ? n_tiles + t : t;  // the ring's load index
    const int s = it & 1;
    mbar_wait(&full[s], (it >> 1) & 1);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64, 0>(sc, smem_desc(smem + C::Q_MAIN + kk * 32, 16, 1024, SW_128B),
                      smem_desc(k_main(s) + kk * 32, 16, 1024, SW_128B), kk > 0);
    if constexpr (C::TAIL) {
#pragma unroll
      for (int kk = 0; kk < C::TK; ++kk)
        wgmma_ss<64, 0>(sc, smem_desc(smem + C::Q_TAIL + kk * 32, 16, C::T_SBO, C::TSW),
                        smem_desc(k_tail(s) + kk * 32, 16, C::T_SBO, C::TSW), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax over this thread's rows (h2 = 0: registers 4j, 4j+1;
    // h2 = 1: 4j+2, 4j+3) and keys t*64 + 8j + c2 + {0, 1}
    if constexpr (NORM_P) {  // P = exp(s - m) / l at the row's final m, l
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[j * 4 + h2 * 2 + e];
            v = (t * FKV + j * 8 + c2 + e < seq_len) ? v * scale : -1e30f;
            v = div_rn(expf(v - m_run[h2]), l_run[h2]);
          }
    } else {
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = -1e30f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[j * 4 + h2 * 2 + e];
            v = (t * FKV + j * 8 + c2 + e < seq_len) ? v * scale : -1e30f;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h2], mx);
        alpha[h2] = expf(m_run[h2] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[j * 4 + h2 * 2 + e];
            v = expf(v - m_new);
            sum += v;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[h2] = l_run[h2] * alpha[h2] + sum;
        m_run[h2] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j * 4] *= alpha[0];
        o[j * 4 + 1] *= alpha[0];
        o[j * 4 + 2] *= alpha[1];
        o[j * 4 + 3] *= alpha[1];
      }
      if constexpr (C::TAIL) {
#pragma unroll
        for (int j = 0; j < C::TW / 8; ++j) {
          ot[j * 4] *= alpha[0];
          ot[j * 4 + 1] *= alpha[0];
          ot[j * 4 + 2] *= alpha[1];
          ot[j * 4 + 3] *= alpha[1];
        }
      }
    }
    // P in bf16 as register-A fragments: keys 16kk .. 16kk + 15
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<64, 1>(o, pf[kk], smem_desc(v_main(s) + kk * 2048, C::MAIN, 1024, SW_128B), 1);
      if constexpr (C::TAIL)
        wgmma_rs<C::TW, 1>(ot, pf[kk],
                           smem_desc(v_tail(s) + kk * 32 * C::TW, C::TAIL_BYTES, C::T_SBO, C::TSW),
                           1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ot);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && it + 2 < n_loads) load_kv(it + 2);
  }

  const int W = heads * HD;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int q = q0 + warp * 16 + (lane >> 2) + 8 * h2;
    if (q >= S) continue;
    const float inv = NORM_P ? 1.f : 1.f / l_run[h2];  // NORM_P: P summed to 1
    TO* dst = out + (static_cast<size_t>(b) * S + q) * W + h * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store2(dst + j * 8 + c2, o[j * 4 + h2 * 2] * inv, o[j * 4 + h2 * 2 + 1] * inv);
    if constexpr (C::TAIL)  // columns 64 .. D - 1; the rest of the tail is padding
#pragma unroll
      for (int j = 0; j < (HD - 64) / 8; ++j)
        store2(dst + 64 + j * 8 + c2, ot[j * 4 + h2 * 2] * inv, ot[j * 4 + h2 * 2 + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<size_t>(b) * heads + h) * S + q] = m_run[h2] + logf(l_run[h2]);
  }
}

template <int HD, typename TO, bool NORM_P>
int launch_flash(const bf16* q, const bf16* k, const bf16* v, TO* out, float* lse, int B,
                 int S, int seq_len, int heads, int group_heads, int ld, int group_stride,
                 float scale, cudaStream_t stream) {
  using C = FlashCfg<HD>;
  const int groups = heads / group_heads;
  CUtensorMap maps[6];  // q, k, v, then their tails (D > 64; unread at D = 64)
  const bf16* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    int err = head_map(&maps[i], bases[i], HD, group_heads, groups, S, B, ld, group_stride, 64,
                       FQ);
    if (err == 0 && C::TAIL)
      err = head_map(&maps[3 + i], bases[i], HD, group_heads, groups, S, B, ld, group_stride,
                     C::TW, FQ);
    if (err != 0) return err;
    if (!C::TAIL) maps[3 + i] = maps[i];
  }
  auto kernel = flash_attention_kernel<HD, TO, NORM_P>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + FQ - 1) / FQ, heads, B);
  kernel<<<grid, FLASH_THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                   maps[5], out, lse, S, seq_len, heads,
                                                   group_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, D>()) for D = head_dim, one of the head
// widths the attention kernels are built for (ops/block_kernel.HEAD_DIMS)
template <typename F>
int with_head_dim(int head_dim, F f) {
  switch (head_dim) {
    case 64: return f(std::integral_constant<int, 64>());
    case 72: return f(std::integral_constant<int, 72>());
    case 88: return f(std::integral_constant<int, 88>());
    case 104: return f(std::integral_constant<int, 104>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out bf16, or fp32 with out_f32 (then lse must be null); norm_p (fp32
// only) normalises P before its cast
int flash_dispatch(const bf16* q, const bf16* k, const bf16* v, void* out, int out_f32,
                   int norm_p, float* lse, int B, int S, int seq_len, int heads,
                   int group_heads, int head_dim, int ld, int group_stride, float scale,
                   cudaStream_t stream) {
  if (seq_len < 1 || seq_len > S || group_heads < 1 || heads % group_heads ||
      (out_f32 && lse != nullptr) || (norm_p && !out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    float* out32 = static_cast<float*>(out);
    if (norm_p)
      return launch_flash<HD, float, true>(q, k, v, out32, lse, B, S, seq_len, heads,
                                           group_heads, ld, group_stride, scale, stream);
    return out_f32 ? launch_flash<HD, float, false>(q, k, v, out32, lse, B, S, seq_len, heads,
                                                    group_heads, ld, group_stride, scale, stream)
                   : launch_flash<HD, bf16, false>(q, k, v, static_cast<bf16*>(out), lse, B, S,
                                                   seq_len, heads, group_heads, ld,
                                                   group_stride, scale, stream);
  });
}

}  // namespace

extern "C" {

// y[M,N] (bf16, or fp32 with y_is_f32) = act(LN(x)[M,K] @ w[K,N] + bias),
// times q_scale on the columns n with n % group_cols < q_cols; x is bf16 or
// fp32; w's rows are ldw apart; xn is an [M,K] bf16 scratch for LN(x).
int aihab_ln_gemm(const void* x, int x_is_f32, const float* ln_s, const float* ln_b,
                  const void* w, int ldw, const float* bias, void* y, int y_is_f32, void* xn,
                  int M, int N, int K, int act, float eps, float q_scale, int q_cols,
                  int group_cols, void* stream) {
  if (act > ACT_GELU_SIG5) return static_cast<int>(cudaErrorInvalidValue);  // act_pass's
  return launch_ln_gemm(x, x_is_f32, xn, ln_s, ln_b, w, M, N, K, ldw, eps,
                        gemm_epi(bias, nullptr, nullptr, 0, y, y_is_f32, EPI_STD, act, q_scale,
                                 q_cols, group_cols),
                        static_cast<cudaStream_t>(stream));
}

// y[i] = act(t[i]) [+ r[i]] over n fp32 values t, act one of the gelu_poly
// forms 4-6 (common.cuh); r (may be null) and y bf16 or fp32.
int aihab_act_pass(const float* t, int act, const void* r, int r_is_f32, void* y,
                   int y_is_f32, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < ACT_GELU_SIG9 || act > ACT_GELU_CHEB)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r_is_f32 && y_is_f32) return launch_act_pass<float, float>(t, act, r, y, n, s);
  if (r_is_f32) return launch_act_pass<float, bf16>(t, act, r, y, n, s);
  if (y_is_f32) return launch_act_pass<bf16, float>(t, act, r, y, n, s);
  return launch_act_pass<bf16, bf16>(t, act, r, y, n, s);
}

// y[M,N] = (a[M,K] @ w[K,N] + bias) * gamma + r[M,N]; a, w bf16 (w's rows
// ldw apart); bias may be null (no bias), gamma [N] may be null (no scale);
// r and y bf16 or fp32.
int aihab_gemm_residual(const void* a, const void* w, int ldw, const float* bias,
                        const float* gamma, const void* r, int r_is_f32, void* y,
                        int y_is_f32, int M, int N, int K, void* stream) {
  return launch_gemm(a, w, M, N, K, ldw, gemm_epi(bias, gamma, r, r_is_f32, y, y_is_f32),
                     static_cast<cudaStream_t>(stream));
}

// K17's forward: h_pre = LN(x) @ w_fc + b_fc (bf16), h = quick_gelu of the
// same fp32 value (bf16), y = h @ w_proj + b_proj + x (bf16); x [M,W] bf16,
// w_fc [W,H] and w_proj [H,W] bf16 row-major, LN eps 1e-5 (the TPU kernel's);
// h [M,H] and xn [M,W] (LN(x), bf16) are scratch.
int aihab_mlp_train_fwd(const void* x, const float* ln_s, const float* ln_b, const void* w_fc,
                        const float* b_fc, const void* w_proj, const float* b_proj, void* y,
                        void* h_pre, void* h, void* xn, int M, int W, int H, float eps,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_ln_gemm(
      x, 0, xn, ln_s, ln_b, w_fc, M, H, W, H, eps,
      gemm_epi(b_fc, nullptr, nullptr, 0, h, 0, EPI_PRE, ACT_QUICK_GELU, 1.f, 0, 1, h_pre), s);
  if (err != 0) return err;
  return launch_gemm(h, w_proj, M, W, H, W, gemm_epi(b_proj, nullptr, x, 0, y, 0), s);
}

// K17's backward dx chain: dh_pre = (dy @ w_proj_t) * quick_gelu'(h_pre),
// dln = dh_pre @ w_fc_t (fp32 scratch [M,W]), dx = dy + LN_bwd(dln; x, ln_s)
// and dln16 = dln in bf16.  w_proj_t [W,H] and w_fc_t [H,W] row-major bf16
// (torch's c_proj.weight and c_fc.weight); x, dy [M,W], h_pre [M,H] bf16.
int aihab_mlp_train_bwd(const void* x, const void* h_pre, const void* dy, const float* ln_s,
                        const void* w_fc_t, const void* w_proj_t, void* dx, void* dh_pre,
                        void* dln, void* dln16, int M, int W, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_gemm(dy, w_proj_t, M, H, W, H,
                        gemm_epi(nullptr, nullptr, h_pre, 0, dh_pre, 0, EPI_DGELU), s);
  if (err != 0) return err;
  err = launch_gemm(dh_pre, w_fc_t, M, W, H, W, gemm_epi(nullptr, nullptr, nullptr, 0, dln, 1),
                    s);
  if (err != 0) return err;
  const int rows_per_block = STATS_THREADS / 32;
  ln_bwd_kernel<<<(M + rows_per_block - 1) / rows_per_block, STATS_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const float*>(dln),
      ln_s, static_cast<bf16*>(dx), static_cast<bf16*>(dln16), M, W, eps);
  return static_cast<int>(cudaGetLastError());
}

// out[B,S,heads*D] (bf16, or fp32 with out_f32) = masked multi-head attention
// over qkv[B,S,3*heads*D] in the grouped layout (group_heads heads per group);
// D is 64, 72, 88 or 104.  The fp32 output is the int8 blocks' (K12, K13, K14), whose
// requantize reads the PV product unrounded, as the TPU kernels do; norm_p
// (fp32 only; K12, K14) normalises P before its bf16 cast, as they do (the
// flash kernel's NORM_P instance).
int aihab_attention(const void* qkv, void* out, int B, int S, int seq_len, int heads,
                    int group_heads, int head_dim, float scale, int out_f32, int norm_p,
                    void* stream) {
  const bf16* base = static_cast<const bf16*>(qkv);
  const int gw = group_heads * head_dim, ld = 3 * heads * head_dim;
  return flash_dispatch(base, base + gw, base + 2 * gw, out, out_f32, norm_p, nullptr, B, S,
                        seq_len, heads, group_heads, head_dim, ld, 3 * gw, scale,
                        static_cast<cudaStream_t>(stream));
}

// fused_attention's forward (K6): out = softmax(scale * q k^T) v over
// separate q, k, v [B,S,heads*D] bf16 (heads packed in the last dim), and the
// fp32 row log-sum-exp lse[B,heads,S] when lse is non-null; D is 64, 72,
// 88 or 104 (ops/attention.py takes 64 and 72, the dims its backward has).
int aihab_fused_attention_fwd(const void* q, const void* k, const void* v, void* out,
                              void* lse, int B, int S, int heads, int head_dim, float scale,
                              void* stream) {
  return flash_dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), out, 0, 0, static_cast<float*>(lse), B, S, S,
                        heads, heads, head_dim, heads * head_dim, 0, scale,
                        static_cast<cudaStream_t>(stream));
}

// The launch plans of the kernels, for reports.  GEMM [M, N] (with or
// without a residual): out = {ring stages, shared bytes a block, output
// tiles, blocks, registers a thread, local (spill) bytes a thread}.
// Attention at (B, S, heads, head_dim), kind 0 the flash kernel with bf16
// output, 1 with fp32 output, 2 its normalised-P instance: out = {K/V stages,
// shared bytes a block, blocks (query tiles x heads x images), the same,
// registers, local bytes}.
int aihab_gemm_plan(int M, int N, int residual, int* out) {
  const int stages = gemm_stages(residual != 0);
  const int tiles = ((M + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gemm_kernel);
  out[0] = stages;
  out[1] = gemm_smem(stages, residual != 0);
  out[2] = tiles;
  out[3] = tiles < sm_count() ? tiles : sm_count();
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

int aihab_flash_plan(int B, int S, int heads, int head_dim, int kind, int* out) {
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(
        &attr, kind == 0   ? (const void*)flash_attention_kernel<HD, bf16, false>
               : kind == 1 ? (const void*)flash_attention_kernel<HD, float, false>
                           : (const void*)flash_attention_kernel<HD, float, true>);
    out[0] = 2;
    out[1] = FlashCfg<HD>::SMEM;
    out[2] = out[3] = ((S + FQ - 1) / FQ) * heads * B;
    out[4] = attr.numRegs;
    out[5] = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(err);
  });
}

}  // extern "C"
