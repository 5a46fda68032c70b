// Hopper (sm_90a) int8 (W8A8 dynamic) kernels: the int8 serving towers of
// SigLIP and CLIP ViT and the int8 frozen prefixes of their PEFT steps.
//
// They replace the Pallas TPU kernels of aihab_clip_tpu/ops/quant_matmul.py:
//   quant_matmul_fused      (K8,  :376, pallas_call :415) = row_quant [+ LN] ->
//       int8_gemm (dequant + bias -> act [+ residual], stored in x's dtype);
//   quant_matmul_fused_qout (K9,  :130, :141) = row_quant + LN -> int8_gemm
//       (dequant + bias -> act, requantized in the same launch: int8 codes +
//       scales, QOUT below);
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
//       y1 stored in fp32 -> row_quant + LN2 -> int8_gemm (act, h requantized
//       per mlp_chunks slice, QOUT) -> int8_gemm in the residual-first mode,
//       out = (y1 + b2) + part_0 + part_1 ... (:779-790);
//   quant_convnext_mlp_block (K15, :319, :341) = K11's chain with ConvNeXt's
//       quirks: row_quant + LN (eps 1e-6) of the dwconv output y -> int8_gemm
//       (gelu_poly, the whole hidden row requantized, QOUT) -> int8_gemm
//       with the gamma epilogue, out = res + (part + b2) * gamma (:314-316),
//       the residual being the block input, not y.
// The Pallas programs keep a whole weight matrix (SO400M's c_fc: 5 MB int8)
// resident in VMEM and quantize, multiply and requantize one row tile in one
// program.  An SM has 227 KB, so the chain is cut at its GEMMs: a row's codes
// cross device memory once, in int8; K9's fp32 y stays on the SM (QOUT).
//
// Bound (H100 SXM: 1,979 TOPS int8 dense, 3.35 TB/s).  At SO400M, batch 64
// (M = 36,864 rows, W = 1152, hidden 4304): K9 and K10 are 365.6 GOP each
// (0.185 ms at the int8 rate) and compute-bound; K13 is 391.4 GOP of int8 GEMM
// plus 97.8 GFLOP of bf16 attention (0.297 ms); K8, the patchify (K = 768),
// moves 142 MB (0.042 ms, bytes-bound).  The design is Hopper's: one
// persistent TMA + wgmma GEMM (int8_gemm_kernel below: a producer warp
// keeping an mbarrier ring of 128-byte k-steps in flight, two consumer
// warpgroups on m64n128k32 s8 wgmma with exact int32 accumulators), the
// fp32 epilogue applied from the accumulator registers.  Hopper's int8 MMA
// takes no transposed operand, so both operands are K-major: every weight is
// laid out once, at quantize time, as [N, K].  The row quantization at a
// GEMM's input is its own bytes-bound pass, one warp per row.  K9's
// requantize needs the whole 4304-wide row, which no GEMM tile sees: the
// GEMM keeps each y tile in shared memory and requantizes it once its
// 128-row panel's row maxima are complete (QOUT below), where a second pass
// read 1.27 GB of fp32 y back per block at batch 64.  At ViT-B/16, batch 64 (M =
// 12,608, W = 768, hidden 3072) K14 is 178.5 GOP of int8 GEMM plus 7.6 GFLOP
// of bf16 attention (0.098 ms), K12 59.5 GOP (0.038 ms) and K11 119 GOP
// (0.060 ms), all bound by operations.  At ConvNeXt base_w (batch 64, 256 px)
// every K15 launch is 68.7 GOP (0.035 ms at the int8 rate); at stage 0 (M =
// 262,144 rows of C = 128) its y, res and out alone move 201 MB (0.060 ms), so
// it is bound by bytes there (its fp32 hidden row, 4C wide, stays on the SM
// under QOUT).  K13's groups are 144 columns
// wide: row_quant pads each group's codes with zeros to 160 (a multiple of
// 32), the out-proj weight is padded the same way, and the GEMM dequantizes
// its int32 sum at each group boundary with the group's row scale.  A
// 160-byte group is no 128B-swizzle box: the GEMM reads it as a 128-byte box
// and a 32-byte (32B-swizzled) one, 5 k32 products with no padding beyond
// the 16 zero codes row_quant writes.
//
// Numerics: the rounding points of the TPU kernels.  LN and all scales in
// fp32; s = max(amax, 1e-12) * (1/127); codes = clip(rint(x / s), -127, 127)
// with the IEEE division's quotient (div_rn, common.cuh) and round-half-even
// (this source is never compiled with --use_fast_math); dequant acc * (s_x * s_w) in that association; no
// contraction into FMAs at these points (__fmul_rn, __fadd_rn).
//
// Interface: plain C functions, loaded with ctypes.  Each launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Preconditions the Python wrappers check: int8 operands row-major with K a
// multiple of 16 and every pointer 16-byte aligned, N a multiple of 8, the
// group span K / G a multiple of 32 when G > 1 (also the TMA preconditions:
// 16-byte aligned bases and row and group strides).

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// row_quant: per row r of x [M, K] (bf16 or fp32), an optional fp32 LN over
// all K columns, ((x - mean) * rstd) * ln_s + ln_b (quant_matmul.py:50-54),
// then per group g of KG columns: s[r, g] = max(amax, 1e-12) * (1/127) and
// codes q[r, g * KGP + j] = clip(rint(v / s), -127, 127) for j < KG, zeros for
// j in [KG, KGP).  One warp per row: it copies the row into shared memory
// once (16-byte cp.async, the whole row in flight; element copies where a
// row is not 16-byte aligned, as at K = 588); the LN's two-pass mean and
// variance read it there, and its LN values are stored beside it in fp32
// once, for the amax and the codes.  The sums run lane-strided (lane l adds
// columns l, l + 32, ... in order, then a butterfly over the lanes), so they
// and the codes are those of the earlier one-warp kernel that read the row
// from device memory for each pass, bit for bit.  Codes are stored 4 to a
// lane (one 32-bit store) where the group span KGP is a multiple of 4.
// ---------------------------------------------------------------------------

constexpr int RQ_WARPS = 8, RQ_SMEM_MAX = 48 * 1024;

// the bytes a row takes in shared memory (rounded up to 16)
__host__ __device__ inline int rq_row_bytes(int K, int elem) { return (K * elem + 15) / 16 * 16; }

template <typename T>
__global__ void __launch_bounds__(RQ_WARPS * 32)
row_quant_kernel(const T* __restrict__ x, int M, int K, int KG, int KGP,
                 const float* __restrict__ ln_s, const float* __restrict__ ln_b, float eps,
                 int8_t* __restrict__ q, float* __restrict__ s) {
  extern __shared__ __align__(16) unsigned char rq_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= M) return;
  // the warp's row, then (with LN) its LN values in fp32
  const int row_bytes = rq_row_bytes(K, sizeof(T)) + (ln_s != nullptr ? rq_row_bytes(K, 4) : 0);
  T* srow = reinterpret_cast<T*>(rq_smem + warp * row_bytes);
  float* vrow = reinterpret_cast<float*>(rq_smem + warp * row_bytes + rq_row_bytes(K, sizeof(T)));
  const T* row = x + static_cast<size_t>(r) * K;
  if ((K * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    for (int c = lane; c < K * static_cast<int>(sizeof(T)) / 16; c += 32)
      cp_async16(reinterpret_cast<unsigned char*>(srow) + 16 * c,
                 reinterpret_cast<const unsigned char*>(row) + 16 * c, true);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int c = lane; c < K; c += 32) srow[c] = row[c];
  }
  __syncwarp();
  const int G = K / KG;
  float mean = 0.f, rstd = 1.f;
  if (ln_s != nullptr) {  // two-pass mean and variance, as jnp.mean computes them
    float sum = 0.f;
    for (int c = lane; c < K; c += 32) sum = __fadd_rn(sum, to_f32(srow[c]));
    mean = __fdiv_rn(warp_sum(sum), static_cast<float>(K));
    float sq = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __fsub_rn(to_f32(srow[c]), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(K));
    rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    for (int c = lane; c < K; c += 32)
      vrow[c] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f32(srow[c]), mean), rstd), ln_s[c]),
                          ln_b[c]);
    __syncwarp();
  }
  auto value = [&](int c) { return ln_s != nullptr ? vrow[c] : to_f32(srow[c]); };
  auto code = [&](int g, int j, float sc) -> int {
    if (j >= KG) return 0;
    return static_cast<int>(fminf(fmaxf(rintf(div_rn(value(g * KG + j), sc)), -127.f), 127.f));
  };
  int8_t* qrow = q + static_cast<size_t>(r) * G * KGP;
  for (int g = 0; g < G; ++g) {
    float amax = 0.f;
    for (int j = lane; j < KG; j += 32) amax = fmaxf(amax, fabsf(value(g * KG + j)));
    const float sc = __fmul_rn(fmaxf(warp_max(amax), 1e-12f), 1.0f / 127.0f);
    if (KGP % 4 == 0) {
      for (int j = 4 * lane; j < KGP; j += 128) {
        uint32_t packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed |= (static_cast<uint32_t>(code(g, j + e, sc)) & 0xFFu) << (8 * e);
        *reinterpret_cast<uint32_t*>(qrow + g * KGP + j) = packed;
      }
    } else {
      for (int j = lane; j < KGP; j += 32) qrow[g * KGP + j] = static_cast<int8_t>(code(g, j, sc));
    }
    if (lane == 0) s[static_cast<size_t>(r) * G + g] = sc;
  }
}

// ---------------------------------------------------------------------------
// int8_gemm: Y[M, N] = epilogue(A[M, K] . B[N, K]^T), A and B int8, K-major.
// K is G groups of P = K / G columns (G = 1: one group); group g's int32 sum
// is dequantized with its own row scale: part_g = float(acc_g) * (sa[m, g] *
// ws[n]).
//   G == 1: y = act(part_0 + bias); y *= q_scale on the q columns (n with
//           n % group_cols < q_cols); y *= gamma[n] (if given); y += R (if
//           given); stored as TO.
//   G > 1:  y = (part_0 + bias) + R, then y += part_g for g = 1 .. G-1 in order
//           (quant_matmul.py:609-615); stored as TO.
//   RES_FIRST (any G >= 1, R fp32): y = (R + bias) + part_0, then y += part_g
//           in order (K14's c_proj, quant_matmul.py:779-790); stored as TO.
// TMA + wgmma, warp-specialised and persistent, the shape of block_kernels.cu's
// gemm_kernel: a block of two consumer warpgroups and a producer warp on one
// SM.  The producer's first thread keeps a ring of k-steps in flight (6
// stages, 4 with a residual), per step one TMA box of A ([128 rows][128
// bytes]) and one of B ([128 n][128 bytes]), both K-major and 128B-swizzled,
// through 3-D maps {byte in group, group, row} whose bounds are the group's
// P bytes: a box that runs past P (or past M or N) loads zeros, never the
// next group's codes.  A group is P / 128 such steps, then its rest: one
// 32-byte step (32B-swizzled boxes of the same maps' 32-byte twins) when the
// rest is at most 32 bytes, as K13's 160-byte groups leave, else one more
// 128-byte step.  The consumers share each 128 x 128 output tile, 64 rows
// each: four m64n128k32 wgmmas per 128-byte step (one per 32-byte step),
// exact int32 sums in 64 registers a thread, one step's products in flight
// while the next is issued, a stage released (an mbarrier arrival per
// thread) once the products that read it are done.  At a group's end (G > 1)
// the consumer waits for its products and folds the group's dequantized
// partial into 64 fp32 registers; the next group's first product starts the
// int32 sum anew.  The block walks output tiles (blockIdx.x, + gridDim.x,
// ...) with the ring running across tiles, so the next tile's loads overlap
// this tile's epilogue.  The epilogue's operands (the tile's ws, bias, gamma
// and residual rows) come by cp.async into per-warp shared blocks issued at
// the tile's start, so they land during the main loop; the epilogue then
// works on the accumulator registers (a thread's rows lane / 4 + {0, 8} of
// its warp's 16, column pairs 8 j + 2 (lane % 4)) with every fp32 operation
// of the mma.sync kernel this replaced, in its order and with __fmul_rn /
// __fadd_rn: since the int32 sums are exact, the output is that kernel's bit
// for bit (and its plain version's wherever no activation is applied).
// Ragged M, N and K edges are TMA's zero fill and the store masks.
// Bound: operations at SO400M's shapes (qkv 293.6 GOP, 0.148 ms at 1,979
// TOPS); the epilogue is not overlapped with the tensor cores, and with an
// exact transcendental activation (tanhf, expf and an IEEE division per
// value) it takes as long as the main loop (PERF.md).
// QOUT (G == 1, an activation, no q-scale, gamma or residual): the output is
// the requantized y, codes q[M, G' * KGP] and scales s[M, G'] over G' groups
// of KG columns (G' = 1: the whole row; K14's hidden chunks), each group's
// codes padded with zeros to KGP: row_quant of y, whose max needs the whole
// row (SO400M's c_fc: 4,304 columns, 34 tiles), which no tile holds.  So the
// requantize runs inside the persistent launch, and y never leaves the SM:
// the epilogue keeps its fp32 tile in shared memory (the residual's staging
// area; a ring of 4 stages, as with a residual), folds |y| into the
// per-(row, group) maxima in device memory by atomicMax on the bits of the
// non-negative float, and counts the tile in its 128-row panel's counter.
// The block quantizes the tile one main loop later, when the panel's other
// tiles (in the same pass of the 132 blocks over the tiles) have counted:
// out of shared memory, 8 codes a thread (the scales' maxima loaded
// together, the division by div_rn below), each scale once.  The waits
// end because a block waits only for tiles of lower index, which blocks
// hold that are resident (one an SM, every SM: the launch needs the whole
// card, and a kernel that never ends on another stream would hold it up),
// and because no block owns two tiles of one panel: N <= 128 x the SMs,
// which aihab_int8_gemm_qout checks (tiles_n <= gridDim).  The fp32 y values are the fp32-output mode's, from the
// same operations in the same order, and the codes row_quant's of them,
// bit for bit: at SO400M 635 MB each way of fp32 y no longer cross device
// memory.  Tried first, and slower (PERF.md): y in a ring of L2-resident
// panel slots, quantized by the block that finished the panel (on ~4 SMs
// at a time), or tile by tile out of L2 with the slots dropped from L2
// (discard.global.L2); and the quantize in slices between the next tile's
// k-steps (ptxas then serialized the wgmmas, C7520).
// ---------------------------------------------------------------------------

constexpr int QBM = 128, QBN = 128, QBK = 128, QTAIL = 32, Q_THREADS = 288;
constexpr int Q_MAX_STAGES = 6, QGEMM_SMEM_MAX = 232448;  // an H100 block's shared memory
constexpr int QA_BYTES = QBM * QBK, Q_STAGE = QA_BYTES + QBN * QBK;  // 32 KB a stage
constexpr unsigned Q_MAIN_TX = Q_STAGE, Q_TAIL_TX = (QBM + QBN) * QTAIL;
// past the ring, per consumer warp: the tile's ws, bias and gamma ([128]
// fp32 each); with a residual, its 16 rows of the tile (128 columns of TR,
// rows 16 bytes more apart than their width, against bank conflicts)
constexpr int QV_WARP = 3 * QBN * 4, QR_WARP = 16 * (QBN * 4 + 16);
constexpr int QV_BYTES = 8 * QV_WARP, QR_BYTES = 8 * QR_WARP;

// the ring's depth: as many stages as fit beside the epilogue's blocks (6
// without a residual, 4 with one)
inline int q_stages(bool residual) {  // (the quantized output's y tile takes the residual's room)
  const int fit = (QGEMM_SMEM_MAX - 1024 - 2 * Q_MAX_STAGES * 8 - QV_BYTES -
                   (residual ? QR_BYTES : 0)) / Q_STAGE;
  return fit < Q_MAX_STAGES ? fit : Q_MAX_STAGES;
}
inline int q_smem(int stages, bool residual) {
  return 1024 + stages * Q_STAGE + QV_BYTES + (residual ? QR_BYTES : 0) + 2 * Q_MAX_STAGES * 8;
}

// a compile-time constant as a value (the epilogue's activation and group
// place)
template <int V>
struct Tag {
  static constexpr int value = V;
};

// two adjacent values of shared memory as floats
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void load2(const bf16* p, float (&v)[2]) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(t);
  v[1] = __high2float(t);
}

// the quantized output's row maxima, panel counters and outputs (QOUT)
struct QOut {
  unsigned* amax;     // [M][G] |y| maxima (float bits), zero at the launch
  int* done;          // per 128-row panel: tiles whose y and maxima are in; zero at the launch
  int8_t* q;          // codes [M, G * KGP]
  float* s;           // scales [M, G]
  int G, KG, KGP;
};

// consumer-only named barrier (the 256 threads of the two warpgroups)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// spin until *p >= v; traps after ~2^35 cycles, as mbar_wait does, so a
// lost count fails the launch.  Every lane loads with acquire at device
// scope, so each lane's later loads see what the count's release covers,
// and the warp leaves once every lane has seen v (a vote, so that ptxas
// sees a warp-uniform loop: a divergent one in the consumer warpgroups made
// it serialize their wgmmas, C7520).
__device__ __forceinline__ void wait_at_least(const int* p, int v) {
  auto seen = [&] {
    int x;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(x) : "l"(p) : "memory");
    return __all_sync(0xffffffffu, x >= v);
  };
  if (seen()) return;
  const long long t0 = clock64();
  while (!seen()) {
    __nanosleep(100);
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// the k-steps of a group of P bytes: P / 128 of 128 bytes, then the rest: a
// 32-byte step (tail 1) when it is at most 32 bytes, else one more of 128
__host__ __device__ inline void group_steps(int P, int& n_main, int& tail) {
  const int rest = P % QBK;
  n_main = P / QBK + (rest > QTAIL ? 1 : 0);
  tail = rest > 0 && rest <= QTAIL ? 1 : 0;
}

template <bool GROUPED, bool RES_FIRST, typename TR, typename TO, bool QOUT>
__global__ void __launch_bounds__(Q_THREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_at,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_bt, const float* __restrict__ sa,
                 const float* __restrict__ ws, const float* __restrict__ bias,
                 const float* __restrict__ gamma, const TR* __restrict__ R,
                 TO* __restrict__ Y, int M, int N, int G, int P, int act, float q_scale,
                 int q_cols, int group_cols, int stages, const QOut qo) {
  static_assert(!QOUT || (!GROUPED && !RES_FIRST), "the quantized output takes G == 1");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* past_ring = smem + stages * Q_STAGE;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(past_ring + QV_BYTES + (R != nullptr || QOUT ? QR_BYTES : 0));
  uint64_t* empty = full + Q_MAX_STAGES;

  int n_main, tail;
  group_steps(P, n_main, tail);
  const int steps = n_main + tail;  // per group
  const int tiles_n = (N + QBN - 1) / QBN;
  const int n_tiles = ((M + QBM - 1) / QBM) * tiles_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread reads every stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast so that ptxas knows it is warp-uniform
  // (a branch on threadIdx.x >> 7 itself is a divergent path to it, and
  // wgmmas on one are serialized, C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0), t = threadIdx.x & 127;
  if (wg == 2) {  // the producer warp
    if (t != 0) return;
    int s = 0, phase = 0;  // the ring position and the parity of its pass
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * QBM, n0 = (tile % tiles_n) * QBN;
      for (int g = 0; g < G; ++g)
        for (int i = 0; i < steps; ++i) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * Q_STAGE;
          const bool main = i < n_main;
          mbar_expect_tx(&full[s], main ? Q_MAIN_TX : Q_TAIL_TX);
          tma_load_3d(st, main ? &map_a : &map_at, &full[s], i * QBK, g, m0);
          tma_load_3d(st + QA_BYTES, main ? &map_b : &map_bt, &full[s], i * QBK, g, n0);
          if (++s == stages) s = 0, phase ^= 1;
        }
    }
    return;
  }

  // consumer wg: rows wg * 64 .. + 64 of each tile, warp w8's 16 of them
  const int warp = t >> 5, lane = t & 31, c2 = (lane & 3) * 2, w8 = wg * 4 + warp;
  float* vec = reinterpret_cast<float*>(past_ring + w8 * QV_WARP);  // ws | bias | gamma
  unsigned char* rst = past_ring + QV_BYTES + w8 * QR_WARP;        // residual rows
  constexpr int RSZ = sizeof(TR), RP = QBN * RSZ + 16;             // a staged row's bytes
  // the epilogue's column blocks of 8 a chunk (the grouped instance keeps
  // its fp32 partial sums in 64 more registers)
  constexpr int EPI_J = GROUPED ? 2 : 4;
  int acc[QBN / 2];
#pragma unroll
  for (int i = 0; i < QBN / 2; ++i) acc[i] = 0;
  float yv[GROUPED ? QBN / 2 : 1];
  int s = 0, phase = 0, prev = 0;  // the ring position, its pass's parity, the last one
  // QOUT: the tile's y in shared memory (the residual's staging area, 128
  // rows of QY_PITCH bytes), and the first tile column of the tile's second
  // quantization group (QBN: none)
  constexpr int QY_PITCH = QBN * 4 + 16;
  unsigned char* ytile = past_ring + QV_BYTES;
  int qsplit = QBN;

  // the tile's epilogue operands, by cp.async into the warp's blocks at the
  // tile's start (they land during the main loop): ws, bias, gamma at
  // columns n0.. (past N: zeros), the residual's rows rw.. (past M: zeros)
  auto fetch = [&](int rw, int n0) {
    const int col = n0 + lane * 4;
    const bool in = col < N;  // N is a multiple of 8: 4 columns are in or out
    cp_async16(vec + lane * 4, in ? ws + col : ws, in);
    cp_async16(vec + QBN + lane * 4, in ? bias + col : bias, in);
    if (gamma != nullptr) cp_async16(vec + 2 * QBN + lane * 4, in ? gamma + col : gamma, in);
    if (R != nullptr) {
      constexpr int CPR = QBN * RSZ / 16;  // 16-byte copies a row
#pragma unroll
      for (int f = lane; f < 16 * CPR; f += 32) {
        const int rr = f / CPR, cc = (f % CPR) * (16 / RSZ);
        const bool ok = rw + rr < M && n0 + cc < N;
        cp_async16(rst + rr * RP + cc * RSZ,
                   ok ? R + static_cast<size_t>(rw + rr) * N + n0 + cc : R, ok);
      }
    }
    cp_async_commit();
  };

  // part = float(acc) * (sa[row, g] * ws[col]) for this thread's 64 values
  // (register 4 j + 2 h + e: row r0 + 8 h, column n0 + 8 j + c2 + e, staged
  // row lr + 8 h and column 8 j + c2 + e): the first group's starts y, a
  // later one's is added to y (GROUPED); at the last group y is finished
  // and stored.  Which group (FIRST, LAST) and the activation are
  // compile-time constants, so each instance is straight-line code over all
  // 64 values: rows past M and columns past N are computed on the staged
  // zeros and only their stores are skipped (the epilogue is bound by its
  // instructions; per element at run time, the activation's untaken
  // transcendental paths ran under predication at 5x the main loop's time
  // on an H100).  EPI_J column blocks at a time, the chunk's accumulators
  // are read into floats first, outside every thread-dependent branch (read
  // inside one, they made ptxas serialize the main loop's wgmmas, C7520).
  // Every operand but the row scales sr (loaded at the group's start) comes
  // from the warp's staged blocks.
  auto dequant = [&](int r0, int n0, const float (&sr)[2], auto act_tag, auto first_tag,
                     auto last_tag) {
    constexpr int ACT = decltype(act_tag)::value;
    constexpr bool FIRST = decltype(first_tag)::value, LAST = decltype(last_tag)::value;
    const bool with_r = R != nullptr && (!GROUPED || FIRST);
    const int lr = lane >> 2;  // the thread's first staged row
    float qmx[4] = {0.f, 0.f, 0.f, 0.f};  // QOUT: |y| maxima, rows h, groups 0 / 1 of the tile
    // bit j: columns n0 + 8 j + c2 (+ 1) are q columns (col % group_cols <
    // q_cols; col is even and group_cols = 3 q_width is even, so col + 1 is
    // in col's group), from one division a tile
    unsigned qmask = 0;
    if (!GROUPED && q_cols > 0) {
      int pos = (n0 + c2) % group_cols;
#pragma unroll
      for (int j = 0; j < QBN / 8; ++j) {
        if (pos < q_cols) qmask |= 1u << j;
        for (pos += 8; pos >= group_cols;) pos -= group_cols;
      }
    }
#pragma unroll
    for (int jb = 0; jb < QBN / 8; jb += EPI_J) {
      float fa[2][EPI_J][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jj = 0; jj < EPI_J; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            fa[h][jj][e] = __int2float_rn(acc[4 * (jb + jj) + 2 * h + e]);
            asm volatile("" : "+f"(fa[h][jj][e]));
          }
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int j = jb + jj, lc = 8 * j + c2;
        float wv[2], bv[2] = {0.f, 0.f}, gv[2] = {1.f, 1.f};
        load2(vec + lc, wv);
        if (FIRST) load2(vec + QBN + lc, bv);
        if (!GROUPED && gamma != nullptr) load2(vec + 2 * QBN + lc, gv);
        const bool qcol = (qmask >> j) & 1u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float rv[2] = {0.f, 0.f}, o[2];
          if (with_r) load2(reinterpret_cast<const TR*>(rst + (lr + 8 * h) * RP) + lc, rv);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float part = __fmul_rn(fa[h][jj][e], __fmul_rn(sr[h], wv[e]));
            float y;
            if constexpr (!FIRST) {
              y = __fadd_rn(yv[GROUPED ? i : 0], part);
            } else if constexpr (RES_FIRST) {
              y = __fadd_rn(__fadd_rn(rv[e], bv[e]), part);
            } else {
              y = __fadd_rn(part, bv[e]);
              if (GROUPED && with_r) y = __fadd_rn(y, rv[e]);
            }
            if constexpr (!GROUPED) {  // act, q-scale, gamma, residual
              y = act_f32(y, ACT);
              if (qcol) y = __fmul_rn(y, q_scale);
              if (gamma != nullptr) y = __fmul_rn(y, gv[e]);
              if (with_r) y = __fadd_rn(y, rv[e]);
            }
            if constexpr (GROUPED && !LAST) yv[i] = y;
            o[e] = y;
          }
          const int row = r0 + 8 * h, col = n0 + lc;
          // N is a multiple of 8: col + 1 < N too
          if constexpr (QOUT) {
            // y of every row and column of the tile (past M or N: never
            // quantized; past N y = act(0) = 0, which adds nothing to a max)
            store2(reinterpret_cast<float*>(ytile + (row & (QBM - 1)) * QY_PITCH) + lc, o[0],
                   o[1]);
            const float a = fmaxf(fabsf(o[0]), fabsf(o[1]));
            if (8 * j < qsplit) qmx[h] = fmaxf(qmx[h], a);
            else qmx[2 + h] = fmaxf(qmx[2 + h], a);
          } else if (LAST && row < M && col < N) {
            store2(Y + static_cast<size_t>(row) * N + col, o[0], o[1]);
          }
        }
      }
    }
    if constexpr (QOUT) {  // the quad's maxima of rows r0, r0 + 8 into the row maxima
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qmx[i] = fmaxf(qmx[i], __shfl_xor_sync(0xffffffffu, qmx[i], 1));
        qmx[i] = fmaxf(qmx[i], __shfl_xor_sync(0xffffffffu, qmx[i], 2));
      }
      const int g0 = n0 / qo.KG;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned* mrow = qo.amax + static_cast<size_t>(r0 + 8 * h) * qo.G + g0;
        if ((lane & 3) == 0 && r0 + 8 * h < M) {
          atomicMax(mrow, __float_as_uint(qmx[h]));
          if (qsplit < QBN && g0 + 1 < qo.G) atomicMax(mrow + 1, __float_as_uint(qmx[2 + h]));
        }
      }
    }
  };
  // the epilogue of group g: its instance for the group's place and the
  // launch's activation
  auto epilogue = [&](int g, int r0, int n0, const float (&sr)[2]) {
    cp_async_wait<0>();  // this lane's staged operands have landed
    __syncwarp();        // and the warp's
    if constexpr (GROUPED) {
      if (G == 1) dequant(r0, n0, sr, Tag<ACT_NONE>{}, Tag<1>{}, Tag<1>{});
      else if (g == 0) dequant(r0, n0, sr, Tag<ACT_NONE>{}, Tag<1>{}, Tag<0>{});
      else if (g + 1 == G) dequant(r0, n0, sr, Tag<ACT_NONE>{}, Tag<0>{}, Tag<1>{});
      else dequant(r0, n0, sr, Tag<ACT_NONE>{}, Tag<0>{}, Tag<0>{});
    } else {
      switch (act) {
        case ACT_QUICK_GELU:
          dequant(r0, n0, sr, Tag<ACT_QUICK_GELU>{}, Tag<1>{}, Tag<1>{});
          break;
        case ACT_GELU_TANH:
          dequant(r0, n0, sr, Tag<ACT_GELU_TANH>{}, Tag<1>{}, Tag<1>{});
          break;
        case ACT_GELU_SIG5:
          dequant(r0, n0, sr, Tag<ACT_GELU_SIG5>{}, Tag<1>{}, Tag<1>{});
          break;
        default: dequant(r0, n0, sr, Tag<ACT_NONE>{}, Tag<1>{}, Tag<1>{});
      }
    }
  };

  // QOUT: the codes (and, at each group's first column, the scales) of the
  // last tile, whose y is in shared memory, once every tile of its panel
  // has folded its |y| into the row maxima.  A thread quantizes 8 vectors
  // of 8 columns (its column vector, rows 16 apart).
  auto quantize_tile = [&](int m0, int n0) {
    constexpr int NU = QBM * QBN / 8 / 256;
    wait_at_least(qo.done + m0 / QBM, tiles_n);  // (an acquire: the maxima are in)
    const int QG = qo.G, KG = qo.KG, KGP = qo.KGP;
    const int col = n0 + 8 * (threadIdx.x % (QBN / 8)), r_lo = threadIdx.x / (QBN / 8);
    const int g = (col < N ? col : n0) / KG, j = col - g * KG;  // KG % 8 == 0: one group
    float sc[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {  // the rows' maxima, loaded together
      const int row = m0 + r_lo + 16 * u;
      const unsigned mx = __ldcg(qo.amax + static_cast<size_t>(row < M ? row : m0) * QG + g);
      sc[u] = __fmul_rn(fmaxf(__uint_as_float(mx), 1e-12f), 1.0f / 127.0f);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int r = r_lo + 16 * u, row = m0 + r;
      const float4* src =
          reinterpret_cast<const float4*>(ytile + r * QY_PITCH) + 2 * (threadIdx.x % (QBN / 8));
      const float4 lo = src[0], hi = src[1];
      const float y8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint2 packed = make_uint2(0u, 0u);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = fminf(fmaxf(rintf(div_rn(y8[e], sc[u])), -127.f), 127.f);
        const uint32_t byte = static_cast<uint32_t>(static_cast<int>(c)) & 0xFFu;
        if (e < 4) packed.x |= byte << (8 * e);
        else packed.y |= byte << (8 * (e - 4));
      }
      if (row < M && col < N) {
        int8_t* qrow = qo.q + static_cast<size_t>(row) * QG * KGP + g * KGP;
        *reinterpret_cast<uint2*>(qrow + j) = packed;
        if (j == 0) qo.s[static_cast<size_t>(row) * QG + g] = sc[u];
        if (j + 8 == KG)  // the group's zero codes past its KG columns
          for (int z = KG; z < KGP; z += 8)
            *reinterpret_cast<uint2*>(qrow + z) = make_uint2(0u, 0u);
      }
    }
  };
  int q_prev = -1;  // QOUT: the last tile, whose quantize waits one main loop

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * QBM, n0 = (tile % tiles_n) * QBN;
    const int rw = m0 + wg * 64 + warp * 16, r0 = rw + (lane >> 2);  // rows r0, r0 + 8
    __syncwarp();  // the warp's lanes are done reading the last tile's blocks
    fetch(rw, n0);
    for (int g = 0; g < G; ++g) {
      float sr[2];  // the group's row scales, loaded before its main loop
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sr[h] = r0 + 8 * h < M ? __ldg(sa + static_cast<size_t>(r0 + 8 * h) * G + g) : 0.f;
      for (int i = 0; i < steps; ++i) {
        mbar_wait(&full[s], phase);
        const unsigned char* st = smem + s * Q_STAGE;
        wgmma_fence();
        if (i < n_main) {
#pragma unroll
          for (int kk = 0; kk < QBK / 32; ++kk)
            wgmma_s8_n128(acc, smem_desc(st + wg * 64 * QBK + kk * 32, 16, 1024, SW_128B),
                          smem_desc(st + QA_BYTES + kk * 32, 16, 1024, SW_128B),
                          i > 0 || kk > 0);
        } else {
          wgmma_s8_n128(acc, smem_desc(st + wg * 64 * QTAIL, 16, 256, SW_32B),
                        smem_desc(st + QA_BYTES, 16, 256, SW_32B), i > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-step's products are done
        if (g > 0 || i > 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == stages) s = 0, phase ^= 1;
      }
      if (GROUPED || g + 1 == G) {  // the group's sum is done: dequantize it
        wgmma_wait<0>();
        fence_regs(acc);
        if (g + 1 == G) mbar_arrive(&empty[prev]);  // the tile's last stage
        if constexpr (QOUT) {
          // quantize the last tile: the other tiles of its panel, in the
          // same pass of the blocks over the tiles, are done by now
          if (q_prev >= 0) {
            quantize_tile((q_prev / tiles_n) * QBM, (q_prev % tiles_n) * QBN);
            consumer_sync();  // the last tile's y is read: this epilogue may store
          }
          q_prev = tile;
          qsplit = (n0 / qo.KG + 1) * qo.KG - n0;
        }
        epilogue(g, r0, n0, sr);
        if constexpr (QOUT) {  // count the tile's maxima as folded in
          consumer_sync();     // every consumer thread's atomics, then a release
          if (threadIdx.x == 0) {
            __threadfence();
            atomicAdd(qo.done + m0 / QBM, 1);
          }
        }
      }
    }
  }
  if constexpr (QOUT) {  // the block's last tile
    if (q_prev >= 0) quantize_tile((q_prev / tiles_n) * QBM, (q_prev % tiles_n) * QBN);
  }
}

// the 3-D map {byte in group, group, row} of an int8 [rows, G * P] operand,
// box [128 rows][width bytes] at 128B (width 128) or 32B (width 32) swizzle
inline int int8_map(CUtensorMap* map, const void* base, int rows, int G, int P, uint32_t width) {
  const uint64_t dims[3] = {static_cast<uint64_t>(P), static_cast<uint64_t>(G),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[2] = {static_cast<uint64_t>(P),
                               static_cast<uint64_t>(G) * static_cast<uint64_t>(P)};
  const uint32_t box[3] = {width, 1, static_cast<uint32_t>(QBM)};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, base, dims, strides, box,
                         width == QBK ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <bool GROUPED, bool RES_FIRST, typename TR, typename TO, bool QOUT = false>
int launch_int8_gemm(const void* a, const float* sa, const void* w, const float* ws,
                     const float* bias, const float* gamma, const void* r, void* y, int M,
                     int N, int K, int G, int act, float q_scale, int q_cols, int group_cols,
                     cudaStream_t stream, const QOut& qo = QOut{}) {
  if (M < 1 || N < 8 || K < 16 || G < 1 || K % G) return static_cast<int>(cudaErrorInvalidValue);
  const int P = K / G;
  CUtensorMap maps[4];  // A, its 32-byte twin, B, its twin
  int err = int8_map(&maps[0], a, M, G, P, QBK);
  if (err == 0) err = int8_map(&maps[1], a, M, G, P, QTAIL);
  if (err == 0) err = int8_map(&maps[2], w, N, G, P, QBK);
  if (err == 0) err = int8_map(&maps[3], w, N, G, P, QTAIL);
  if (err != 0) return err;
  auto kernel = int8_gemm_kernel<GROUPED, RES_FIRST, TR, TO, QOUT>;
  const bool residual = r != nullptr || QOUT;
  const int stages = q_stages(residual), smem = q_smem(stages, residual);
  const int most = q_smem(q_stages(true), true) > q_smem(q_stages(false), false)
                       ? q_smem(q_stages(true), true)
                       : q_smem(q_stages(false), false);
  const cudaError_t ce =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int tiles = ((M + QBM - 1) / QBM) * ((N + QBN - 1) / QBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, Q_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], sa, ws, bias, gamma, static_cast<const TR*>(r),
      static_cast<TO*>(y), M, N, G, P, act, q_scale, q_cols, group_cols, stages, qo);
  return static_cast<int>(cudaGetLastError());
}

// as many rows (warps) a block as fit in 48 KB of shared memory, at most 8;
// a row wider than 48 KB takes a block of its own with more shared memory
template <typename T>
int launch_row_quant(const void* x, int M, int K, int KG, int KGP, const float* ln_s,
                     const float* ln_b, float eps, void* q, void* s, cudaStream_t stream) {
  const int row_bytes = rq_row_bytes(K, sizeof(T)) + (ln_s != nullptr ? rq_row_bytes(K, 4) : 0);
  int rows = RQ_SMEM_MAX / row_bytes;
  rows = rows < 1 ? 1 : rows > RQ_WARPS ? RQ_WARPS : rows;
  const int smem = rows * row_bytes;
  if (smem > RQ_SMEM_MAX) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_quant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  row_quant_kernel<T><<<(M + rows - 1) / rows, rows * 32, smem, stream>>>(
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

// codes q[M, G * KGP] (int8) and scales s[M, G] (fp32) of y = act(a[M, K]
// . w[N, K]^T dequantized with sa[M] and ws[N], + bias[N]), per group of KG
// columns (G = N / KG; KG a multiple of 8, and of at least 128 when G > 1),
// each group's codes padded with zeros to KGP (a multiple of 8): row_quant
// of int8_gemm's fp32 y, in one launch.  act as aihab_int8_gemm's.  ctl:
// M * G + ceil(M / 128) ints, zero.  N at most 128 x the SMs (a panel's
// tiles on distinct blocks; see QOUT above).
int aihab_int8_gemm_qout(const void* a, const float* sa, const void* w, const float* ws,
                         const float* bias, int M, int N, int K, int act, void* ctl, void* q,
                         void* s, int G, int KG, int KGP, void* stream) {
  if (act > ACT_GELU_SIG5 || G < 1 || KG * G != N || KG % 8 || KGP % 8 || KGP < KG ||
      (G > 1 && KG < QBN) || (N + QBN - 1) / QBN > sm_count())
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* amax = static_cast<unsigned*>(ctl);
  const QOut qo{amax, reinterpret_cast<int*>(amax + static_cast<size_t>(M) * G),
                static_cast<int8_t*>(q), static_cast<float*>(s), G, KG, KGP};
  return launch_int8_gemm<false, false, bf16, float, true>(
      a, sa, w, ws, bias, nullptr, nullptr, nullptr, M, N, K, 1, act, 1.f, 0, 1,
      static_cast<cudaStream_t>(stream), qo);
}

// The launch plan of int8_gemm at [M, N] over K in `groups` groups (the
// grouped instance when groups > 1), mode 0 plain, 1 with a residual, 2
// the quantized output, for reports: out = {ring stages, shared bytes a
// block, output tiles, blocks, registers a thread, local (spill) bytes a
// thread, k-steps a tile, of them 32-byte ones}.
int aihab_int8_gemm_plan(int M, int N, int K, int groups, int mode, int* out) {
  cudaFuncAttributes attr;
  const int residual = mode == 1 || mode == 2;  // (QOUT's y tile takes the residual's room)
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, groups > 1  ? (const void*)int8_gemm_kernel<true, false, bf16, bf16, false>
             : mode == 2 ? (const void*)int8_gemm_kernel<false, false, bf16, float, true>
                         : (const void*)int8_gemm_kernel<false, false, bf16, bf16, false>);
  int n_main, tail;
  group_steps(K / groups, n_main, tail);
  const int tiles = ((M + QBM - 1) / QBM) * ((N + QBN - 1) / QBN);
  out[0] = q_stages(residual != 0);
  out[1] = q_smem(q_stages(residual != 0), residual != 0);
  out[2] = tiles;
  out[3] = tiles < sm_count() ? tiles : sm_count();
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  out[6] = groups * (n_main + tail);
  out[7] = groups * tail;
  return static_cast<int>(err);
}

}  // extern "C"
