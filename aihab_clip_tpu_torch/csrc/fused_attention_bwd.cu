// Hopper (sm_90a) backward of fused_attention (K6b).
//
// Replaces the Pallas TPU kernel aihab_clip_tpu/ops/attention.py::
// _pallas_attention_bwd (:204, pallas_call :226; _attn_bwd_kernel :130),
// which the custom VJP of fused_attention (:253-276) runs.  The TPU program
// holds one (image, head group)'s whole [S, S] score, P, dP and dS in VMEM.
// An SM has 227 KB, so this is the FlashAttention-2 split into two kernels
// that never form an [S, S] tensor: P is rebuilt tile by tile from the
// forward's fp32 row log-sum-exp (block_kernels.cu, flash_attention_kernel
// with lse), as p = exp(scale * q.k - lse), which is the TPU kernel's
// normalised fp32 P up to fp32 rounding.
//
//   dq kernel    one block per (64-query tile, head, image): first the row
//                term delta = rowsum(dO * O) of its rows (stored for the
//                dk/dv kernel), then a loop over key tiles: S = Q K^T, P,
//                dP = dO V^T, dS = bf16(P * (dP - delta) * scale),
//                dQ += dS K.
//   dk/dv kernel one block per (64-key tile, head, image), a loop over query
//                tiles: S^T = K Q^T, P^T, dV += bf16(P^T) dO, dP^T = V dO^T,
//                dS^T, dK += dS^T Q.
// Each output is written by exactly one block: no atomics, deterministic.
// The numerics follow _attn_bwd_kernel (:130-171): P in fp32, dv = bf16(p)^T
// dO, dp = dO v^T in fp32, ds rounded to bf16 before the dq and dk products,
// all accumulated in fp32 and stored in q's dtype.  One difference, stated
// with its cost in PERF.md: the row term is rowsum(dO * O) over the bf16
// forward output (FlashAttention-2's), where the TPU kernel sums dp * p over
// the whole row; the two are equal in exact arithmetic.
//
// Design: the flash forward's, one warpgroup a block.  Both kernels are one
// template: a resident pair of [64][D] tiles (dq: Q and dO; dk/dv: K and V)
// comes by TMA once, and the other pair (dq: K and V; dk/dv: Q and dO) streams
// through a two-stage mbarrier ring, thread 0 loading tile t + 2 once every
// warp is done with tile t.  Tiles are addressed by the forward's 5-D maps
// {d, head, group, row, image}: D = 64 is one 128B-swizzled box, D = 72 a
// 64-column box plus a 16-column 32B-swizzled one at column 64 (zero-filled
// past D, past S and between images).  Every product is a wgmma: S and dP
// from shared memory (both operands K-major: a [rows][D] tile is B's K-major
// layout); P and dS are rounded to bf16 in registers and are the register-A
// operand of the dV, dK and dQ products, whose B (dO, Q or K, [rows][D]) is
// read MN-major by the transpose bit.  So the scores, P, dP and dS never
// leave registers, and shared memory holds only the TMA tiles.  The dk/dv
// kernel reads each query column's lse and delta from global memory (L1),
// issued before it waits for the tile.  7 products in all (S and dP are
// formed in both kernels).
//
// Bound.  At SigLIP SO400M (B=16, S=576, 16 heads of 72) the backward's
// 5 products are 2 B H S^2 D each, 61.2 GFLOP against 149 MB of operands, so
// it is bound by operations: 0.062 ms at 989 TFLOP/s for 5 products, 0.087
// for the 7 this design forms (D padded to 80 for the contractions).
//
// Interface: plain C functions, loaded with ctypes; each launches on the
// given stream, allocates nothing and returns cudaGetLastError().  q, k, v,
// o, dout, dq, dk, dv are [B, S, heads*D] bf16, row-major, 16-byte aligned;
// lse and delta [B, heads, S] fp32; D is 64 or 72.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BT = 64, BWD_THREADS = 128, BWD_STAGES = 2;

template <int HD>
struct BwdCfg {
  static constexpr bool TAIL = HD > 64;
  static constexpr int MAIN = BT * 128, TAIL_BYTES = TAIL ? BT * 32 : 0;  // per tile
  // main boxes 1024-aligned first: the resident pair X0, X1, then stage s's
  // streamed pair Y0, Y1 at RING + 2 s MAIN (+ MAIN); then their tails in
  // the same order
  static constexpr int RING = 2 * MAIN;
  static constexpr int TAILS = (2 + 2 * BWD_STAGES) * MAIN;
  static constexpr int RING_TAIL = TAILS + 2 * TAIL_BYTES;
  static constexpr int BARS = TAILS + (2 + 2 * BWD_STAGES) * TAIL_BYTES;
  static constexpr int DELTA = BARS + (1 + BWD_STAGES) * 8;  // the dq kernel's delta[64]
  static constexpr int SMEM = 1024 + DELTA + BT * 4;
  static constexpr unsigned PAIR_TX = 2 * (MAIN + TAIL_BYTES);
};

// P (or dS) in bf16 as register-A fragments of the next product: columns
// 16 kk .. 16 kk + 15 of an m64n64 accumulator (hopper.cuh)
__device__ __forceinline__ void a_fragments(uint32_t (&f)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1]);
}

// d (+ dt, D = 72) += A (fragments) * B, B a [64 rows][D] tile pair (main
// box, tail box) read MN-major: the rows are the contraction
template <bool TAIL>
__device__ __forceinline__ void rs_product(float (&d)[32], float (&dt)[8],
                                           const uint32_t (&f)[4][4],
                                           const unsigned char* main,
                                           const unsigned char* tail, int tail_bytes) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<64, 1>(d, f[kk], smem_desc(main + kk * 2048, BT * 128, 1024, SW_128B), 1);
    if constexpr (TAIL)
      wgmma_rs<16, 1>(dt, f[kk], smem_desc(tail + kk * 512, tail_bytes, 256, SW_32B), 1);
  }
}

// d = X Y^T over D: X and Y [64 rows][D] tile pairs, both K-major
template <bool TAIL>
__device__ __forceinline__ void ss_product(float (&d)[32], const unsigned char* x_main,
                                           const unsigned char* x_tail,
                                           const unsigned char* y_main,
                                           const unsigned char* y_tail) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<64, 0>(d, smem_desc(x_main + kk * 32, 16, 1024, SW_128B),
                    smem_desc(y_main + kk * 32, 16, 1024, SW_128B), kk > 0);
  if constexpr (TAIL)
    wgmma_ss<64, 0>(d, smem_desc(x_tail, 16, 256, SW_32B), smem_desc(y_tail, 16, 256, SW_32B),
                    1);
}

// The accumulator rows (hopper.cuh): thread `lane` of warp `warp` holds
// rows warp * 16 + lane / 4 + 8 h (registers 4 j + 2 h + e) at columns
// 8 j + 2 (lane % 4) + e.  Stores rows < S of d (+ dt) to dst's rows r0..
// (ld apart), columns [0, HD).
template <int HD>
__device__ __forceinline__ void store_tile(const float (&d)[32], const float (&dt)[8],
                                           bf16* dst, int r0, int S, size_t ld, int warp,
                                           int lane) {
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + (lane >> 2) + 8 * h;
    if (r >= S) continue;
    bf16* row = dst + r * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) store2(row + j * 8 + c2, d[j * 4 + h * 2], d[j * 4 + h * 2 + 1]);
    if constexpr (HD > 64)  // columns 64-71 (j = 0); 72-79 are padding
      store2(row + 64 + c2, dt[h * 2], dt[h * 2 + 1]);
  }
}

// DKDV false: the dq kernel (rows: queries; X = Q, dO; Y = K, V).
// DKDV true: the dk/dv kernel (rows: keys; X = K, V; Y = Q, dO).
// map_x0/x1/y0/y1 and their 16-column tails (D = 72) address the operands;
// o is read only by the dq kernel (the row term), dq null: only the row term.
template <int HD, bool DKDV>
__global__ void __launch_bounds__(BWD_THREADS, 2)
attention_bwd_kernel(const __grid_constant__ CUtensorMap map_x0,
                     const __grid_constant__ CUtensorMap map_x1,
                     const __grid_constant__ CUtensorMap map_y0,
                     const __grid_constant__ CUtensorMap map_y1,
                     const __grid_constant__ CUtensorMap map_x0t,
                     const __grid_constant__ CUtensorMap map_x1t,
                     const __grid_constant__ CUtensorMap map_y0t,
                     const __grid_constant__ CUtensorMap map_y1t, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ delta, bf16* __restrict__ out0,
                     bf16* __restrict__ out1, int S, int heads, float scale) {
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* full = xbar + 1;
  float* delta_s = reinterpret_cast<float*>(smem + C::DELTA);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, c2 = (lane & 3) * 2;
  const int r0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + BT - 1) / BT;
  const size_t W = static_cast<size_t>(heads) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * W + h * HD;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * S;
  const bool compute = DKDV || out0 != nullptr;  // the dq kernel may form delta only

  auto y_main = [&](int s, int i) { return smem + C::RING + (2 * s + i) * C::MAIN; };
  auto y_tail = [&](int s, int i) { return smem + C::RING_TAIL + (2 * s + i) * C::TAIL_BYTES; };
  auto load_y = [&](int t) {
    const int s = t % BWD_STAGES;
    mbar_expect_tx(&full[s], C::PAIR_TX);
    tma_load_5d(y_main(s, 0), &map_y0, &full[s], 0, h, 0, t * BT, b);
    tma_load_5d(y_main(s, 1), &map_y1, &full[s], 0, h, 0, t * BT, b);
    if constexpr (C::TAIL) {
      tma_load_5d(y_tail(s, 0), &map_y0t, &full[s], 64, h, 0, t * BT, b);
      tma_load_5d(y_tail(s, 1), &map_y1t, &full[s], 64, h, 0, t * BT, b);
    }
  };

  if (tid == 0 && compute) {
    mbar_init(xbar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    mbar_expect_tx(xbar, C::PAIR_TX);
    tma_load_5d(smem, &map_x0, xbar, 0, h, 0, r0, b);
    tma_load_5d(smem + C::MAIN, &map_x1, xbar, 0, h, 0, r0, b);
    if constexpr (C::TAIL) {
      tma_load_5d(smem + C::TAILS, &map_x0t, xbar, 64, h, 0, r0, b);
      tma_load_5d(smem + C::TAILS + C::TAIL_BYTES, &map_x1t, xbar, 64, h, 0, r0, b);
    }
    for (int t = 0; t < BWD_STAGES && t < n_tiles; ++t) load_y(t);
  }

  // the row values of this thread's two accumulator rows (dq kernel)
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
    // the row term of the block's 64 rows, two threads a row (interleaving
    // the row's 8-column vectors), stored for the dk/dv kernel
    const int row = tid >> 1, half = tid & 1, qi = r0 + row;
    float d_row = 0.f;
    if (qi < S) {
      const bf16* orow = o + head_off + qi * W;
      const bf16* grow = dout + head_off + qi * W;
      float ov[8], gv[8];
      for (int c = half * 8; c < HD; c += 16) {
        load8(orow + c, ov);
        load8(grow + c, gv);
#pragma unroll
        for (int j = 0; j < 8; ++j) d_row += ov[j] * gv[j];
      }
    }
    d_row += __shfl_xor_sync(0xffffffffu, d_row, 1);
    if (half == 0) {
      delta_s[row] = d_row;
      if (qi < S) delta[bh + qi] = d_row;
    }
    if (!compute) return;
    __syncthreads();  // delta_s, and the barriers' init
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + (lane >> 2) + 8 * hh;
      dl_r[hh] = delta_s[r];
      if (r0 + r < S) lse_r[hh] = lse[bh + r0 + r];
    }
  } else {
    __syncthreads();  // the barriers' init
  }

  // accumulators: dq kernel: a0 (+ a0t) = dQ; dk/dv kernel: a0 = dK, a1 = dV
  float a0[32], a0t[8], a1[32], a1t[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) a0[i] = a1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) a0t[i] = a1t[i] = 0.f;
  mbar_wait(xbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % BWD_STAGES, c0 = t * BT;  // c0: the tile's first column (row of Y)
    // the dk/dv kernel's per-column lse and delta (query c0 + 8 j + c2 + e;
    // past S: lse +inf, so p = 0)
    float lse_c[16], dl_c[16];
    if constexpr (DKDV) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = c0 + 8 * j + c2 + e;
          const bool ok = q < S;
          lse_c[2 * j + e] = ok ? lse[bh + q] : __int_as_float(0x7f800000);
          dl_c[2 * j + e] = ok ? delta[bh + q] : 0.f;
        }
    }
    mbar_wait(&full[s], (t / BWD_STAGES) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    ss_product<C::TAIL>(sc, smem, smem + C::TAILS, y_main(s, 0), y_tail(s, 0));  // S
    wgmma_commit();
    ss_product<C::TAIL>(dp, smem + C::MAIN, smem + C::TAILS + C::TAIL_BYTES, y_main(s, 1),
                        y_tail(s, 1));  // dP, in flight while P is formed
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P over this thread's values; the dk/dv kernel then starts dV += P^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& p = sc[j * 4 + hh * 2 + e];
          if constexpr (DKDV)
            p = expf(p * scale - lse_c[2 * j + e]);
          else
            p = c0 + 8 * j + c2 + e < S ? expf(p * scale - lse_r[hh]) : 0.f;
        }
    if constexpr (DKDV) {
      uint32_t p_f[4][4];
      a_fragments(p_f, sc);
      wgmma_fence();
      rs_product<C::TAIL>(a1, a1t, p_f, y_main(s, 1), y_tail(s, 1), C::TAIL_BYTES);  // dV
      wgmma_commit();
    }
    wgmma_wait<DKDV ? 1 : 0>();  // dP is done (dV may run on)
    fence_regs(dp);
    // dS = P (dP - delta) scale
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = j * 4 + hh * 2 + e;
          dp[i] = sc[i] * (dp[i] - (DKDV ? dl_c[2 * j + e] : dl_r[hh])) * scale;
        }
    uint32_t ds_f[4][4];
    a_fragments(ds_f, dp);
    wgmma_fence();
    // dk/dv: dK += dS^T Q; dq: dQ += dS K
    rs_product<C::TAIL>(a0, a0t, ds_f, y_main(s, 0), y_tail(s, 0), C::TAIL_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(a0);
    fence_regs(a0t);
    if constexpr (DKDV) {
      fence_regs(a1);
      fence_regs(a1t);
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && t + BWD_STAGES < n_tiles) load_y(t + BWD_STAGES);
  }

  store_tile<HD>(a0, a0t, out0 + head_off, r0, S, W, warp, lane);
  if constexpr (DKDV) store_tile<HD>(a1, a1t, out1 + head_off, r0, S, W, warp, lane);
}

// maps[i] main (width 64), maps[4 + i] tail (width 16) of the operands
// bases[0..3]: [B, S, heads * HD], one group of all heads
template <int HD>
int bwd_maps(CUtensorMap (&maps)[8], const bf16* const (&bases)[4], int B, int S,
             int heads) {
  for (int i = 0; i < 4; ++i) {
    int err = head_map(&maps[i], bases[i], HD, heads, 1, S, B, heads * HD, 0, 64, BT);
    if (err == 0 && BwdCfg<HD>::TAIL)
      err = head_map(&maps[4 + i], bases[i], HD, heads, 1, S, B, heads * HD, 0, 16, BT);
    if (err != 0) return err;
    if (!BwdCfg<HD>::TAIL) maps[4 + i] = maps[i];
  }
  return 0;
}

template <int HD, bool DKDV>
int launch_bwd_kernel(const CUtensorMap (&m)[8], const bf16* o, const bf16* dout,
                      const float* lse, float* delta, bf16* out0, bf16* out1, int B, int S,
                      int heads, float scale, cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<HD, DKDV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdCfg<HD>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BT - 1) / BT, heads, B);
  kernel<<<grid, BWD_THREADS, BwdCfg<HD>::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], o, dout, lse, delta, out0, out1, S,
      heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
               const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int S,
               int heads, float scale, cudaStream_t stream) {
  CUtensorMap dq_maps[8], dkdv_maps[8];
  const bf16* const dq_ops[4] = {q, dout, k, v};    // X0, X1, Y0, Y1
  const bf16* const dkdv_ops[4] = {k, v, q, dout};
  int err = bwd_maps<HD>(dq_maps, dq_ops, B, S, heads);
  if (err == 0) err = bwd_maps<HD>(dkdv_maps, dkdv_ops, B, S, heads);
  if (err != 0) return err;
  // the dq kernel forms delta first (also when only dk and dv are asked for)
  err = launch_bwd_kernel<HD, false>(dq_maps, o, dout, lse, delta, dq, nullptr, B, S, heads,
                                     scale, stream);
  if (err != 0 || dk == nullptr) return err;
  return launch_bwd_kernel<HD, true>(dkdv_maps, o, dout, lse, delta, dk, dv, B, S, heads,
                                     scale, stream);
}

}  // namespace

extern "C" {

// dq, dk, dv (bf16 [B,S,heads*D]) of out = fused_attention(q, k, v) from the
// output cotangent dout, the forward's out and lse; delta is a [B,heads,S]
// fp32 scratch for the row term.  dq null: only dk, dv; dk and dv null: only
// dq (both or neither).  D is 64 or 72.
int aihab_fused_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int S, int heads, int head_dim,
                              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* gq = static_cast<bf16*>(dq);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  if ((dk == nullptr) != (dv == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64)
    return launch_bwd<64>(c(q), c(k), c(v), c(o), c(dout), l, dl, gq, gk, gv, B, S, heads,
                          scale, s);
  if (head_dim == 72)
    return launch_bwd<72>(c(q), c(k), c(v), c(o), c(dout), l, dl, gq, gk, gv, B, S, heads,
                          scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plans of the two kernels at (B, S, heads, head_dim), for
// reports: out[0..5] the dq kernel's, out[6..11] the dk/dv kernel's = {ring
// stages, shared bytes a block, blocks, blocks an SM holds, registers a
// thread, local (spill) bytes a thread}.
int aihab_fused_attention_bwd_plan(int B, int S, int heads, int head_dim, int* out) {
  if (head_dim != 64 && head_dim != 72) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernels[2] = {
      head_dim == 64 ? reinterpret_cast<const void*>(attention_bwd_kernel<64, false>)
                     : reinterpret_cast<const void*>(attention_bwd_kernel<72, false>),
      head_dim == 64 ? reinterpret_cast<const void*>(attention_bwd_kernel<64, true>)
                     : reinterpret_cast<const void*>(attention_bwd_kernel<72, true>)};
  const int smem = head_dim == 64 ? BwdCfg<64>::SMEM : BwdCfg<72>::SMEM;
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernels[i]);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[i], BWD_THREADS,
                                                          smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int* o = out + 6 * i;
    o[0] = BWD_STAGES;
    o[1] = smem;
    o[2] = ((S + BT - 1) / BT) * heads * B;
    o[3] = per_sm;
    o[4] = attr.numRegs;
    o[5] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}

}  // extern "C"
