// Hopper (sm_90a) backward of fused_attention (K6b).
//
// Replaces the Pallas TPU kernel aihab_clip_tpu/ops/attention.py::
// _pallas_attention_bwd (:204, pallas_call :226; _attn_bwd_kernel :130),
// which the custom VJP of fused_attention (:253-276) runs.  The TPU program
// holds one (image, head group)'s whole [S, S] score, P, dP and dS in VMEM.
// An SM has 227 KB, so this is the FlashAttention-2 split into two kernels
// that never form an [S, S] tensor: P is rebuilt tile by tile from the
// forward's fp32 row log-sum-exp (block_kernels.cu, attention_kernel with
// lse), as p = exp(scale * q.k - lse), which is the TPU kernel's normalised
// fp32 P up to fp32 rounding.
//
//   dq kernel   one block per (64-query tile, head, image); first the row
//               term delta = rowsum(dO * O) of its rows (stored for the dk/dv
//               kernel), then a loop over key tiles: S, P, dP = dO V^T,
//               dS = bf16(P * (dP - delta) * scale), dQ += dS K.
//   dk/dv kernel one block per (64-key tile, head, image), a loop over query
//               tiles: P^T, dV += bf16(P)^T dO, dP^T = V dO^T, dS^T,
//               dK += dS^T Q.
// Each output is written by exactly one block: no atomics, deterministic.
// The numerics follow _attn_bwd_kernel (:130-171): P in fp32, dv = bf16(p)^T
// dO, dp = dO v^T in fp32, ds rounded to bf16 before the dq and dk products,
// all accumulated in fp32 and stored in q's dtype.  One difference, stated
// with its cost in PERF.md: the row term is rowsum(dO * O) over the bf16
// forward output (FlashAttention-2's), where the TPU kernel sums dp * p over
// the whole row; the two are equal in exact arithmetic.
//
// Bound.  At SigLIP SO400M (B=16, S=576, 16 heads of 72) the backward does
// 5 products of 2 B H S^2 D = 61.2 GFLOP against 149 MB of operands, so it
// is bound by operations (0.062 ms at 989 TFLOP/s); this design does 7
// products (S and dP are formed in both kernels), with WMMA (mma.sync
// 16x16x16, fp32 accumulation) from shared memory and plain 16-byte loads,
// no wgmma or TMA: right first, fast later.
//
// Interface: plain C functions, loaded with ctypes; each launches on the
// given stream, allocates nothing and returns cudaGetLastError().  q, k, v,
// o, dout, dq, dk, dv are [B, S, heads*D] bf16, row-major, 16-byte aligned;
// lse and delta [B, heads, S] fp32; D is 64 or 72.

#include "common.cuh"

namespace {

// One warp's [16, 64] product of two 16-row operand slices: acc = A B^T
// over d, A's rows from `a` and B's rows from `b` (tiles T_LD apart), stored
// row-major into the warp's fp32 scratch.
template <int HD>
__device__ __forceinline__ void rows_dot_rows(float* scratch, const bf16* a, const bf16* b) {
  using T = AttnTile<HD>;
#pragma unroll
  for (int j = 0; j < AKV / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int d = 0; d < T::HDP / 16; ++d) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a + d * 16, T::T_LD);
      wmma::load_matrix_sync(bf, b + j * 16 * T::T_LD + d * 16, T::T_LD);
      wmma::mma_sync(sf, af, bf, sf);
    }
    wmma::store_matrix_sync(scratch + j * 16, sf, T::S_LD, wmma::mem_row_major);
  }
}

// acc[j] += P [16, 64] (bf16, the warp's P_LD tile) @ X [64, HDP] (a tile)
template <int HD>
__device__ __forceinline__ void p_times_tile(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* p,
    const bf16* x) {
  using T = AttnTile<HD>;
#pragma unroll
  for (int j = 0; j < T::HDP / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < AKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> xf;
      wmma::load_matrix_sync(pf, p + kk * 16, P_LD);
      wmma::load_matrix_sync(xf, x + kk * 16 * T::T_LD + j * 16, T::T_LD);
      wmma::mma_sync(acc[j], pf, xf, acc[j]);
    }
  }
}

// The warp's 16 accumulated rows -> dst rows (row r0 + warp*16 + i, while
// < S), columns [0, HD), through the warp's fp32 scratch.
template <int HD>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* scratch,
    bf16* dst, int r0, int S, size_t ld, int lane) {
  using T = AttnTile<HD>;
#pragma unroll
  for (int j = 0; j < T::HDP / 16; ++j)
    wmma::store_matrix_sync(scratch + j * 16, acc[j], T::S_LD, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, half = lane & 1;
  if (r0 + row < S) {
    const float* src = scratch + row * T::S_LD + half * T::HALF;
    bf16* out = dst + (r0 + row) * ld + half * T::HALF;
#pragma unroll
    for (int c = 0; c < T::HALF; c += 8)
      if (half * T::HALF + c < HD) store8(out + c, src + c);
  }
}

template <int HD>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int S,
                        int heads, float scale) {
  using T = AttnTile<HD>;
  constexpr int HDP = T::HDP, T_LD = T::T_LD, S_LD = T::S_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + T::TILE;
  bf16* Ks = dOs + T::TILE;
  bf16* Vs = Ks + T::TILE;
  float* Ss = reinterpret_cast<float*>(Vs + T::TILE);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * S_LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const size_t W = static_cast<size_t>(heads) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * W + h * HD;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * S;
  Ss += warp * 16 * S_LD;
  Ps += warp * 16 * P_LD;

  zero_pad_columns<HD>(Qs, tid);
  zero_pad_columns<HD>(dOs, tid);
  zero_pad_columns<HD>(Ks, tid);
  zero_pad_columns<HD>(Vs, tid);
  load_tile<HD>(Qs, q + head_off, q0, S, W, tid);
  load_tile<HD>(dOs, dout + head_off, q0, S, W, tid);
  __syncthreads();

  // the row term of this lane's row (a lane pair shares it, interleaving the
  // row's 8-column vectors), kept in a register and stored for the dk/dv pass
  const int row = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + row;
  const bool q_ok = qi < S;
  float d_row = 0.f, lse_row = 0.f;
  if (q_ok) {
    const bf16* orow = o + head_off + qi * W;
    const bf16* grow = dOs + (warp * 16 + row) * T_LD;
    float ov[8], gv[8];
    for (int c = half * 8; c < HD; c += 16) {
      load8(orow + c, ov);
      load8(grow + c, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) d_row += ov[j] * gv[j];
    }
    lse_row = lse[bh + qi];
  }
  d_row += __shfl_xor_sync(0xffffffffu, d_row, 1);
  if (q_ok && half == 0) delta[bh + qi] = d_row;
  if (dq == nullptr) return;  // only the row term was asked for

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HDP / 16];
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  const bf16* q_w = Qs + warp * 16 * T_LD;
  const bf16* g_w = dOs + warp * 16 * T_LD;
  const float* srow = Ss + row * S_LD + half * (AKV / 2);
  bf16* prow = Ps + row * P_LD + half * (AKV / 2);

  const int n_tiles = (S + AKV - 1) / AKV;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * AKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD>(Ks, k + head_off, k0, S, W, tid);
    load_tile<HD>(Vs, v + head_off, k0, S, W, tid);
    __syncthreads();

    rows_dot_rows<HD>(Ss, q_w, Ks);  // S = q k^T
    __syncwarp();
    float p[AKV / 2];
#pragma unroll
    for (int c = 0; c < AKV / 2; ++c) {
      const bool ok = q_ok && k0 + half * (AKV / 2) + c < S;
      p[c] = ok ? expf(srow[c] * scale - lse_row) : 0.f;
    }
    __syncwarp();
    rows_dot_rows<HD>(Ss, g_w, Vs);  // dP = dO v^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < AKV / 2; ++c)
      prow[c] = __float2bfloat16(p[c] * (srow[c] - d_row) * scale);
    __syncwarp();
    p_times_tile<HD>(acc, Ps, Ks);  // dQ += dS k
  }
  __syncwarp();
  store_rows<HD>(acc, Ss, dq + head_off, q0 + warp * 16, S, W, lane);
}

template <int HD>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int heads,
                          float scale) {
  using T = AttnTile<HD>;
  constexpr int HDP = T::HDP, T_LD = T::T_LD, S_LD = T::S_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T::TILE;
  bf16* Qs = Vs + T::TILE;
  bf16* dOs = Qs + T::TILE;
  float* lse_s = reinterpret_cast<float*>(dOs + T::TILE);
  float* delta_s = lse_s + AQ;
  float* Ss = delta_s + AQ;
  bf16* Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * S_LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * AKV, h = blockIdx.y, b = blockIdx.z;
  const size_t W = static_cast<size_t>(heads) * HD;
  const size_t head_off = static_cast<size_t>(b) * S * W + h * HD;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * S;
  Ss += warp * 16 * S_LD;
  Ps += warp * 16 * P_LD;

  zero_pad_columns<HD>(Ks, tid);
  zero_pad_columns<HD>(Vs, tid);
  zero_pad_columns<HD>(Qs, tid);
  zero_pad_columns<HD>(dOs, tid);
  load_tile<HD>(Ks, k + head_off, k0, S, W, tid);
  load_tile<HD>(Vs, v + head_off, k0, S, W, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HDP / 16], dv_acc[HDP / 16];
#pragma unroll
  for (int j = 0; j < HDP / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }
  const int row = lane >> 1, half = lane & 1;
  const bool key_ok = k0 + warp * 16 + row < S;
  const bf16* k_w = Ks + warp * 16 * T_LD;
  const bf16* v_w = Vs + warp * 16 * T_LD;
  const float* srow = Ss + row * S_LD + half * (AQ / 2);
  bf16* prow = Ps + row * P_LD + half * (AQ / 2);

  const int n_tiles = (S + AQ - 1) / AQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * AQ;
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile<HD>(Qs, q + head_off, q0, S, W, tid);
    load_tile<HD>(dOs, dout + head_off, q0, S, W, tid);
    for (int r = tid; r < AQ; r += ATT_THREADS) {
      const bool ok = q0 + r < S;  // past S: p = exp(-inf) = 0, no row term
      lse_s[r] = ok ? lse[bh + q0 + r] : __int_as_float(0x7f800000);  // +inf
      delta_s[r] = ok ? delta[bh + q0 + r] : 0.f;
    }
    __syncthreads();

    rows_dot_rows<HD>(Ss, k_w, Qs);  // S^T = k q^T: this warp's keys x 64 queries
    __syncwarp();
    float p[AQ / 2];
#pragma unroll
    for (int c = 0; c < AQ / 2; ++c) {
      const int qc = half * (AQ / 2) + c;
      p[c] = key_ok ? expf(srow[c] * scale - lse_s[qc]) : 0.f;
      prow[c] = __float2bfloat16(p[c]);
    }
    __syncwarp();
    p_times_tile<HD>(dv_acc, Ps, dOs);  // dV += bf16(P)^T dO
    rows_dot_rows<HD>(Ss, v_w, dOs);    // dP^T = v dO^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < AQ / 2; ++c) {
      const int qc = half * (AQ / 2) + c;
      prow[c] = __float2bfloat16(p[c] * (srow[c] - delta_s[qc]) * scale);
    }
    __syncwarp();
    p_times_tile<HD>(dk_acc, Ps, Qs);  // dK += dS^T q
  }
  __syncwarp();
  store_rows<HD>(dk_acc, Ss, dk + head_off, k0 + warp * 16, S, W, lane);
  __syncwarp();
  store_rows<HD>(dv_acc, Ss, dv + head_off, k0 + warp * 16, S, W, lane);
}

template <int HD>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
               const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
               bf16* dv, int B, int S, int heads, float scale, cudaStream_t stream) {
  using T = AttnTile<HD>;
  constexpr int dq_smem = 4 * T::TILE * 2 + T::SCRATCH;
  constexpr int dkdv_smem = 4 * T::TILE * 2 + 2 * AQ * 4 + T::SCRATCH;
  const dim3 grid((S + AQ - 1) / AQ, heads, B);
  auto dq_kernel = attention_bwd_dq_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<grid, ATT_THREADS, dq_smem, stream>>>(q, k, v, o, dout, lse, delta, dq, S,
                                                    heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || dk == nullptr) return static_cast<int>(err);
  auto dkdv_kernel = attention_bwd_dkdv_kernel<HD>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<grid, ATT_THREADS, dkdv_smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                                        S, heads, scale);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
