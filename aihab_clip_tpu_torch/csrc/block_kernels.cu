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
// H100 SXM).  The design answer here is a simple one that is right: bf16
// tensor cores through WMMA (mma.sync 16x16x16, fp32 accumulation), 128x128
// GEMM tiles with the weight tile in a 3-stage cp.async ring and the A tile
// (LN applied) prefetched through registers, capped at 128 registers so two
// GEMM blocks share an SM; no wgmma and no TMA.  The measured gap to the
// bound is in PERF.md; closing it is later work.
//
// At SigLIP SO400M (S=576, W=1152, 16 heads of 72, hidden 4304) the same
// kernels run at other widths: head_dim 72 is a template instance of the
// attention kernel with its contraction zero-padded to 80, and the 2152-wide
// MLP chunks take the GEMM's ragged N and K edges.
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
// head_dim 64 or 72.  The qkv layout is grouped: head h of group h / g sits at
// columns (h / g) * 3gD + {0, gD, 2gD} + (h % g) * D for q, k and v, which
// with g = heads is the packed q | k | v of CLIP's in_proj.  The q-scale
// epilogue multiplies columns n with n % group_cols < q_cols by q_scale.

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// LN statistics: stats[r] = (mean, rsqrt(var + eps)) of row r, two-pass fp32
// (block_kernel.py:33), one warp per row.  A pre-pass of ln_gemm, so the
// GEMM's blocks do not each re-read their rows to normalise them.
// ---------------------------------------------------------------------------

constexpr int STATS_THREADS = 256;

template <typename TA>
__global__ void __launch_bounds__(STATS_THREADS)
ln_stats_kernel(const TA* __restrict__ A, float2* __restrict__ stats, int M, int K,
                float eps) {
  const int r = blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= M) return;
  const TA* row = A + static_cast<size_t>(r) * K;
  float v[8], s = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    load8(row + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    load8(row + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) q += (v[j] - mean) * (v[j] - mean);
  }
  q = warp_sum(q);
  if (lane == 0) stats[r] = make_float2(mean, rsqrtf(q / K + eps));
}

// ---------------------------------------------------------------------------
// GEMM: Y[M,N] = epilogue(prologue(A)[M,K] @ W[K,N] + bias), W's rows ldw apart
//   prologue (LN):  A -> (A - mean) * rstd * ln_s + ln_b per row, cast to bf16
//   epilogue:       act(...), * q_scale on the q columns, * gamma[n] (a
//                   per-column scale, when gamma is non-null), then + R (RES)
//                   in fp32, stored as TO
//   EPI_PRE:        also store the pre-activation acc + bias, as bf16, to Y2
//                   (K17's forward: h_pre for the backward)
//   EPI_DGELU:      Y = acc * quick_gelu'(R) with R the bf16 pre-activation
//                   (K17's backward: dh_pre); no bias, act or residual
// Block tile 128x128, k-step 32, 8 warps of 64x32 (4x2 WMMA fragments).
// The weight tile streams through a 3-stage cp.async ring; the A tile is
// read into registers one k-step before it is needed and normalised into
// shared memory after that step's products, so both loads overlap compute.
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, GEMM_THREADS = 256;
constexpr int A_LD = BK + 8;  // bf16 elements; the pad staggers banks
constexpr int B_LD = BN + 8;
constexpr int E_LD = 16 + 4;  // fp32 epilogue scratch, one fragment per warp
constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;
constexpr int A_VECS = BM * BK / 8 / GEMM_THREADS;  // 8-element vectors per thread
constexpr int B_VECS = BK * BN / 8 / GEMM_THREADS;
static_assert(GEMM_THREADS % (BK / 8) == 0, "a thread keeps one A column slice");
constexpr int GEMM_SMEM = STAGES * (A_STAGE + B_STAGE) * 2 +
                          (GEMM_THREADS / 32) * 16 * E_LD * 4 + BM * 8;

enum Epi { EPI_STD = 0, EPI_PRE = 1, EPI_DGELU = 2 };

// d/dh of h * sigmoid(1.702 h) (block_kernel.py:_quick_gelu_grad_f32)
__device__ __forceinline__ float quick_gelu_grad(float h) {
  const float s = 1.0f / (1.0f + expf(-1.702f * h));
  return s * (1.0f + 1.702f * h * (1.0f - s));
}

template <typename TA, bool LN, bool RES, typename TR, typename TO, int EPI = EPI_STD>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const TA* __restrict__ A, const float2* __restrict__ stats,
            const float* __restrict__ ln_s, const float* __restrict__ ln_b,
            const bf16* __restrict__ W, const float* __restrict__ bias,
            const float* __restrict__ gamma, const TR* __restrict__ R,
            TO* __restrict__ Y, bf16* __restrict__ Y2, int M, int N, int K,
            int ldw, int act, float q_scale, int q_cols, int group_cols) {
  constexpr bool RAW_A = !LN && std::is_same<TA, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* Es = reinterpret_cast<float*>(Bs + STAGES * B_STAGE);
  float2* row_stats = reinterpret_cast<float2*>(Es + (GEMM_THREADS / 32) * 16 * E_LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if constexpr (LN) {
    for (int r = tid; r < BM; r += GEMM_THREADS)
      row_stats[r] = m0 + r < M ? stats[m0 + r] : make_float2(0.f, 0.f);
    __syncthreads();
  }

  uint4 araw[A_VECS];
  float aval[A_VECS][8];
  auto load_a = [&](int kt) {  // global -> registers
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS;
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gr = m0 + r, gk = kt * BK + c;
      const bool ok = gr < M && gk < K;
      const TA* src = A + static_cast<size_t>(gr) * K + gk;
      if constexpr (RAW_A) {
        araw[i] = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        if (ok) {
          load8(src, aval[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) aval[i][j] = 0.f;
        }
      }
    }
  };
  auto store_a = [&](int kt, int stage) {  // registers -> shared, LN applied
    // a thread's column slice c is the same for all its vectors and k-steps
    const int c = (tid % (BK / 8)) * 8, gk = kt * BK + c;
    float g[8], be[8];
    if constexpr (LN) {
      if (gk < K) {
        load8(ln_s + gk, g);
        load8(ln_b + gk, be);
      }
    }
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int r = (tid + i * GEMM_THREADS) / (BK / 8);
      bf16* dst = As + stage * A_STAGE + r * A_LD + c;
      if constexpr (RAW_A) {
        *reinterpret_cast<uint4*>(dst) = araw[i];
      } else {
        if constexpr (LN) {
          if (m0 + r < M && gk < K) {  // padding stays zero
            const float2 st = row_stats[r];
#pragma unroll
            for (int j = 0; j < 8; ++j) aval[i][j] = (aval[i][j] - st.x) * st.y * g[j] + be[j];
          }
        }
        store8(dst, aval[i]);
      }
    }
  };
  auto load_b = [&](int kt, int stage) {  // global -> shared, asynchronous
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS;
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const int gk = kt * BK + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(Bs + stage * B_STAGE + r * B_LD + c,
                 ok ? W + static_cast<size_t>(gk) * ldw + gn : W, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_a(s);
      store_a(s, s);
      load_b(s, s);
    }
    cp_async_commit();
  }
  if (STAGES - 1 < nk) load_a(STAGES - 1);

  const int wm = warp >> 2, wn = warp & 3;  // warp tile rows wm*64, cols wn*32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in shared memory; stage (kt-1) % STAGES is free
    const int nt = kt + STAGES - 1;
    if (nt < nk) load_b(nt, nt % STAGES);
    cp_async_commit();
    const bf16* a_s = As + (kt % STAGES) * A_STAGE + wm * 64 * A_LD;
    const bf16* b_s = Bs + (kt % STAGES) * B_STAGE + wn * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], a_s + i * 16 * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], b_s + kk * B_LD + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (nt < nk) {
      store_a(nt, nt % STAGES);
      if (nt + 1 < nk) load_a(nt + 1);
    }
  }

  // epilogue, one 16x16 fragment at a time through the warp's scratch:
  // lane -> row lane/2, columns (lane%2)*8 .. +8
  float* es = Es + warp * 16 * E_LD;
  const int er = lane >> 1, ec = (lane & 1) * 8;
  // a lane's two 8-column vectors (j = 0, 1) are the same for every i, and
  // an 8-column vector never straddles a q block: test each once, here
  bool qcol[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    qcol[j] = q_cols > 0 && (n0 + wn * 32 + j * 16 + ec) % group_cols < q_cols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(es, acc[i][j], E_LD, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + er, gn = n0 + wn * 32 + j * 16 + ec;
      if (gr < M && gn < N) {
        float out[8];
        if constexpr (EPI == EPI_DGELU) {
          float hp[8];
          load8(R + static_cast<size_t>(gr) * N + gn, hp);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            out[jj] = es[er * E_LD + ec + jj] * quick_gelu_grad(hp[jj]);
        } else {
          if (bias) {
            load8(bias + gn, out);
          } else {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) out[jj] = 0.f;
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) out[jj] += es[er * E_LD + ec + jj];
          if constexpr (EPI == EPI_PRE) store8(Y2 + static_cast<size_t>(gr) * N + gn, out);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) out[jj] = act_f32(out[jj], act);
          if (qcol[j]) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) out[jj] *= q_scale;
          }
          if (gamma) {
            float g[8];
            load8(gamma + gn, g);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) out[jj] *= g[jj];
          }
          if constexpr (RES) {
            float res[8];
            load8(R + static_cast<size_t>(gr) * N + gn, res);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) out[jj] += res[jj];
          }
        }
        store8(Y + static_cast<size_t>(gr) * N + gn, out);
      }
      __syncwarp();
    }
  }
}

template <typename TA, bool LN, bool RES, typename TR, typename TO, int EPI = EPI_STD>
int launch_gemm(const void* a, const float2* stats, const float* ln_s, const float* ln_b,
                const void* w, const float* bias, const float* gamma, const void* r,
                void* y, int M, int N, int K, int ldw, int act, float q_scale, int q_cols,
                int group_cols, cudaStream_t stream, void* y2 = nullptr) {
  auto kernel = gemm_kernel<TA, LN, RES, TR, TO, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      static_cast<const TA*>(a), stats, ln_s, ln_b, static_cast<const bf16*>(w), bias, gamma,
      static_cast<const TR*>(r), static_cast<TO*>(y), static_cast<bf16*>(y2), M, N, K, ldw,
      act, q_scale, q_cols, group_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TO, int EPI = EPI_STD>
int launch_ln_gemm(const void* x, float2* stats, const float* ln_s, const float* ln_b,
                   const void* w, const float* bias, void* y, int M, int N, int K,
                   int ldw, int act, float eps, float q_scale, int q_cols,
                   int group_cols, cudaStream_t stream, void* y2 = nullptr) {
  const int rows_per_block = STATS_THREADS / 32;
  ln_stats_kernel<TA><<<(M + rows_per_block - 1) / rows_per_block, STATS_THREADS, 0,
                        stream>>>(static_cast<const TA*>(x), stats, M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm<TA, true, false, bf16, TO, EPI>(x, stats, ln_s, ln_b, w, bias, nullptr,
                                                     nullptr, y, M, N, K, ldw, act, q_scale,
                                                     q_cols, group_cols, stream, y2);
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
// Attention: out[b, q, h*D:(h+1)*D] = softmax(scale * q k^T, keys < seq_len) v
// One block per (64-query tile, head, image); 4 warps of 16 query rows.  Keys
// stream through shared memory 64 at a time with an fp32 online softmax, so
// no [S, S] tensor exists anywhere; P is cast to bf16 before the PV product
// (block_kernel.py:993-998, :815) and the 1/sum is applied to the output rows.
// Each lane owns one query row's half (HDP/2 output dims) in registers.  D=64
// is the instance CLIP runs (HDP = D), D=72 SigLIP's (tiles 80 wide).  The
// output is bf16, or fp32 (TO) for the int8 blocks of quant_kernels.cu (K12,
// K13, K14).  NORM_P (fp32 only; K12 and K14) follows their TPU kernels'
// rounding points (quant_matmul.py:472-478): a first pass over the keys takes
// the row max m and sum l, and the second casts P = exp(s - m) / l to bf16
// before the PV product, whose sum is the output unscaled.  The int8
// requantize that reads this output turns a difference in P's rounding into
// code flips, which K14's next requantizes multiply (at ViT-B/16: 6.8e-3 rel
// L2 against its plain version with the 1/sum on the output rows, 2.0e-3
// with NORM_P).  The first pass recomputes q k^T: K13 keeps the one-pass form
// (its attention at SO400M: 1.58 ms, 2.36 ms with NORM_P).
// Operands: q, k and v of head h start at column (h / g) * group_stride +
// (h % g) * D of rows `ld` apart, image b S rows further on.  The qkv buffer
// of the block kernels (grouped layout above) is q = qkv, k = qkv + gD,
// v = qkv + 2gD, ld = 3W, group_stride = 3gD; fused_attention's separate
// [B, S, W] tensors (ops/attention.py:91, K6) are ld = W, g = heads.
// scale is 1/sqrt(D) on the fp32 scores (CLIP, K6) or 1 when ln_gemm's
// epilogue has already scaled q before rounding it, as attn_block_split does.
// With lse non-null each valid row also stores its fp32 log-sum-exp
// m + log(l) (of the scaled scores) at lse[(b * heads + h) * S + q], which
// the backward kernels (fused_attention_bwd.cu) rebuild P from.
// ---------------------------------------------------------------------------

template <int HD, typename TO, bool NORM_P>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, TO* __restrict__ out,
                 float* __restrict__ lse, int S, int seq_len, int heads,
                 int group_heads, int ld, int group_stride, float scale) {
  using T = AttnTile<HD>;
  constexpr int HDP = T::HDP, T_LD = T::T_LD, S_LD = T::S_LD, HALF = T::HALF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T::TILE;
  bf16* Vs = Ks + T::TILE;
  float* Ss_all = reinterpret_cast<float*>(Vs + T::TILE);
  bf16* Ps_all = reinterpret_cast<bf16*>(Ss_all + 4 * 16 * S_LD);

  static_assert(!NORM_P || std::is_same<TO, float>::value, "NORM_P is fp32 only");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int W = heads * HD;
  const size_t head_off = static_cast<size_t>(b) * S * ld +
                          (h / group_heads) * group_stride + (h % group_heads) * HD;
  const bf16* qb = qp + head_off;
  const bf16* kb = kp + head_off;
  const bf16* vb = vp + head_off;
  float* Ss = Ss_all + warp * 16 * S_LD;
  bf16* Ps = Ps_all + warp * 16 * P_LD;

  zero_pad_columns<HD>(Qs, tid);
  zero_pad_columns<HD>(Ks, tid);
  zero_pad_columns<HD>(Vs, tid);
  load_tile<HD>(Qs, qb, q0, S, ld, tid);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HDP / 16];
#pragma unroll
  for (int d = 0; d < HDP / 16; ++d)
    wmma::load_matrix_sync(qf[d], Qs + warp * 16 * T_LD + d * 16, T_LD);

  const int row = lane >> 1, half = lane & 1;
  float o[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) o[c] = 0.f;
  float m_run = -1e30f, l_run = 0.f;
  float* srow = Ss + row * S_LD + half * (AKV / 2);  // this lane's score columns
  float* orow = Ss + row * S_LD + half * HALF;       // this lane's PV columns
  bf16* prow = Ps + row * P_LD + half * (AKV / 2);

  // the scaled, masked scores of the K tile at key k0 (in shared memory) for
  // this lane's columns into sv; returns the row's max over the tile
  auto tile_scores = [&](int k0, float* sv) {
#pragma unroll
    for (int j = 0; j < AKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int d = 0; d < HDP / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * T_LD + d * 16, T_LD);
        wmma::mma_sync(sf, qf[d], kf, sf);
      }
      wmma::store_matrix_sync(Ss + j * 16, sf, S_LD, wmma::mem_row_major);
    }
    __syncwarp();
    float mx = -1e30f;
#pragma unroll
    for (int c = 0; c < AKV / 2; ++c) {
      const float s = (k0 + half * (AKV / 2) + c < seq_len) ? srow[c] * scale : -1e30f;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  };
  // the online update of the row max m_run and sum l_run by one tile; returns
  // the factor that rescales what was summed before it
  auto online = [&](const float* sv, float mx) {
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < AKV / 2; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      if constexpr (!NORM_P) prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    return alpha;
  };

  const int n_tiles = (seq_len + AKV - 1) / AKV;
  if constexpr (NORM_P) {  // first pass: the row max and sum over every key
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();  // every warp is done with the previous K tile
      load_tile<HD>(Ks, kb, t * AKV, seq_len, ld, tid);
      __syncthreads();
      float sv[AKV / 2];
      online(sv, tile_scores(t * AKV, sv));
      __syncwarp();
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * AKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD>(Ks, kb, k0, seq_len, ld, tid);  // masked keys load as zeros
    load_tile<HD>(Vs, vb, k0, seq_len, ld, tid);
    __syncthreads();

    float sv[AKV / 2];
    const float mx = tile_scores(k0, sv);
    float alpha = 1.f;
    if constexpr (NORM_P) {
#pragma unroll
      for (int c = 0; c < AKV / 2; ++c)
        prow[c] = __float2bfloat16(__fdiv_rn(expf(sv[c] - m_run), l_run));
    } else {
      alpha = online(sv, mx);
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < AKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + kk * 16, P_LD);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * T_LD + j * 16, T_LD);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Ss + j * 16, of, S_LD, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < HALF; ++c) o[c] = o[c] * alpha + orow[c];
    __syncwarp();
  }

  const int q = q0 + warp * 16 + row;
  if (q < S) {
    const float inv = NORM_P ? 1.f : 1.f / l_run;
#pragma unroll
    for (int c = 0; c < HALF; ++c) o[c] *= inv;
    TO* dst = out + (static_cast<size_t>(b) * S + q) * W + h * HD + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 8)
      if (half * HALF + c < HD) store8(dst + c, o + c);
    if (lse != nullptr && half == 0)
      lse[(static_cast<size_t>(b) * heads + h) * S + q] = m_run + logf(l_run);
  }
}

template <int HD, typename TO, bool NORM_P>
int launch_attention(const bf16* q, const bf16* k, const bf16* v, void* out, float* lse,
                     int B, int S, int seq_len, int heads, int group_heads, int ld,
                     int group_stride, float scale, cudaStream_t stream) {
  auto kernel = attention_kernel<HD, TO, NORM_P>;
  constexpr int smem = 3 * AttnTile<HD>::TILE * 2 + AttnTile<HD>::SCRATCH;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + AQ - 1) / AQ, heads, B);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(q, k, v, static_cast<TO*>(out), lse, S,
                                              seq_len, heads, group_heads, ld,
                                              group_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO, bool NORM_P = false>
int attention_dispatch(const bf16* q, const bf16* k, const bf16* v, void* out, float* lse,
                       int B, int S, int seq_len, int heads, int group_heads, int head_dim,
                       int ld, int group_stride, float scale, cudaStream_t stream) {
  if (head_dim == 64)
    return launch_attention<64, TO, NORM_P>(q, k, v, out, lse, B, S, seq_len, heads, group_heads,
                                    ld, group_stride, scale, stream);
  if (head_dim == 72)
    return launch_attention<72, TO, NORM_P>(q, k, v, out, lse, B, S, seq_len, heads, group_heads,
                                    ld, group_stride, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y[M,N] (bf16, or fp32 with y_is_f32) = act(LN(x)[M,K] @ w[K,N] + bias),
// times q_scale on the columns n with n % group_cols < q_cols; x is bf16 or
// fp32; w's rows are ldw apart; stats is an [M] float2 scratch for the row
// statistics.
int aihab_ln_gemm(const void* x, int x_is_f32, const float* ln_s, const float* ln_b,
                  const void* w, int ldw, const float* bias, void* y, int y_is_f32,
                  void* stats, int M, int N, int K, int act, float eps, float q_scale,
                  int q_cols, int group_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  if (act > ACT_GELU_SIG5) return static_cast<int>(cudaErrorInvalidValue);  // act_pass's
  if (x_is_f32 && y_is_f32)
    return launch_ln_gemm<float, float>(x, st, ln_s, ln_b, w, bias, y, M, N, K, ldw, act,
                                        eps, q_scale, q_cols, group_cols, s);
  if (x_is_f32)
    return launch_ln_gemm<float, bf16>(x, st, ln_s, ln_b, w, bias, y, M, N, K, ldw, act,
                                       eps, q_scale, q_cols, group_cols, s);
  if (y_is_f32)
    return launch_ln_gemm<bf16, float>(x, st, ln_s, ln_b, w, bias, y, M, N, K, ldw, act,
                                       eps, q_scale, q_cols, group_cols, s);
  return launch_ln_gemm<bf16, bf16>(x, st, ln_s, ln_b, w, bias, y, M, N, K, ldw, act, eps,
                                    q_scale, q_cols, group_cols, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_is_f32 && y_is_f32)
    return launch_gemm<bf16, false, true, float, float>(
        a, nullptr, nullptr, nullptr, w, bias, gamma, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0,
        1, s);
  if (r_is_f32)
    return launch_gemm<bf16, false, true, float, bf16>(
        a, nullptr, nullptr, nullptr, w, bias, gamma, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0,
        1, s);
  if (y_is_f32)
    return launch_gemm<bf16, false, true, bf16, float>(
        a, nullptr, nullptr, nullptr, w, bias, gamma, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0,
        1, s);
  return launch_gemm<bf16, false, true, bf16, bf16>(
      a, nullptr, nullptr, nullptr, w, bias, gamma, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0, 1,
      s);
}

// K17's forward: h_pre = LN(x) @ w_fc + b_fc (bf16), h = quick_gelu of the
// same fp32 value (bf16), y = h @ w_proj + b_proj + x (bf16); x [M,W] bf16,
// w_fc [W,H] and w_proj [H,W] bf16 row-major, LN eps 1e-5 (the TPU kernel's);
// h [M,H] and stats [M] float2 are scratch.
int aihab_mlp_train_fwd(const void* x, const float* ln_s, const float* ln_b, const void* w_fc,
                        const float* b_fc, const void* w_proj, const float* b_proj, void* y,
                        void* h_pre, void* h, void* stats, int M, int W, int H, float eps,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_ln_gemm<bf16, bf16, EPI_PRE>(
      x, static_cast<float2*>(stats), ln_s, ln_b, w_fc, b_fc, h, M, H, W, H, ACT_QUICK_GELU,
      eps, 1.f, 0, 1, s, h_pre);
  if (err != 0) return err;
  return launch_gemm<bf16, false, true, bf16, bf16>(h, nullptr, nullptr, nullptr, w_proj, b_proj,
                                                    nullptr, x, y, M, W, H, W, ACT_NONE, 1.f, 0,
                                                    1, s);
}

// K17's backward dx chain: dh_pre = (dy @ w_proj_t) * quick_gelu'(h_pre),
// dln = dh_pre @ w_fc_t (fp32 scratch [M,W]), dx = dy + LN_bwd(dln; x, ln_s)
// and dln16 = dln in bf16.  w_proj_t [W,H] and w_fc_t [H,W] row-major bf16
// (torch's c_proj.weight and c_fc.weight); x, dy [M,W], h_pre [M,H] bf16.
int aihab_mlp_train_bwd(const void* x, const void* h_pre, const void* dy, const float* ln_s,
                        const void* w_fc_t, const void* w_proj_t, void* dx, void* dh_pre,
                        void* dln, void* dln16, int M, int W, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_gemm<bf16, false, false, bf16, bf16, EPI_DGELU>(
      dy, nullptr, nullptr, nullptr, w_proj_t, nullptr, nullptr, h_pre, dh_pre, M, H, W, H,
      ACT_NONE, 1.f, 0, 1, s);
  if (err != 0) return err;
  err = launch_gemm<bf16, false, false, bf16, float>(dh_pre, nullptr, nullptr, nullptr, w_fc_t,
                                                     nullptr, nullptr, nullptr, dln, M, W, H, W,
                                                     ACT_NONE, 1.f, 0, 1, s);
  if (err != 0) return err;
  const int rows_per_block = STATS_THREADS / 32;
  ln_bwd_kernel<<<(M + rows_per_block - 1) / rows_per_block, STATS_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const float*>(dln),
      ln_s, static_cast<bf16*>(dx), static_cast<bf16*>(dln16), M, W, eps);
  return static_cast<int>(cudaGetLastError());
}

// out[B,S,heads*D] (bf16, or fp32 with out_f32) = masked multi-head attention
// over qkv[B,S,3*heads*D] in the grouped layout (group_heads heads per group);
// D is 64 or 72.  The fp32 output is the int8 blocks' (K12, K13, K14), whose
// requantize reads the PV product unrounded, as the TPU kernels do; norm_p
// (fp32 only) normalises P before its bf16 cast, as they do.
int aihab_attention(const void* qkv, void* out, int B, int S, int seq_len, int heads,
                    int group_heads, int head_dim, float scale, int out_f32, int norm_p,
                    void* stream) {
  const bf16* base = static_cast<const bf16*>(qkv);
  const int gw = group_heads * head_dim;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (norm_p && !out_f32) return static_cast<int>(cudaErrorInvalidValue);
  if (norm_p)
    return attention_dispatch<float, true>(base, base + gw, base + 2 * gw, out, nullptr, B,
                                           S, seq_len, heads, group_heads, head_dim,
                                           3 * heads * head_dim, 3 * gw, scale, s);
  if (out_f32)
    return attention_dispatch<float>(base, base + gw, base + 2 * gw, out, nullptr, B, S,
                                     seq_len, heads, group_heads, head_dim,
                                     3 * heads * head_dim, 3 * gw, scale, s);
  return attention_dispatch<bf16>(base, base + gw, base + 2 * gw, out, nullptr, B, S,
                                  seq_len, heads, group_heads, head_dim,
                                  3 * heads * head_dim, 3 * gw, scale, s);
}

// fused_attention's forward (K6): out = softmax(scale * q k^T) v over
// separate q, k, v [B,S,heads*D] bf16 (heads packed in the last dim), and the
// fp32 row log-sum-exp lse[B,heads,S] when lse is non-null; D is 64 or 72.
int aihab_fused_attention_fwd(const void* q, const void* k, const void* v, void* out,
                              void* lse, int B, int S, int heads, int head_dim, float scale,
                              void* stream) {
  return attention_dispatch<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                  static_cast<const bf16*>(v), out, static_cast<float*>(lse),
                                  B, S, S, heads, heads, head_dim, heads * head_dim, 0, scale,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
