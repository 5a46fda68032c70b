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
//       x's dtype (or fp32) as the TPU kernel stores it between chunks.
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
// Interface: plain C functions, loaded with ctypes.  Each launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
// Preconditions the Python wrappers check: K and N multiples of 8, every
// pointer 16-byte aligned, row-major tensors (a weight may be a column slice
// of a wider matrix: its row stride ldw, a multiple of 8, is an argument),
// head_dim 64 or 72.  The qkv layout is grouped: head h of group h / g sits at
// columns (h / g) * 3gD + {0, gD, 2gD} + (h % g) * D for q, k and v, which
// with g = heads is the packed q | k | v of CLIP's in_proj.  The q-scale
// epilogue multiplies columns n with n % group_cols < q_cols by q_scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

enum Act { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU_TANH = 2, ACT_GELU_POLY = 3 };

// The activations of block_kernel.py::_act_f32, in fp32.
__device__ __forceinline__ float act_f32(float h, int act) {
  if (act == ACT_QUICK_GELU) return h / (1.0f + expf(-1.702f * h));
  if (act == ACT_GELU_TANH) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.0f + tanhf(k * (h + 0.044715f * h * h * h)));
  }
  if (act == ACT_GELU_POLY) {
    // exact GELU as h * sigmoid(odd deg-5 poly), block_kernel.py:450
    const float hc = fminf(fmaxf(h, -7.5f), 7.5f);
    const float u = hc * hc;
    const float f = hc * (1.5953873f + u * (0.07364605f + u * -6.3791875e-4f));
    return h / (1.0f + expf(-f));
  }
  return h;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[j]);  // round to nearest even
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
//   epilogue:       act(...), * q_scale on the q columns, then + R (RES) in
//                   fp32, stored as TO
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));  // src-size 0 writes zeros
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename TA, bool LN, bool RES, typename TR, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const TA* __restrict__ A, const float2* __restrict__ stats,
            const float* __restrict__ ln_s, const float* __restrict__ ln_b,
            const bf16* __restrict__ W, const float* __restrict__ bias,
            const TR* __restrict__ R, TO* __restrict__ Y, int M, int N, int K,
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
        if (bias) {
          load8(bias + gn, out);
        } else {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) out[jj] = 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) out[jj] = act_f32(es[er * E_LD + ec + jj] + out[jj], act);
        if (qcol[j]) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) out[jj] *= q_scale;
        }
        if constexpr (RES) {
          float res[8];
          load8(R + static_cast<size_t>(gr) * N + gn, res);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) out[jj] += res[jj];
        }
        store8(Y + static_cast<size_t>(gr) * N + gn, out);
      }
      __syncwarp();
    }
  }
}

template <typename TA, bool LN, bool RES, typename TR, typename TO>
int launch_gemm(const void* a, const float2* stats, const float* ln_s, const float* ln_b,
                const void* w, const float* bias, const void* r, void* y, int M, int N,
                int K, int ldw, int act, float q_scale, int q_cols, int group_cols,
                cudaStream_t stream) {
  auto kernel = gemm_kernel<TA, LN, RES, TR, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      static_cast<const TA*>(a), stats, ln_s, ln_b, static_cast<const bf16*>(w), bias,
      static_cast<const TR*>(r), static_cast<TO*>(y), M, N, K, ldw, act, q_scale, q_cols,
      group_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA>
int launch_ln_gemm(const void* x, float2* stats, const float* ln_s, const float* ln_b,
                   const void* w, const float* bias, void* y, int M, int N, int K,
                   int ldw, int act, float eps, float q_scale, int q_cols,
                   int group_cols, cudaStream_t stream) {
  const int rows_per_block = STATS_THREADS / 32;
  ln_stats_kernel<TA><<<(M + rows_per_block - 1) / rows_per_block, STATS_THREADS, 0,
                        stream>>>(static_cast<const TA*>(x), stats, M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm<TA, true, false, bf16, bf16>(x, stats, ln_s, ln_b, w, bias, nullptr,
                                                  y, M, N, K, ldw, act, q_scale, q_cols,
                                                  group_cols, stream);
}

// ---------------------------------------------------------------------------
// Attention: out[b, q, h*D:(h+1)*D] = softmax(scale * q k^T, keys < seq_len) v
// over qkv[b, :, 3W] in the grouped layout above (g heads per group).
// One block per (64-query tile, head, image); 4 warps of 16 query rows.  Keys
// stream through shared memory 64 at a time with an fp32 online softmax, so
// no [S, S] tensor exists anywhere; P is cast to bf16 before the PV product
// (block_kernel.py:993-998, :815) and the 1/sum is applied to the output rows.
// Each lane owns one query row's half (HDP/2 output dims) in registers.
// Head width D is a template parameter: WMMA contracts 16 at a time, so the
// shared-memory tiles are HDP = D rounded up to 16 wide (80 for D=72) with
// zero columns past D, which add nothing to q k^T; PV's extra output columns
// are never stored.  A row of D=72 bf16 is 144 bytes, so every 16-byte load
// of a head's row stays aligned.  D=64 is the instance CLIP runs (HDP = D).
// scale is 1/sqrt(D) for CLIP (exact at 1/8) and 1 when ln_gemm's epilogue
// has already scaled q before rounding it, as attn_block_split does.
// ---------------------------------------------------------------------------

constexpr int AQ = 64, AKV = 64, ATT_THREADS = 128;
constexpr int P_LD = AKV + 8;  // bf16

template <int HD>
struct AttnTile {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // padded head width
  static constexpr int T_LD = HDP + 8;             // bf16
  static constexpr int S_LD = (AKV > HDP ? AKV : HDP) + 4;  // fp32 scores / PV out
  static constexpr int HALF = HDP / 2;             // output columns per lane
  static constexpr int SMEM =
      (AQ * T_LD + 2 * AKV * T_LD) * 2 + 4 * 16 * S_LD * 4 + 4 * 16 * P_LD * 2;
};

template <int HD>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int S,
                 int seq_len, int heads, int group_heads, float scale) {
  using T = AttnTile<HD>;
  constexpr int HDP = T::HDP, T_LD = T::T_LD, S_LD = T::S_LD, HALF = T::HALF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + AQ * T_LD;
  bf16* Vs = Ks + AKV * T_LD;
  float* Ss_all = reinterpret_cast<float*>(Vs + AKV * T_LD);
  bf16* Ps_all = reinterpret_cast<bf16*>(Ss_all + 4 * 16 * S_LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int W = heads * HD;
  const int gw = group_heads * HD;  // one group's q (or k, or v) columns
  const size_t ld = 3 * static_cast<size_t>(W);
  const bf16* base = qkv + static_cast<size_t>(b) * S * ld +
                     (h / group_heads) * 3 * gw + (h % group_heads) * HD;
  float* Ss = Ss_all + warp * 16 * S_LD;
  bf16* Ps = Ps_all + warp * 16 * P_LD;

  if constexpr (HDP > HD) {  // the zero columns past the head width
    for (int v = tid; v < AQ * (HDP - HD) / 8; v += ATT_THREADS) {
      const int r = v / ((HDP - HD) / 8), c = HD + (v % ((HDP - HD) / 8)) * 8;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Qs + r * T_LD + c) = z;
      *reinterpret_cast<uint4*>(Ks + r * T_LD + c) = z;
      *reinterpret_cast<uint4*>(Vs + r * T_LD + c) = z;
    }
  }
  for (int v = tid; v < AQ * HD / 8; v += ATT_THREADS) {
    const int r = v / (HD / 8), c = (v % (HD / 8)) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) raw = *reinterpret_cast<const uint4*>(base + (q0 + r) * ld + c);
    *reinterpret_cast<uint4*>(Qs + r * T_LD + c) = raw;
  }
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

  const int n_tiles = (seq_len + AKV - 1) / AKV;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * AKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int v = tid; v < AKV * HD / 8; v += ATT_THREADS) {
      const int r = v / (HD / 8), c = (v % (HD / 8)) * 8;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (k0 + r < seq_len) {  // masked keys load as zeros
        const bf16* p = base + (k0 + r) * ld + c;
        kr = *reinterpret_cast<const uint4*>(p + gw);
        vr = *reinterpret_cast<const uint4*>(p + 2 * gw);
      }
      *reinterpret_cast<uint4*>(Ks + r * T_LD + c) = kr;
      *reinterpret_cast<uint4*>(Vs + r * T_LD + c) = vr;
    }
    __syncthreads();

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

    float sv[AKV / 2];
    float mx = -1e30f;
#pragma unroll
    for (int c = 0; c < AKV / 2; ++c) {
      const float s = (k0 + half * (AKV / 2) + c < seq_len) ? srow[c] * scale : -1e30f;
      sv[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < AKV / 2; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
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
    const float inv = 1.f / l_run;
#pragma unroll
    for (int c = 0; c < HALF; ++c) o[c] *= inv;
    bf16* dst = out + (static_cast<size_t>(b) * S + q) * W + h * HD + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 8)
      if (half * HALF + c < HD) store8(dst + c, o + c);
  }
}

template <int HD>
int launch_attention(const void* qkv, void* out, int B, int S, int seq_len, int heads,
                     int group_heads, float scale, cudaStream_t stream) {
  auto kernel = attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AttnTile<HD>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + AQ - 1) / AQ, heads, B);
  kernel<<<grid, ATT_THREADS, AttnTile<HD>::SMEM, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, seq_len, heads,
      group_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y[M,N] (bf16) = act(LN(x)[M,K] @ w[K,N] + bias), times q_scale on the
// columns n with n % group_cols < q_cols; x is bf16 or fp32; w's rows are ldw
// apart; stats is an [M] float2 scratch for the row statistics.
int aihab_ln_gemm(const void* x, int x_is_f32, const float* ln_s, const float* ln_b,
                  const void* w, int ldw, const float* bias, void* y, void* stats, int M,
                  int N, int K, int act, float eps, float q_scale, int q_cols,
                  int group_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = static_cast<float2*>(stats);
  if (x_is_f32)
    return launch_ln_gemm<float>(x, st, ln_s, ln_b, w, bias, y, M, N, K, ldw, act, eps,
                                 q_scale, q_cols, group_cols, s);
  return launch_ln_gemm<bf16>(x, st, ln_s, ln_b, w, bias, y, M, N, K, ldw, act, eps,
                              q_scale, q_cols, group_cols, s);
}

// y[M,N] = a[M,K] @ w[K,N] + bias + r[M,N]; a, w bf16 (w's rows ldw apart);
// bias may be null (no bias); r and y bf16 or fp32.
int aihab_gemm_residual(const void* a, const void* w, int ldw, const float* bias,
                        const void* r, int r_is_f32, void* y, int y_is_f32, int M, int N,
                        int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_is_f32 && y_is_f32)
    return launch_gemm<bf16, false, true, float, float>(
        a, nullptr, nullptr, nullptr, w, bias, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0, 1, s);
  if (r_is_f32)
    return launch_gemm<bf16, false, true, float, bf16>(
        a, nullptr, nullptr, nullptr, w, bias, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0, 1, s);
  if (y_is_f32)
    return launch_gemm<bf16, false, true, bf16, float>(
        a, nullptr, nullptr, nullptr, w, bias, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0, 1, s);
  return launch_gemm<bf16, false, true, bf16, bf16>(
      a, nullptr, nullptr, nullptr, w, bias, r, y, M, N, K, ldw, ACT_NONE, 1.f, 0, 1, s);
}

// out[B,S,heads*D] (bf16) = masked multi-head attention over qkv[B,S,3*heads*D]
// in the grouped layout (group_heads heads per group); D is 64 or 72.
int aihab_attention(const void* qkv, void* out, int B, int S, int seq_len, int heads,
                    int group_heads, int head_dim, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_attention<64>(qkv, out, B, S, seq_len, heads, group_heads, scale, s);
  if (head_dim == 72)
    return launch_attention<72>(qkv, out, B, S, seq_len, heads, group_heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
