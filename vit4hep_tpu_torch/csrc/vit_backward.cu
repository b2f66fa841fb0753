// Gradient of one adaLN-Zero DiT block from the training forward's saved
// residuals, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_dit_block_bwd_res`
// (vit4hep_tpu/ops/fused_dit_block.py:745; body `_bwd_res_kernel` :623,
// pallas_call :808) and, through it, the recompute backward
// `fused_dit_block_bwd` (:1204; body `_bwd_kernel_masked` :1070,
// pallas_call :1261), whose block forward the wrapper first recomputes with
// the training forward's kernels (vit_forward.cu). The TPU kernel walks the
// batch on a sequential grid, one element per cell, and accumulates the
// weight gradients in VMEM across cells. Blocks here run in parallel in no
// order, so the computation is re-cut by what it reduces over:
//
//  - gemm_nt_kernel<EPI, TAux>: activation gradients dY (M, K) f32 @ W^T
//    with W the (N, K) Dense weight (in = N, out = K) in bf16, over all
//    M = B*N rows: the transposed operand is staged column-major in shared
//    memory and read as a col_major WMMA fragment. Epilogues: none (dh2,
//    dctx, dh) or the GELU derivative gelu'(a1) (dhid -> da1), with a1 in
//    bf16 (saved) or f32 (recomputed).
//  - gemm_tn_kernel<TA, GELU>: weight gradients dW = A^T (K, M) @ dY (M, N)
//    reduce over all M = B*N rows (8,640 at ds2). A tile grid over (K, N)
//    alone is 64-240 CTAs on 132 SMs, so M is split into S chunks (split-K);
//    each CTA writes its partial (K, N) tile to a workspace and the CTAs of
//    the first K-tile row also write the f32 column sums of their dY chunk
//    (the bias gradient). With GELU, A is gelu(a1) formed on load (the
//    hidden activation is never stored).
//  - wgrad_reduce_kernel: dW = sum over the S partials, db = sum over the S
//    column sums, in a fixed order: no atomics, the result is deterministic.
//  - bwd_rows_kernel<MODE>: the row-wise parts (LayerNorm with adaLN
//    modulation, forward and backward), one warp per row, in three passes:
//    MODE 1 h, h2 (bf16, the dW products' A) and dy = g * gate_mlp; MODE 2
//    dx1 = g + LN'(dh2 * (1 + scale_mlp)) and dattn = dx1 * gate_msa; MODE 3
//    dx = dx1 + LN'(dh * (1 + scale_msa)). The adaLN gradients dmod0..5 are
//    sums over each element's N rows of products of these; every CTA takes
//    a chunk of one element's rows, each warp sums its rows into its own
//    shared-memory columns, and the CTA writes the sum of its 8 warps (in
//    order) to a (B, S, 6, H) workspace.
//  - dmod_reduce_kernel: dmod (B, 6, H) = the sum of the S chunk partials.
// The attention backward between dctx and dqkv is K1's (qkv_attention.cu:
// delta, dK/dV, dQ) on the saved f32 qkv panel and the forward's lse.
//
// What bounds it on this card: at ds2 (B*N = 8,640, H 480, F 1920) one
// block's backward does ~95 GFLOP of products (twice the forward's) on
// ~0.4 GB of panel traffic, so it is bound by the tensor cores: the
// products take bf16 multiplicands with f32 accumulation (the TPU kernel's
// precision) through WMMA 16x16x16 fragments. Simple first, as the forward:
// no cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;
// leading dimensions (elements); every fragment start stays 32-byte aligned
constexpr int A_LD = BK + 8;    // row-major A tile (BM x BK)
constexpr int BT_LD = BK + 8;   // col-major B tile: (k, n) at n * BT_LD + k
constexpr int AT_LD = BM + 8;   // col-major A tile: (i, m) at m * AT_LD + i
constexpr int B_LD = BN + 8;    // row-major B tile (BK x BN)
constexpr int C_LD = BN + 4;
constexpr int ROW_WARPS = 8;

enum EpiNT { EPI_NT_NONE = 0, EPI_NT_DGELU = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// d/dv of the tanh GELU above
__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (v + 0.044715f * v * v * v));
  return 0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * v * v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the 2 x 2 warps' 32 x 32 accumulators of a 64 x 64 tile into shared memory
__device__ __forceinline__ void store_acc(
    float* Cs, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[2][2], int wr,
    int wc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * C_LD + wc * 32 + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
}

// out (M, N) = epilogue(A (M, K) @ W^T), W (N, K) row-major bf16
template <int EPI, typename TAux>
__global__ void __launch_bounds__(THREADS)
gemm_nt_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ W,
               float* __restrict__ out, const TAux* __restrict__ aux, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN * BT_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK, gr = row0 + r, gc = k0 + c;
      As[r * A_LD + c] = __float2bfloat16((gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.f);
    }
    for (int idx = threadIdx.x; idx < BN * BK; idx += THREADS) {
      const int nn = idx / BK, kk = idx % BK, gn = col0 + nn, gk = k0 + kk;
      Bs[nn * BT_LD + kk] = (gn < N && gk < K) ? W[(size_t)gn * K + gk] : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wc * 32 + j * 16) * BT_LD + kk, BT_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  store_acc(Cs, acc, wr, wc);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, gr = row0 + r, gc = col0 + c;
    if (gr >= M || gc >= N) continue;
    const size_t o = (size_t)gr * N + gc;
    const float v = Cs[r * C_LD + c];
    out[o] = EPI == EPI_NT_DGELU ? v * gelu_tanh_grad(to_f32(aux[o])) : v;
  }
}

// partial dW of rows [s * chunk, (s + 1) * chunk): ws[s] (K, N) = A^T @ B
// over those rows, A (M, K) (gelu(A) with GELU), B (M, N) f32; the CTAs of
// K-tile row 0 also write the rows' column sums of B to cs[s] (N)
template <typename TA, bool GELU>
__global__ void __launch_bounds__(THREADS)
gemm_tn_kernel(const TA* __restrict__ A, const float* __restrict__ B, float* __restrict__ ws,
               float* __restrict__ cs, int M, int K, int N, int chunk) {
  __shared__ __align__(128) __nv_bfloat16 As[BK * AT_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  __shared__ float csum_s[THREADS];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN, s = blockIdx.z;
  const int m_begin = s * chunk, m_end = min(M, m_begin + chunk);
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const bool sums = blockIdx.y == 0;
  float csum = 0.f;  // column threadIdx.x % BN (THREADS is a multiple of BN)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = m_begin; m0 < m_end; m0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += THREADS) {
      const int mm = idx / BM, ii = idx % BM, gm = m0 + mm, gi = row0 + ii;
      float v = 0.f;
      if (gm < m_end && gi < K) {
        v = to_f32(A[(size_t)gm * K + gi]);
        if (GELU) v = gelu_tanh(v);
      }
      As[mm * AT_LD + ii] = __float2bfloat16(v);
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int mm = idx / BN, jj = idx % BN, gm = m0 + mm, gj = col0 + jj;
      const float v = (gm < m_end && gj < N) ? B[(size_t)gm * N + gj] : 0.f;
      Bs[mm * B_LD + jj] = __float2bfloat16(v);
      if (sums) csum += v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * AT_LD + wr * 32 + i * 16, AT_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wc * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  store_acc(Cs, acc, wr, wc);
  if (sums) csum_s[threadIdx.x] = csum;
  __syncthreads();

  float* wsp = ws + (size_t)s * K * N;
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, gi = row0 + r, gj = col0 + c;
    if (gi < K && gj < N) wsp[(size_t)gi * N + gj] = Cs[r * C_LD + c];
  }
  if (sums && threadIdx.x < BN && col0 + threadIdx.x < N) {
    float v = 0.f;
    for (int t = threadIdx.x; t < THREADS; t += BN) v += csum_s[t];
    cs[(size_t)s * N + col0 + threadIdx.x] = v;
  }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ cs,
                                    float* __restrict__ dw, float* __restrict__ db, int S,
                                    long long KN, int N) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < KN) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[(size_t)s * KN + idx];
    dw[idx] = v;
  } else if (idx < KN + N) {
    const int j = (int)(idx - KN);
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += cs[(size_t)s * N + j];
    db[j] = v;
  }
}

struct RowArgs {
  const float* x;     // (M, H) block input
  const float* attn;  // (M, H) ctx @ wout + bout (MODES 1, 2)
  const float* g;     // (M, H) upstream gradient (MODES 1, 2)
  const __nv_bfloat16* y;  // (M, H) MLP output before the gate (MODE 1)
  const float* dgrad;  // MODE 2: dh2; MODE 3: dh
  const float* dx1;    // (M, H) (MODE 3)
  const float* mod;    // (B, 6, H)
  __nv_bfloat16* h;    // MODE 1 outputs
  __nv_bfloat16* h2;
  float* dy;
  float* out0;   // MODE 2: dx1; MODE 3: dx
  float* dattn;  // MODE 2
  float* part;   // (B, S, 6, H) chunk sums of the adaLN gradients
  int n, H, S, rows_per_chunk;
  float eps;
};

template <int MODE>
__host__ __device__ constexpr int n_sums() { return MODE == 1 ? 1 : (MODE == 2 ? 3 : 2); }

// the dmod slot of each of a mode's sums: MODE 1 dmod5; MODE 2 dmod4,
// dmod3, dmod2; MODE 3 dmod1, dmod0
template <int MODE>
__device__ __forceinline__ int slot(int r) {
  return MODE == 1 ? 5 : (MODE == 2 ? 4 - r : 1 - r);
}

template <int MODE>
__global__ void __launch_bounds__(ROW_WARPS * 32) bwd_rows_kernel(RowArgs a) {
  extern __shared__ float acc[];  // [warp][sum][H]
  constexpr int NS = n_sums<MODE>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = blockIdx.x, b = blockIdx.y, H = a.H;
  for (int i = threadIdx.x; i < ROW_WARPS * NS * H; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  float* my = acc + (size_t)warp * NS * H;
  const float* m = a.mod + (size_t)b * 6 * H;
  const int r_end = min(a.n, (chunk + 1) * a.rows_per_chunk);
  const float inv_h = 1.f / H;

  for (int row = chunk * a.rows_per_chunk + warp; row < r_end; row += ROW_WARPS) {
    const size_t off = ((size_t)b * a.n + row) * H;
    const float* x = a.x + off;
    if (MODE == 1) {
      const float* at = a.attn + off;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < H; c += 32) {
        s1 += x[c];
        s2 += x[c] + m[2 * H + c] * at[c];
      }
      const float mean1 = warp_sum(s1) * inv_h, mean2 = warp_sum(s2) * inv_h;
      float v1 = 0.f, v2 = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float d1 = x[c] - mean1, d2 = x[c] + m[2 * H + c] * at[c] - mean2;
        v1 += d1 * d1;
        v2 += d2 * d2;
      }
      const float rstd1 = rsqrtf(warp_sum(v1) * inv_h + a.eps);
      const float rstd2 = rsqrtf(warp_sum(v2) * inv_h + a.eps);
      const float* g = a.g + off;
      const __nv_bfloat16* y = a.y + off;
      for (int c = lane; c < H; c += 32) {
        const float u = (x[c] - mean1) * rstd1;
        const float u2 = (x[c] + m[2 * H + c] * at[c] - mean2) * rstd2;
        a.h[off + c] = __float2bfloat16(u * (1.f + m[H + c]) + m[c]);
        a.h2[off + c] = __float2bfloat16(u2 * (1.f + m[4 * H + c]) + m[3 * H + c]);
        a.dy[off + c] = g[c] * m[5 * H + c];
        my[c] += g[c] * __bfloat162float(y[c]);
      }
    } else {
      // MODE 2: z = x1 = x + gate_msa * attn, scale k = 4, upstream g;
      // MODE 3: z = x, scale k = 1, upstream dx1
      const float* at = MODE == 2 ? a.attn + off : nullptr;
      const float* dz = a.dgrad + off;
      const int ks = MODE == 2 ? 4 : 1;
      auto zval = [&](int c) { return MODE == 2 ? x[c] + m[2 * H + c] * at[c] : x[c]; };
      float s = 0.f;
      for (int c = lane; c < H; c += 32) s += zval(c);
      const float mean = warp_sum(s) * inv_h;
      float v = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float d = zval(c) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) * inv_h + a.eps);
      float sd = 0.f, sdu = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float u = (zval(c) - mean) * rstd;
        const float du = dz[c] * (1.f + m[ks * H + c]);
        sd += du;
        sdu += du * u;
      }
      const float mdu = warp_sum(sd) * inv_h, mduu = warp_sum(sdu) * inv_h;
      const float* up = MODE == 2 ? a.g + off : a.dx1 + off;
      for (int c = lane; c < H; c += 32) {
        const float u = (zval(c) - mean) * rstd;
        const float du = dz[c] * (1.f + m[ks * H + c]);
        const float d = up[c] + rstd * (du - mdu - u * mduu);
        a.out0[off + c] = d;
        if (MODE == 2) {
          a.dattn[off + c] = d * m[2 * H + c];
          my[c] += dz[c] * u;            // dmod4
          my[H + c] += dz[c];            // dmod3
          my[2 * H + c] += d * at[c];    // dmod2
        } else {
          my[c] += dz[c] * u;            // dmod1
          my[H + c] += dz[c];            // dmod0
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NS * H; i += blockDim.x) {
    const int r = i / H, c = i % H;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) v += acc[((size_t)w * NS + r) * H + c];
    a.part[(((size_t)b * a.S + chunk) * 6 + slot<MODE>(r)) * H + c] = v;
  }
}

__global__ void dmod_reduce_kernel(const float* __restrict__ part, float* __restrict__ dmod,
                                   int B, int S, int H) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * 6 * H) return;
  const int c = (int)(idx % H);
  const long long bk = idx / H;
  const int k = (int)(bk % 6), b = (int)(bk / 6);
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[(((size_t)b * S + s) * 6 + k) * H + c];
  dmod[idx] = v;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int MODE>
cudaError_t launch_rows(const RowArgs& a, int B, cudaStream_t st) {
  const size_t smem = (size_t)ROW_WARPS * n_sums<MODE>() * a.H * sizeof(float);
  cudaError_t e = set_smem(bwd_rows_kernel<MODE>, smem);
  if (e != cudaSuccess) return e;
  bwd_rows_kernel<MODE><<<dim3(a.S, B), ROW_WARPS * 32, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// aux_kind: 0 none, 1 bf16 a1, 2 f32 a1 (the GELU-derivative epilogue)
extern "C" int vit_gemm_nt(const float* A, const void* W, float* out, const void* aux,
                           int aux_kind, int M, int N, int K, void* stream) {
  if ((M + BM - 1) / BM > 65535 || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(W);
  switch (aux_kind) {
    case 0:
      gemm_nt_kernel<EPI_NT_NONE, float><<<grid, THREADS, 0, s>>>(A, w, out, nullptr, M, N, K);
      break;
    case 1:
      gemm_nt_kernel<EPI_NT_DGELU, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
          A, w, out, static_cast<const __nv_bfloat16*>(aux), M, N, K);
      break;
    case 2:
      gemm_nt_kernel<EPI_NT_DGELU, float><<<grid, THREADS, 0, s>>>(
          A, w, out, static_cast<const float*>(aux), M, N, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a_kind: 0 f32 A, 1 bf16 A, 2 f32 A through gelu, 3 bf16 A through gelu
extern "C" int vit_gemm_tn(const void* A, int a_kind, const float* B, float* ws, float* cs, int M,
                           int K, int N, int S, int chunk, void* stream) {
  if (M < 1 || K < 1 || N < 1 || S < 1 || S > 65535 || chunk % BK ||
      (long long)S * chunk < M || (K + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_kind) {
    case 0:
      gemm_tn_kernel<float, false><<<grid, THREADS, 0, s>>>(static_cast<const float*>(A), B, ws,
                                                            cs, M, K, N, chunk);
      break;
    case 1:
      gemm_tn_kernel<__nv_bfloat16, false><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(A), B, ws, cs, M, K, N, chunk);
      break;
    case 2:
      gemm_tn_kernel<float, true><<<grid, THREADS, 0, s>>>(static_cast<const float*>(A), B, ws,
                                                           cs, M, K, N, chunk);
      break;
    case 3:
      gemm_tn_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(A), B, ws, cs, M, K, N, chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int vit_wgrad_reduce(const float* ws, const float* cs, float* dw, float* db, int S,
                                int K, int N, void* stream) {
  const long long total = (long long)K * N + N;
  const long long blocks = (total + 255) / 256;
  if (S < 1 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wgrad_reduce_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, cs, dw, db, S, (long long)K * N, N);
  return (int)cudaGetLastError();
}

extern "C" int vit_bwd_rows(int mode, const float* x, const float* attn, const float* g,
                            const void* y, const float* dgrad, const float* dx1,
                            const float* mod, void* h, void* h2, float* dy, float* out0,
                            float* dattn, float* part, int B, int n, int H, int S,
                            int rows_per_chunk, float eps, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || H < 1 || S < 1 || rows_per_chunk < 1 ||
      (long long)S * rows_per_chunk < n ||
      (size_t)ROW_WARPS * 3 * H * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  RowArgs a{x, attn, g, static_cast<const __nv_bfloat16*>(y), dgrad, dx1, mod,
            static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(h2), dy, out0, dattn,
            part, n, H, S, rows_per_chunk, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 1:
      return (int)launch_rows<1>(a, B, s);
    case 2:
      return (int)launch_rows<2>(a, B, s);
    case 3:
      return (int)launch_rows<3>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vit_dmod_reduce(const float* part, float* dmod, int B, int S, int H,
                               void* stream) {
  const long long total = (long long)B * 6 * H;
  const long long blocks = (total + 255) / 256;
  if (S < 1 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dmod_reduce_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, dmod, B, S, H);
  return (int)cudaGetLastError();
}
