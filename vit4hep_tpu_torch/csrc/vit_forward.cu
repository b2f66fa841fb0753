// Whole-ViT sampler forward for Hopper (sm_90a), as a set of kernels.
//
// Replaces the Pallas TPU kernels of `fused_vit_forward`
// (vit4hep_tpu/ops/fused_dit_block.py:1362): `_vit_kernel` (:1315,
// pallas_call at :1463), the masked `_vit_kernel_masked` (:1281) and the
// grouped `_vit_kernel_g` (:1325, pallas_call at :1423) -- patch embedding
// + positional add, L adaLN-Zero DiT blocks, and the FinalLayer. The
// grouped TPU body packs G elements into one grid cell, with a
// block-diagonal mask (`_grouped_mask`, :287) so that they do not attend to
// each other: per element it is the ungrouped function, which these kernels
// compute over all B*N rows at once for any G.
//
// What bounds it on this card: the TPU kernel keeps one element's whole
// 6-block panel in 128 MiB of VMEM. Here one element's 135 x 480 f32
// activation alone (259 KB) exceeds a CTA's 227 KB of shared memory, so the
// work is split across kernels and the (B*N, H) panels make round trips
// through device memory / L2 between them. At ds2 (B=256) the forward is
// ~1.2 TFLOP per net eval, ~95% of it in the qkv, out-projection and MLP
// products, so it is bound by tensor-core throughput: the products run on
// bf16 multiplicands with f32 accumulation (the TPU kernel's precision),
// through WMMA 16x16x16 fragments.
//
// The kernels:
//  - gemm_kernel<TA, EPI>: C = A (M, K) @ W (K, N) over all B*N rows, 64x64
//    output tiles, 4 warps of 32x32, K in steps of 32 staged through shared
//    memory with zero-filled edges (N = 135 tokens, K = 48 and N = 480 are
//    not multiples of the tile). A is f32 (converted on load) or bf16. The
//    epilogue family: bias; bias + positional embedding; bias + tanh-GELU
//    written as bf16 (the next product's A); gated residual out = resid +
//    gate * (. + bias) on the f32 residual stream (in place when resid is
//    out). The training forward (K5a, `_vit_fwd_train`,
//    vit4hep_tpu/ops/fused_dit_block.py:1491, pallas_call :1549) uses the
//    same kernel with the residual writes of `_store_block_res` (:489)
//    fused into two epilogues: the GELU epilogue also stores the pre-GELU
//    a1 as bf16, and the gated residual also stores y = . + bias as bf16
//    before the gate (each only where its `save` pointer is set); the
//    block input stays in its own buffer because the residual epilogue
//    writes its sum elsewhere.
//  - modln_kernel: LayerNorm (no affine, eps 1e-6) + adaLN modulate
//    (1 + scale) * . + shift, one warp per row, written as bf16.
//  - attention: attn::fwd_kernel<DP, bf16> of attention_fwd.cuh, the same
//    streaming kernel as K1's forward (64-row K/V tiles, online softmax,
//    f32, optional shared (N, N) mask), writing the merged (B, N, H*D)
//    context as bf16 and no log-sum-exp. Its shared memory is fixed (81,920 B
//    at d = 80) whatever N: ds3's 450 tokens run as ds2's 135 do.
//
// Simple first: no cp.async/TMA pipelining and no wgmma yet; those are the
// levers for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

#include "attention_fwd.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;
// leading dimensions in elements; every 16-row / 16-column fragment start
// stays 32-byte aligned (WMMA's requirement)
constexpr int A_LD = BK + 8;
constexpr int W_LD = BN + 8;
constexpr int C_LD = BN + 4;

enum Epi { EPI_BIAS = 0, EPI_BIAS_POS = 1, EPI_BIAS_GELU = 2, EPI_GATED_RESID = 3 };

struct GemmArgs {
  const void* A;
  const __nv_bfloat16* W;
  const float* bias;
  void* out;
  const float* aux;  // EPI_BIAS_POS: pos (n_tok, N); EPI_GATED_RESID: gate rows (B, *)
  long long aux_stride;
  const float* resid;     // EPI_GATED_RESID: the residual added to (may be out)
  __nv_bfloat16* save;    // EPI_BIAS_GELU: a1; EPI_GATED_RESID: y; or nullptr
  int M, N, K, n_tok;
};

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TA, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Ws[BK * W_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  const TA* A = static_cast<const TA*>(g.A);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += GEMM_THREADS) {
      const int r = idx / BK, c = idx % BK, gr = row0 + r, gc = k0 + c;
      As[r * A_LD + c] = (gr < g.M && gc < g.K) ? to_bf16(A[(size_t)gr * g.K + gc])
                                                : __float2bfloat16(0.f);
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += GEMM_THREADS) {
      const int r = idx / BN, c = idx % BN, gr = k0 + r, gc = col0 + c;
      Ws[r * W_LD + c] = (gr < g.K && gc < g.N) ? g.W[(size_t)gr * g.N + gc]
                                                : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + kk * W_LD + wc * 32 + j * 16, W_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * C_LD + wc * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN, gr = row0 + r, gc = col0 + c;
    if (gr >= g.M || gc >= g.N) continue;
    const float v = Cs[r * C_LD + c] + g.bias[gc];
    const size_t o = (size_t)gr * g.N + gc;
    if (EPI == EPI_BIAS) {
      static_cast<float*>(g.out)[o] = v;
    } else if (EPI == EPI_BIAS_POS) {
      static_cast<float*>(g.out)[o] = v + g.aux[(size_t)(gr % g.n_tok) * g.N + gc];
    } else if (EPI == EPI_BIAS_GELU) {
      static_cast<__nv_bfloat16*>(g.out)[o] = __float2bfloat16(gelu_tanh(v));
      if (g.save != nullptr) g.save[o] = __float2bfloat16(v);
    } else {
      const float r = g.resid[o];  // read before the write: resid may be out
      static_cast<float*>(g.out)[o] = r + g.aux[(size_t)(gr / g.n_tok) * g.aux_stride + gc] * v;
      if (g.save != nullptr) g.save[o] = __float2bfloat16(v);
    }
  }
}

__global__ void modln_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                             const float* __restrict__ scale, long long mod_stride,
                             __nv_bfloat16* __restrict__ out, int M, int H, int n_tok,
                             float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;  // whole warp
  const float* xr = x + (size_t)row * H;
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += xr[c];
  const float mean = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float dlt = xr[c] - mean;
    v += dlt * dlt;
  }
  const float rstd = rsqrtf(warp_sum(v) / H + eps);
  const int b = row / n_tok;
  const float* sh = shift + (size_t)b * mod_stride;
  const float* sc = scale + (size_t)b * mod_stride;
  for (int c = lane; c < H; c += 32)
    out[(size_t)row * H + c] = __float2bfloat16((xr[c] - mean) * rstd * (1.f + sc[c]) + sh[c]);
}

template <typename TA>
cudaError_t launch_gemm(const GemmArgs& g, int epi, cudaStream_t s) {
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  switch (epi) {
    case EPI_BIAS:
      gemm_kernel<TA, EPI_BIAS><<<grid, GEMM_THREADS, 0, s>>>(g);
      break;
    case EPI_BIAS_POS:
      gemm_kernel<TA, EPI_BIAS_POS><<<grid, GEMM_THREADS, 0, s>>>(g);
      break;
    case EPI_BIAS_GELU:
      gemm_kernel<TA, EPI_BIAS_GELU><<<grid, GEMM_THREADS, 0, s>>>(g);
      break;
    case EPI_GATED_RESID:
      gemm_kernel<TA, EPI_GATED_RESID><<<grid, GEMM_THREADS, 0, s>>>(g);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int vit_gemm(const void* A, int a_is_bf16, const void* W, const float* bias, void* out,
                        const float* aux, long long aux_stride, const float* resid, void* save,
                        int M, int N, int K, int n_tok, int epi, void* stream) {
  if ((long long)(M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if (epi == EPI_GATED_RESID && resid == nullptr) return (int)cudaErrorInvalidValue;
  GemmArgs g{A, static_cast<const __nv_bfloat16*>(W), bias, out, aux, aux_stride, resid,
             static_cast<__nv_bfloat16*>(save), M, N, K, n_tok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a_is_bf16 ? launch_gemm<__nv_bfloat16>(g, epi, s) : launch_gemm<float>(g, epi, s));
}

extern "C" int vit_modln(const float* x, const float* shift, const float* scale,
                         long long mod_stride, void* out, int M, int H, int n_tok, float eps,
                         void* stream) {
  const int warps = 8;
  modln_kernel<<<(M + warps - 1) / warps, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, shift, scale, mod_stride, static_cast<__nv_bfloat16*>(out), M, H, n_tok, eps);
  return (int)cudaGetLastError();
}

extern "C" int vit_attention(const float* qkv, const unsigned char* mask, void* ctx, int B,
                             int n_tok, int num_heads, int head_dim, float scale, void* stream) {
  if (attn::bad_dims(B, n_tok, num_heads, head_dim)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(head_dim,
                attn::launch_fwd<DP, __nv_bfloat16>(qkv, mask, static_cast<__nv_bfloat16*>(ctx),
                                                    nullptr, B, n_tok, num_heads, head_dim, scale,
                                                    static_cast<cudaStream_t>(stream)))
}
