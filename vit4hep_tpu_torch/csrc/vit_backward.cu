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
//  - kbw::nt_wgmma_kernel<BN, MODE> (bwd_wgmma.cuh): activation gradients
//    dY (M, K) @ W^T, W the (N, K) Dense weight (in = N, out = K), over all
//    M = B*N rows on wgmma with a TMA ring; optionally times the GELU
//    derivative gelu'(a1) (dhid -> da1; a1 bf16 saved or f32 recomputed),
//    writing bf16(da1) and bf16(gelu(a1)) beside the f32 output.
//  - kbw::tn_wgmma_kernel (bwd_wgmma.cuh): weight gradients dW = A^T (K, M)
//    @ dY (M, N) reduce over all M = B*N rows (8,640 at ds2). A tile grid
//    over (K, N) alone is 12-60 tiles on 132 SMs, so M is split into S
//    chunks (split-K); each unit writes its partial (K, N) tile to a
//    workspace, and the f32 column sums of dY (the bias gradient) go to a
//    second one, summed apart from the products by the producer
//    warpgroup's spare warps.
//  - wgrad_reduce_kernel: dW = sum over the S partials, db = sum over the
//    column-sum partials, in a fixed order: no atomics, the result is
//    deterministic.
//  - bwd_rows_kernel<MODE>: the row-wise parts (LayerNorm with adaLN
//    modulation, forward and backward), one warp per row, in three passes:
//    MODE 1 h, h2 (bf16, the dW products' A) and dy = g * gate_mlp; MODE 2
//    dx1 = g + LN'(dh2 * (1 + scale_mlp)) and dattn = dx1 * gate_msa; MODE 3
//    dx = dx1 + LN'(dh * (1 + scale_msa)). Modes 1 and 2 also write dy /
//    dattn in bf16, the copy the products read by TMA (TMA moves bytes; it
//    does not convert them). The adaLN gradients dmod0..5 are sums over
//    each element's N rows of products of these; every CTA takes a chunk of
//    one element's rows, each warp sums its rows into its own shared-memory
//    columns, and the CTA writes the sum of its 8 warps (in order) to a (B,
//    S, 6, H) workspace.
//  - dmod_reduce_kernel: dmod (B, 6, H) = the sum of the S chunk partials.
// The attention backward between dctx and dqkv is K1's (qkv_attention.cu:
// delta, dK/dV, dQ) on the saved f32 qkv panel and the forward's lse.
//
// What bounds it on this card: at ds2 (B*N = 8,640, H 480, F 1920) one
// block's backward does ~95 GFLOP of products (twice the forward's) on
// ~0.4 GB of panel traffic, so it is bound by the tensor cores: the
// products take bf16 multiplicands with f32 accumulation (the TPU kernel's
// precision) on wgmma (bwd_wgmma.cuh says how they are cut for the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bwd_wgmma.cuh"

namespace {

constexpr int ROW_WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ cs,
                                    float* __restrict__ dw, float* __restrict__ db, int S,
                                    int S_cs, long long KN, int N) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < KN) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[(size_t)s * KN + idx];
    dw[idx] = v;
  } else if (idx < KN + N) {
    const int j = (int)(idx - KN);
    float v = 0.f;
    for (int s = 0; s < S_cs; ++s) v += cs[(size_t)s * N + j];
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
  __nv_bfloat16* copy16;  // MODE 1: bf16(dy); MODE 2: bf16(dattn); or nullptr
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
        if (a.copy16 != nullptr) a.copy16[off + c] = __float2bfloat16(g[c] * m[5 * H + c]);
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
          if (a.copy16 != nullptr) a.copy16[off + c] = __float2bfloat16(d * m[2 * H + c]);
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

namespace {

// the TMA maps of a product and its launch: NT A (M, K8) and W (N, K8) in
// BK-column boxes of 192 and BN rows, 128-byte swizzle; TN A (M, K8) and dY
// (M, N8) in BK-row x 32-column boxes, 64-byte swizzle
template <typename Kernel>
int launch_product(Kernel kernel, size_t smem, int threads, long long units, const void* A,
                   long long a_cols, int a_box_rows, int a_box_cols, const void* B,
                   long long b_rows, long long b_cols, int b_box_rows, int b_box_cols,
                   CUtensorMapSwizzle swizzle, const kbw::Args& g, void* stream) {
  if (((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap ta, tb;
  if (hop::encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, g.M, a_cols, a_cols,
                     a_box_rows, a_box_cols, swizzle) != 0 ||
      hop::encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, b_rows, b_cols, b_cols,
                     b_box_rows, b_box_cols, swizzle) != 0)
    return (int)cudaErrorInvalidValue;
  return (int)kbw::launch(kernel, smem, threads, units, ta, tb, g,
                          static_cast<cudaStream_t>(stream));
}

int launch_nt(const void* A, const void* W, const kbw::Args& g, int aux_kind, void* stream) {
  using namespace kbw;
  const long long k8 = (g.K + 7) / 8 * 8;
  const long long units = (long long)((g.M + 64 * NT_CONS - 1) / (64 * NT_CONS)) *
                          ((g.N + NT_BN - 1) / NT_BN);
  const size_t smem = smem_bytes<NT_CONS, NT_BN>();
  const int threads = 128 * (NT_CONS + 1);
#define KBW_NT(mode)                                                                       \
  launch_product(nt_wgmma_kernel<mode>, smem, threads, units, A, k8, 64 * NT_CONS, BK, W, \
                 g.N, k8, NT_BN, BK, CU_TENSOR_MAP_SWIZZLE_128B, g, stream)
  switch (aux_kind) {
    case 0: return KBW_NT(NT_PLAIN);
    case 1: return KBW_NT(NT_DGELU_BF16);
    case 2: return KBW_NT(NT_DGELU_F32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KBW_NT
}

}  // namespace

// out (M, N) f32 = A W^T: A (M, K8) and W (N, K8) bf16, K8 = K rounded up to
// 8, zero past K (the wrapper pads them), 16-byte aligned; aux_kind 0 none, 1
// bf16 a1, 2 f32 a1 (out times gelu'(a1), a1 (M, N)); save (M, N) bf16
// receives bf16(out) and gelu_save bf16(gelu(a1)), each unless null
extern "C" int vit_gemm_nt(const void* A, const void* W, float* out, const void* aux,
                           int aux_kind, void* save, void* gelu_save, int M, int N, int K,
                           void* stream) {
  if (M < 1 || N < 1 || K < 1 || (aux_kind != 0) != (aux != nullptr) ||
      (gelu_save != nullptr && aux_kind == 0))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(aux) |
                        reinterpret_cast<uintptr_t>(save) |
                        reinterpret_cast<uintptr_t>(gelu_save);
  kbw::Args g{out, aux, static_cast<__nv_bfloat16*>(save),
              static_cast<__nv_bfloat16*>(gelu_save), nullptr, nullptr, M, N, K, 1, 0,
              N % 2 == 0 && (any & 7) == 0, false};
  return launch_nt(A, W, g, aux_kind, stream);
}

// the S partial products ws (S, K, N) f32 of dW = A^T dY over chunks of
// `chunk` rows (a multiple of 64), chunk s over rows [s chunk, (s + 1)
// chunk), from A (M, K8) and dY (M, N8) bf16 (K8, N8: K, N rounded up to 8,
// zero-padded by the wrapper; 16-byte aligned); and cs (S * R, N) f32, R =
// ceil(K / 128), the column sums of the f32 dy (M, N) over part r of R of
// each chunk's rows
extern "C" int vit_gemm_tn(const void* A, const void* B16, const float* B, float* ws, float* cs,
                           int M, int K, int N, int S, int chunk, void* stream) {
  using namespace kbw;
  if (M < 1 || K < 1 || N < 1 || S < 1 || chunk < BK || chunk % BK ||
      (long long)S * chunk < M || (long long)(S - 1) * chunk >= M)
    return (int)cudaErrorInvalidValue;
  const long long k8 = (K + 7) / 8 * 8, n8 = (N + 7) / 8 * 8;
  const long long units = (long long)((K + 64 * TN_CONS - 1) / (64 * TN_CONS)) *
                          ((N + TN_BN - 1) / TN_BN) * S;
  const uintptr_t any = reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(B);
  Args g{ws, nullptr, nullptr, nullptr, B, cs, M, N, K, S, chunk, N % 2 == 0 && (any & 7) == 0,
         N % 4 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0};
  return launch_product(tn_wgmma_kernel, smem_bytes<TN_CONS, TN_BN>(), 128 * (TN_CONS + 1), units,
                        A, k8, BK, BOX, B16, M, n8, BK, BOX, CU_TENSOR_MAP_SWIZZLE_64B, g,
                        stream);
}

// dw = the sum of ws (S, K, N) over S, db = the sum of cs (S_cs, N) over
// S_cs, each in order
extern "C" int vit_wgrad_reduce(const float* ws, const float* cs, float* dw, float* db, int S,
                                int S_cs, int K, int N, void* stream) {
  const long long total = (long long)K * N + N;
  const long long blocks = (total + 255) / 256;
  if (S < 1 || S_cs < 1 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wgrad_reduce_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, cs, dw, db, S, S_cs, (long long)K * N, N);
  return (int)cudaGetLastError();
}

extern "C" int vit_bwd_rows(int mode, const float* x, const float* attn, const float* g,
                            const void* y, const float* dgrad, const float* dx1,
                            const float* mod, void* h, void* h2, float* dy, float* out0,
                            float* dattn, void* copy16, float* part, int B, int n, int H, int S,
                            int rows_per_chunk, float eps, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || H < 1 || S < 1 || rows_per_chunk < 1 ||
      (long long)S * rows_per_chunk < n ||
      (size_t)ROW_WARPS * 3 * H * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  RowArgs a{x, attn, g, static_cast<const __nv_bfloat16*>(y), dgrad, dx1, mod,
            static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(h2), dy, out0, dattn,
            static_cast<__nv_bfloat16*>(copy16), part, n, H, S, rows_per_chunk, eps};
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
