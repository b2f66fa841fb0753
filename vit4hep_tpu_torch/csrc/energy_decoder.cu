// Energy-transformer decoder forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of `fused_energy_decoder`
// (vit4hep_tpu/ops/fused_energy_decoder.py:124, pallas_call at :243): per
// batch element, 4 post-LN decoder layers (self-attention, cross-attention
// collapsed to a per-layer bias, feed-forward), the final LayerNorm and the
// 2-layer SiLU velocity head on [time features, h].
//
// What bounds it on this card: one element is a 45 x 128 activation and
// about 0.8 M weights per layer stack (3.3 MB in f32). Per net eval the
// work is ~80 MFLOP per element, so the kernel is bound by reading weights
// from L2 and by f32 FMA issue, not by device memory: the 256 x 45 x 128
// target panel is 5.9 MB and is read once.
//
// Design: one CTA per batch element (the TPU grouped G elements into one
// (G*N)^2 block-diagonal score matmul to feed its matrix unit; per-element
// attention is exact without that trick, so `fused_group` does not reach the
// kernel). The activation x, the qkv panel / FFN hidden / head hidden
// (sharing one buffer), the per-head scores and the context stay in shared
// memory across all layers: 171 KB at the ds2 shapes, opted in with
// cudaFuncSetAttribute. Weights are read from global memory (L2-resident
// after the first CTA) with one output column per thread and 16 rows of
// register accumulators, so each weight load feeds 16 FMAs. The qkv rows are
// padded to 3*D+1 floats so that lanes walking keys hit distinct banks.
// Arithmetic is f32 throughout (the TPU used bf16 multiplicands); softmax
// keeps the JAX order: unnormalized p, then (p v) / sum(p).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 16;  // rows per register block in block_linear
constexpr float LN_EPS = 1e-5f;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

struct DecoderArgs {
  const float *tgt, *tf, *cross, *ln_s, *ln_b, *wqkv, *bqkv, *wo, *bo, *w1, *b1,
      *w2, *b2, *fs, *fb, *hw0, *hb0, *hw1, *hb1;
  float* out;
  int N, D, TE, F, HN, L, H, act, buf_floats, s_floats;
  float scale;
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_GELU:  // tanh form, as jax.nn.gelu's default
      return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case ACT_SILU:
      return v / (1.f + expf(-v));
    default:
      return v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C[r, n] = act(sum_k A[r, k] W[k, n] + bias[n])       (accumulate == false)
// C[r, n] += sum_k A[r, k] W[k, n] + bias[n]           (accumulate == true)
// A and C in shared memory (row strides lda, ldc), W (K, N) row-major in
// global memory, bias in global or shared memory. A and C must not alias.
__device__ void block_linear(const float* A, int lda, int M, int K,
                             const float* __restrict__ W, int N, const float* bias,
                             float* C, int ldc, int act, bool accumulate) {
  const int chunks = (M + RB - 1) / RB;
  for (int item = threadIdx.x; item < N * chunks; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * RB;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int row = min(r0 + r, M - 1);
        acc[r] = fmaf(A[row * lda + k], w, acc[r]);
      }
    }
    const float b = bias[n];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = r0 + r;
      if (row < M) {
        if (accumulate)
          C[row * ldc + n] += acc[r] + b;
        else
          C[row * ldc + n] = activate(acc[r] + b, act);
      }
    }
  }
}

// In-place LayerNorm (affine, eps 1e-5) of the M rows of X (M, D), one warp
// per row; `add` (D) is added to every row first when given.
__device__ void layer_norm_rows(float* X, int M, int D, const float* __restrict__ gamma,
                                const float* __restrict__ beta, const float* __restrict__ add) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < M; r += WARPS) {
    float* x = X + r * D;
    if (add != nullptr)
      for (int c = lane; c < D; c += 32) x[c] += add[c];
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dlt = x[c] - mean;
      v += dlt * dlt;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
    for (int c = lane; c < D; c += 32) x[c] = (x[c] - mean) * rstd * gamma[c] + beta[c];
  }
}

__global__ void __launch_bounds__(THREADS) energy_decoder_kernel(DecoderArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int N = a.N, D = a.D, H = a.H, F = a.F, HN = a.HN, TE = a.TE;
  const int d = D / H;
  const int ldq = 3 * D + 1;
  float* x = smem;                   // (N, D) activation
  float* buf = x + N * D;            // qkv (N, ldq) | FFN hidden (N, F) | head hidden (N, HN)
  float* S = buf + a.buf_floats;     // scores (H, N, N) | head time-feature bias (HN)
  float* lsum = S + a.s_floats;      // softmax row sums (H, N)
  float* ctx = lsum + H * N;         // (N, D) attention context

  for (int i = threadIdx.x; i < N * D; i += THREADS) x[i] = a.tgt[(size_t)b * N * D + i];
  __syncthreads();

  for (int l = 0; l < a.L; ++l) {
    // ---- self-attention, post-LN residual ----
    block_linear(x, D, N, D, a.wqkv + (size_t)l * D * 3 * D, 3 * D, a.bqkv + l * 3 * D,
                 buf, ldq, ACT_NONE, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < H * N * N; idx += THREADS) {
      const int h = idx / (N * N), i = (idx / N) % N, j = idx % N;
      const float* q = buf + i * ldq + h * d;
      const float* k = buf + j * ldq + D + h * d;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(q[e], k[e], s);
      S[idx] = s * a.scale;
    }
    __syncthreads();
    for (int row = threadIdx.x; row < H * N; row += THREADS) {
      float* s = S + row * N;
      float m = -INFINITY;
      for (int j = 0; j < N; ++j) m = fmaxf(m, s[j]);
      float sum = 0.f;
      for (int j = 0; j < N; ++j) {
        const float p = expf(s[j] - m);
        s[j] = p;
        sum += p;
      }
      lsum[row] = sum == 0.f ? 1.f : sum;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < N * D; idx += THREADS) {
      const int i = idx / D, c = idx % D, h = c / d;
      const float* p = S + (h * N + i) * N;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], buf[j * ldq + 2 * D + c], acc);
      ctx[idx] = acc / lsum[h * N + i];
    }
    __syncthreads();
    block_linear(ctx, D, N, D, a.wo + (size_t)l * D * D, D, a.bo + l * D, x, D, ACT_NONE, true);
    __syncthreads();
    layer_norm_rows(x, N, D, a.ln_s + (l * 3 + 0) * D, a.ln_b + (l * 3 + 0) * D, nullptr);
    __syncthreads();
    // ---- cross-attention == per-element bias (one-token memory) ----
    layer_norm_rows(x, N, D, a.ln_s + (l * 3 + 1) * D, a.ln_b + (l * 3 + 1) * D,
                    a.cross + ((size_t)b * a.L + l) * D);
    __syncthreads();
    // ---- feed-forward ----
    block_linear(x, D, N, D, a.w1 + (size_t)l * D * F, F, a.b1 + l * F, buf, F, a.act, false);
    __syncthreads();
    block_linear(buf, F, N, F, a.w2 + (size_t)l * F * D, D, a.b2 + l * D, x, D, ACT_NONE, true);
    __syncthreads();
    layer_norm_rows(x, N, D, a.ln_s + (l * 3 + 2) * D, a.ln_b + (l * 3 + 2) * D, nullptr);
    __syncthreads();
  }
  layer_norm_rows(x, N, D, a.fs, a.fb, nullptr);
  // head layer 0 on [tf, h]: the time-feature half is the same for every
  // token, so it is computed once per element and enters as the bias
  for (int n = threadIdx.x; n < HN; n += THREADS) {
    float acc = 0.f;
    for (int k = 0; k < TE; ++k) acc = fmaf(a.tf[(size_t)b * TE + k], a.hw0[(size_t)k * HN + n], acc);
    S[n] = acc + a.hb0[n];
  }
  __syncthreads();
  block_linear(x, D, N, D, a.hw0 + (size_t)TE * HN, HN, S, buf, HN, ACT_SILU, false);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < N; r += WARPS) {
    float acc = 0.f;
    for (int n = lane; n < HN; n += 32) acc = fmaf(buf[r * HN + n], a.hw1[n], acc);
    acc = warp_sum(acc);
    if (lane == 0) a.out[(size_t)b * N + r] = acc + a.hb1[0];
  }
}

// Shared-memory layout of one CTA, in floats: x and ctx (N*D each), the
// qkv / FFN-hidden / head-hidden buffer, the scores (or the head's time
// bias) and the softmax row sums. The Python wrapper computes the same total
// (ops/fused_energy_decoder.smem_bytes) to raise a clear error first.
struct SmemPlan {
  long long buf, s, bytes;
};

SmemPlan smem_plan(int N, int D, int F, int HN, int H) {
  long long buf = (long long)N * (3LL * D + 1);
  if ((long long)N * F > buf) buf = (long long)N * F;
  if ((long long)N * HN > buf) buf = (long long)N * HN;
  long long s = (long long)H * N * N;
  if (HN > s) s = HN;
  return {buf, s, (2LL * N * D + buf + s + (long long)H * N) * (long long)sizeof(float)};
}

}  // namespace

extern "C" int energy_decoder_forward(
    const float* tgt, const float* tf, const float* cross, const float* ln_s, const float* ln_b,
    const float* wqkv, const float* bqkv, const float* wo, const float* bo, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* fs, const float* fb,
    const float* hw0, const float* hb0, const float* hw1, const float* hb1, float* out,
    int B, int N, int D, int TE, int F, int HN, int L, int H, int act, float scale,
    void* stream) {
  const SmemPlan plan = smem_plan(N, D, F, HN, H);
  if (plan.bytes > 232448 || D % H != 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)plan.bytes;
  DecoderArgs a{tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2, fs, fb,
                hw0, hb0, hw1, hb1, out, N, D, TE, F, HN, L, H, act,
                (int)plan.buf, (int)plan.s, scale};
  cudaError_t e = cudaFuncSetAttribute(energy_decoder_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  energy_decoder_kernel<<<B, THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
