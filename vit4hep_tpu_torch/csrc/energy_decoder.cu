// Energy-transformer decoder forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of `fused_energy_decoder`
// (vit4hep_tpu/ops/fused_energy_decoder.py:124, pallas_call at :243): per
// batch element, 4 post-LN decoder layers (self-attention, cross-attention
// collapsed to a per-layer bias, feed-forward), the final LayerNorm and the
// 2-layer SiLU velocity head on [time features, h]. The port holds it to an
// f32 contract (its plain version computes in f32; the TPU kernel took bf16
// multiplicands), softmax in JAX's order: unnormalized p, then (p v) /
// sum(p); LayerNorm eps 1e-5.
//
// Two kernels, one function:
//  - energy_decoder_tf32_kernel<NK>, at the width of every shipped energy
//    config (d_model 128 in 4 heads of 32, feed-forward and head widths
//    multiples of 64, at most 64 tokens): every product on the tensor cores
//    in split TF32 (three TF32 wgmma products each, hi hi + hi lo + lo hi,
//    accumulated in f32: qkv_fwd_tf32.cuh's split, which keeps an f32
//    contract), the attention included.
//  - energy_decoder_kernel, the f32 CUDA-core kernel for any other width.
//
// What bounds the tensor-core kernel: at the ds2 sampling shape (batch 256,
// 45 tokens) the products are 20.5 GFLOP an eval, 61.4 GFLOP as three TF32
// products (0.124 ms at 494.7 TFLOP/s), on 6.2 MB of HBM traffic (the
// target panel, the cross terms, the weights once): operations. Its design:
//  - a CTA of two warpgroups serves two elements, one each: an element's 45
//    tokens fill a 64-row wgmma tile (70% of its rows; at batch 256 that is
//    128 CTAs for 132 SMs). The activation x stays in shared memory in the
//    accumulator layout, each thread holding its own 64 values (the two rows
//    and 32 columns of an m64n128 accumulator it owns): LayerNorm, residuals
//    and biases run in registers with quad shuffles for the row sums, and x
//    enters a product as register A fragments without any exchange;
//  - the weights stream from L2 as f32 in "units" of at most 4096 values
//    (a 32- or 64-row slab of one product's columns), in the fixed order the
//    products consume them (a table of their sources and shapes, filled
//    once in shared memory): all 256 threads load the next unit into
//    registers (two 8-row columns each) and split it into the other of two
//    pairs of hi and lo K-major B operands while both warpgroups' products
//    on this unit run (3.4 MB an eval per CTA, 436 MB of L2 reads at batch
//    256). Splitting on load transposes the (in, out) weights as stored, so
//    the kernel takes JAX's layout and the live parameters of training;
//  - the A operands come from registers as an accumulator holds them: a
//    thread's columns 2t, 2t + 1 of each 8 sit where a tf32 A fragment reads
//    columns t, t + 4, so every B chunk holds its 8 K rows in the order 0, 2,
//    4, 6, 1, 3, 5, 7;
//  - per head, q, k, v (an m64n96 accumulator) come from four 32-row units;
//    k and v^T are written once into the warpgroup's own B tiles, S = q k^T
//    (keys padded to NK, past N -inf), the softmax in registers, ctx = P v,
//    and the out-projection accumulates ctx Wo_h over the heads; the
//    feed-forward runs in 64-column chunks of its hidden layer (bias and
//    activation in registers, then the second product from the registers);
//    the head's time-feature half is one vector per element, computed once
//    on the CUDA cores, and its second layer (width 1) is a dot product in
//    registers.
// The f32 kernel: one CTA per batch element, the activation and the scores
// in shared memory (171 KB at the ds2 shapes), the weights read from L2 with
// one output column per thread and 16 rows of register accumulators.

#include <cuda_runtime.h>
#include <math.h>

#include "qkv_fwd_tf32.cuh"

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
  int B, N, D, TE, F, HN, L, H, act, buf_floats, s_floats;
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


// ---------------------------------------------------------------------------
// the tensor-core kernel (split TF32), d_model 128 in 4 heads of 32
// ---------------------------------------------------------------------------
namespace tc {

constexpr int D = 128;       // d_model
constexpr int DH = 32;       // head dim
constexpr int HEADS = D / DH;
constexpr int WG = 2;        // warpgroups a CTA, one element each
constexpr int TH = 128 * WG;
constexpr int XV = D / 2;    // a thread's values of a 64 x D activation
constexpr int UNIT = 4096;   // weights of the largest unit
constexpr int SMEM_MAX = 232448;

// the unit shapes: QKV, 32 K rows of three 32-column segments (q_h, k_h,
// v_h, segment g at src + g * D); R32, 32 rows of 128 columns (Wo, W2);
// R64, 64 rows of 64 columns (W1, hw0)
enum Kind { QKV = 0, R32 = 1, R64 = 2 };

template <int KIND>
struct Shape;
template <>
struct Shape<QKV> {
  static constexpr int ROWS = 32, NC = 3 * DH, COLS = DH;
};
template <>
struct Shape<R32> {
  static constexpr int ROWS = 32, NC = D, COLS = D;
};
template <>
struct Shape<R64> {
  static constexpr int ROWS = 64, NC = 64, COLS = 64;
};

// one unit of weights: its first element, row stride and shape
struct Unit {
  const float* src;
  int ld, kind;
};

// the tensor-core kernel's shared memory: two units' hi and lo B operands,
// each warpgroup's k and v^T tiles (hi and lo), the activations, each
// warpgroup's head time-feature vector, the table of units
constexpr size_t smem_bytes(int nk, int hn, int units) {
  return (size_t)4 * UNIT * 4 + (size_t)WG * 4 * nk * 128 + (size_t)XV * TH * 4 +
         (size_t)WG * hn * 4 + (size_t)units * sizeof(Unit) + 1024;
}

// the units of a forward: L layers of 5 per head and 4 per 64 hidden
// columns, then 2 per 64 hidden columns of the head
__host__ __device__ constexpr int unit_count(int L, int F, int HN) {
  return L * (5 * HEADS + F / 16) + HN / 32;
}

// unit u in the order the kernel consumes them: per layer, per head its four
// 32-row slabs of q_h | k_h | v_h, then Wo's 32 rows of that head; per
// 64-column chunk of the feed-forward hidden layer W1's two 64-row slabs and
// W2's two 32-row slabs; after the layers, per 64-column chunk of the head's
// hidden layer the two 64-row slabs of hw0's h half
__device__ __forceinline__ Unit unit_at(const DecoderArgs& a, int u) {
  const int per = 5 * HEADS + a.F / 16;
  if (u >= a.L * per) {
    const int r = u - a.L * per, c = r / 2, kh = r % 2;
    return {a.hw0 + (long long)(a.TE + 64 * kh) * a.HN + 64 * c, a.HN, R64};
  }
  const int l = u / per;
  int r = u % per;
  if (r < 5 * HEADS) {
    const int h = r / 5, s = r % 5;
    if (s < 4)
      return {a.wqkv + (long long)l * D * 3 * D + (long long)32 * s * 3 * D + DH * h, 3 * D, QKV};
    return {a.wo + (long long)l * D * D + (long long)DH * h * D, D, R32};
  }
  r -= 5 * HEADS;
  const int c = r / 4, s = r % 4;
  if (s < 2)
    return {a.w1 + (long long)l * D * a.F + (long long)64 * s * a.F + 64 * c, a.F, R64};
  return {a.w2 + (long long)l * a.F * D + (long long)(64 * c + 32 * (s - 2)) * D, D, R32};
}

// a thread's share of a unit: up to two items, each the 8 K rows of one
// chunk at one output column (a unit has rows / 8 x its columns <= 512 items)
constexpr int ITEMS = UNIT / 8 / TH;

// this thread's items of a unit of shape KIND from global memory (L2)
template <int KIND>
__device__ __forceinline__ void load_shape(const Unit& un, float (&w)[ITEMS][8]) {
  using S = Shape<KIND>;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = threadIdx.x + j * TH, n = i % S::NC, c = i / S::NC;
    if (c < S::ROWS / 8) {
      const float* src = un.src + (long long)8 * c * un.ld + (n / S::COLS) * D + n % S::COLS;
#pragma unroll
      for (int k = 0; k < 8; ++k) w[j][k] = __ldg(src + (long long)k * un.ld);
    }
  }
}

// the items as a unit's hi and lo B operands: chunk c (K rows 8c .. 8c+7, in
// the order 0, 2, 4, 6, 1, 3, 5, 7) holds the unit's columns as rows
template <int KIND>
__device__ __forceinline__ void store_shape(const float (&w)[ITEMS][8], unsigned char* hi,
                                            unsigned char* lo) {
  using S = Shape<KIND>;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = threadIdx.x + j * TH, n = i % S::NC, c = i / S::NC;
    if (c < S::ROWS / 8) {
      uint4 h0, l0, h1, l1;
      tf::split4(w[j][0], w[j][2], w[j][4], w[j][6], h0, l0);
      tf::split4(w[j][1], w[j][3], w[j][5], w[j][7], h1, l1);
      tf::put_row(hi + c * S::NC * 32, n, h0, h1);
      tf::put_row(lo + c * S::NC * 32, n, l0, l1);
    }
  }
}

// issues acc (64 x N) += A B in three TF32 products over K/8 chunks: A as
// register fragments, B hi and lo operands of N rows a chunk
template <int N, int K>
__device__ __forceinline__ void issue3(float (&acc)[N / 2], const uint32_t (&ah)[K / 8][4],
                                       const uint32_t (&al)[K / 8][4], uint32_t bh, uint32_t bl) {
  hop::fence_regs(acc);
  hop::wgmma_fence();
#pragma unroll
  for (int c = 0; c < K / 8; ++c) {
    tf::MmaTf32<N>::rs(acc, ah[c], tf::chunk_desc(bh, c, N), 1);
    tf::MmaTf32<N>::rs(acc, ah[c], tf::chunk_desc(bl, c, N), 1);
    tf::MmaTf32<N>::rs(acc, al[c], tf::chunk_desc(bh, c, N), 1);
  }
  hop::wgmma_commit();
}

template <int R>
__device__ __forceinline__ void retire(float (&acc)[R]) {
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
}

// acc += A B (issue3) on a warpgroup's own operands, waited for
template <int N, int K>
__device__ __forceinline__ void mma3(float (&acc)[N / 2], const uint32_t (&ah)[K / 8][4],
                                     const uint32_t (&al)[K / 8][4], uint32_t bh, uint32_t bl) {
  issue3<N, K>(acc, ah, al, bh, bl);
  retire(acc);
}

// the weight pipeline: two pairs of hi and lo B operands; unit u lives in
// pair u % 2 while the next unit's weights wait in registers
struct Pipe {
  unsigned char* b;    // pair p at b + p * 2 * UNIT * 4: hi, then lo
  const Unit* units;   // the table of units, in shared memory
  int total;

  __device__ __forceinline__ unsigned char* hi(int u) const { return b + (u % 2) * 2 * UNIT * 4; }
  __device__ __forceinline__ unsigned char* lo(int u) const { return hi(u) + UNIT * 4; }

  __device__ __forceinline__ void load(int u, float (&w)[ITEMS][8]) const {
    if (u >= total) return;
    const Unit un = units[u];
    if (un.kind == QKV) load_shape<QKV>(un, w);
    else if (un.kind == R32) load_shape<R32>(un, w);
    else load_shape<R64>(un, w);
  }

  __device__ __forceinline__ void store(int u, const float (&w)[ITEMS][8]) const {
    if (u >= total) return;
    const int kind = units[u].kind;
    if (kind == QKV) store_shape<QKV>(w, hi(u), lo(u));
    else if (kind == R32) store_shape<R32>(w, hi(u), lo(u));
    else store_shape<R64>(w, hi(u), lo(u));
  }

  // the table filled, unit 0 stored, unit 1 in w
  __device__ __forceinline__ void start(const DecoderArgs& a, Unit* table,
                                        float (&w)[ITEMS][8]) const {
    for (int v = threadIdx.x; v < total; v += TH) table[v] = unit_at(a, v);
    __syncthreads();
    load(0, w);
    store(0, w);
    load(1, w);
    hop::fence_proxy_async();
    __syncthreads();
  }

  // acc (64 x N) += A B_u in three TF32 products over K/8 chunks, A as
  // register fragments; while they run, unit u + 1 goes from w into the
  // other pair (its last products, on unit u - 1, are done) and unit u + 2
  // into w. Every thread of the CTA takes every unit, in order.
  template <int N, int K>
  __device__ __forceinline__ void product(int u, float (&acc)[N / 2],
                                          const uint32_t (&ah)[K / 8][4],
                                          const uint32_t (&al)[K / 8][4],
                                          float (&w)[ITEMS][8]) const {
    issue3<N, K>(acc, ah, al, hop::smem_u32(hi(u)), hop::smem_u32(lo(u)));
    store(u + 1, w);
    load(u + 2, w);
    retire(acc);
    hop::fence_proxy_async();
    __syncthreads();  // unit u + 1 is stored; every product on unit u is done
  }
};

// the A fragments of x's K/8 chunks from chunk c0 on (x in shared memory at
// xs[i * TH], this thread's value i = 4j + 2hh + e: row l/4 + 8hh, column 8j
// + 2t + e of its warp's 16 rows)
template <int K>
__device__ __forceinline__ void x_frags(uint32_t (&h)[K / 8][4], uint32_t (&l)[K / 8][4],
                                        const float* xs, int c0) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const float* x = xs + 4 * (c0 + j) * TH;
    tf::split(x[0], h[j][0], l[j][0]);
    tf::split(x[2 * TH], h[j][1], l[j][1]);
    tf::split(x[TH], h[j][2], l[j][2]);
    tf::split(x[3 * TH], h[j][3], l[j][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
}

// the column of a thread's accumulator value i (columns 8j + 2t + e)
__device__ __forceinline__ int col_of(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2; }

// LayerNorm (eps 1e-5) of a thread's two rows, each spread over a quad
__device__ __forceinline__ void ln_rows(float (&x)[XV], const float* __restrict__ gamma,
                                        const float* __restrict__ beta) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < XV; ++i)
      if ((i / 2) % 2 == hh) s += x[i];
    const float mean = tf::quad_sum(s) / D;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < XV; ++i)
      if ((i / 2) % 2 == hh) v += (x[i] - mean) * (x[i] - mean);
    const float rstd = rsqrtf(tf::quad_sum(v) / D + LN_EPS);
#pragma unroll
    for (int i = 0; i < XV; ++i)
      if ((i / 2) % 2 == hh) {
        const int c = col_of(i);
        x[i] = (x[i] - mean) * rstd * __ldg(gamma + c) + __ldg(beta + c);
      }
  }
}

// one value of a K-major B tile of `rows` rows: K index k goes to chunk k/8,
// its place in the chunk's order 0, 2, 4, 6, 1, 3, 5, 7, with the 32-byte
// swizzle of tf::put_row
__device__ __forceinline__ void put1(unsigned char* tile, int rows, int row, int k, uint32_t v) {
  const int k8 = k & 7, slot = (k8 >> 1) + ((k8 & 1) << 2);
  const int byte = (slot * 4) ^ (((row >> 2) & 1) << 4);
  *reinterpret_cast<uint32_t*>(tile + (k >> 3) * rows * 32 + row * 32 + byte) = v;
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

template <int NK>
__global__ void __launch_bounds__(TH, 1) energy_decoder_tf32_kernel(DecoderArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WG + wg;
  const bool valid = b < a.B;  // the last CTA's second warpgroup may have no element
  const int r_lo = warp * 16 + lane / 4;  // this thread's rows (tokens): r_lo, r_lo + 8
  const int N = a.N;

  unsigned char* kt = smem + 4 * UNIT * 4 + wg * 4 * NK * 128;  // k (hi, lo), then v^T (hi, lo)
  unsigned char* kth = kt;
  unsigned char* ktl = kt + NK * 128;
  unsigned char* vth = kt + 2 * NK * 128;
  unsigned char* vtl = kt + 3 * NK * 128;
  float* xs = reinterpret_cast<float*>(smem + 4 * UNIT * 4 + WG * 4 * NK * 128) + threadIdx.x;
  float* tfb = xs - threadIdx.x + XV * TH + wg * a.HN;
  Unit* table = reinterpret_cast<Unit*>(xs - threadIdx.x + XV * TH + WG * a.HN);
  const uint32_t akh = hop::smem_u32(kth), akl = hop::smem_u32(ktl);
  const uint32_t avh = hop::smem_u32(vth), avl = hop::smem_u32(vtl);
  const Pipe pipe{smem, table, unit_count(a.L, a.F, a.HN)};
  float w[ITEMS][8];  // the next unit's weights

  // the target rows (zero past N), and the head's time-feature half
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int row = r_lo + 8 * ((i / 2) % 2);
    xs[i * TH] = valid && row < N ? a.tgt[((long long)b * N + row) * D + col_of(i)] : 0.f;
  }
  for (int n = threadIdx.x % 128; n < a.HN; n += 128) {
    float acc = a.hb0[n];
    if (valid)
      for (int k = 0; k < a.TE; ++k)
        acc = fmaf(a.tf[(long long)b * a.TE + k], a.hw0[(long long)k * a.HN + n], acc);
    tfb[n] = acc;
  }
  pipe.start(a, table, w);

  int u = 0;
  for (int l = 0; l < a.L; ++l) {
    // ---- self-attention, post-LN residual ----
    float o[XV];
    zero(o);
    for (int h = 0; h < HEADS; ++h) {
      float qkv[3 * DH / 2];  // q | k | v of head h: columns 0-31, 32-63, 64-95
      zero(qkv);
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t xh[4][4], xl[4][4];
        x_frags<32>(xh, xl, xs, 4 * ks);
        pipe.product<3 * DH, 32>(u++, qkv, xh, xl, w);
      }
      const float* bq = a.bqkv + l * 3 * D + DH * h;
#pragma unroll
      for (int i = 0; i < 3 * DH / 2; ++i) {
        const int c = col_of(i);
        qkv[i] += __ldg(bq + (c / DH) * D + c % DH);
      }
      // k as the B of S = q k^T (keys in rows), v^T as the B of ctx = P v
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) {
        const int row = r_lo + 8 * ((i / 2) % 2), c = col_of(i);
        if (row < NK) {
          uint32_t hi, lo;
          tf::split(qkv[DH / 2 + i], hi, lo);
          put1(kth, NK, row, c, hi);
          put1(ktl, NK, row, c, lo);
          tf::split(qkv[DH + i], hi, lo);
          put1(vth, DH, c, row, hi);
          put1(vtl, DH, c, row, lo);
        }
      }
      hop::fence_proxy_async();
      wg_barrier(wg);

      float q[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) q[i] = qkv[i];
      uint32_t qh[DH / 8][4], ql[DH / 8][4];
      tf::frags<DH>(qh, ql, q);
      float s[NK / 2];
      zero(s);
      mma3<NK, DH>(s, qh, ql, akh, akl);
      // softmax over the N keys: scale, -inf past N, unnormalized p
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        s[i] = col_of(i) < N ? s[i] * a.scale : -INFINITY;
        if ((i / 2) % 2) m_hi = fmaxf(m_hi, s[i]);
        else m_lo = fmaxf(m_lo, s[i]);
      }
      m_lo = tf::quad_max(m_lo);
      m_hi = tf::quad_max(m_hi);
      float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        const bool hi = (i / 2) % 2;
        s[i] = __expf(s[i] - (hi ? m_hi : m_lo));
        if (hi) l_hi += s[i];
        else l_lo += s[i];
      }
      const float inv_lo = 1.f / tf::quad_sum(l_lo), inv_hi = 1.f / tf::quad_sum(l_hi);
      uint32_t ph[NK / 8][4], pl[NK / 8][4];
      tf::frags<NK>(ph, pl, s);
      float ctx[DH / 2];
      zero(ctx);
      mma3<DH, NK>(ctx, ph, pl, avh, avl);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) ctx[i] *= (i / 2) % 2 ? inv_hi : inv_lo;
      uint32_t ch[DH / 8][4], cl[DH / 8][4];
      tf::frags<DH>(ch, cl, ctx);
      pipe.product<D, DH>(u++, o, ch, cl, w);  // Wo's rows of head h
    }
    float x[XV];
    const float* ln_s = a.ln_s + l * 3 * D;
    const float* ln_b = a.ln_b + l * 3 * D;
#pragma unroll
    for (int i = 0; i < XV; ++i) x[i] = xs[i * TH] + o[i] + __ldg(a.bo + l * D + col_of(i));
    ln_rows(x, ln_s, ln_b);
    // ---- cross-attention == per-element bias (one-token memory) ----
    const float* cr = a.cross + ((long long)b * a.L + l) * D;
#pragma unroll
    for (int i = 0; i < XV; ++i) x[i] += valid ? __ldg(cr + col_of(i)) : 0.f;
    ln_rows(x, ln_s + D, ln_b + D);
#pragma unroll
    for (int i = 0; i < XV; ++i) xs[i * TH] = x[i];

    // ---- feed-forward, 64 hidden columns at a time ----
    float y[XV];
    zero(y);
    for (int c = 0; c < a.F / 64; ++c) {
      float hc[32];
      zero(hc);
      for (int kh = 0; kh < 2; ++kh) {
        uint32_t xh[8][4], xl[8][4];
        x_frags<64>(xh, xl, xs, 8 * kh);
        pipe.product<64, 64>(u++, hc, xh, xl, w);
      }
      const float* b1 = a.b1 + l * a.F + 64 * c;
#pragma unroll
      for (int i = 0; i < 32; ++i) hc[i] = activate(hc[i] + __ldg(b1 + col_of(i)), a.act);
      for (int s2 = 0; s2 < 2; ++s2) {
        float hv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) hv[i] = hc[16 * s2 + i];
        uint32_t gh[4][4], gl[4][4];
        tf::frags<32>(gh, gl, hv);
        pipe.product<D, 32>(u++, y, gh, gl, w);
      }
    }
#pragma unroll
    for (int i = 0; i < XV; ++i) x[i] = xs[i * TH] + y[i] + __ldg(a.b2 + l * D + col_of(i));
    ln_rows(x, ln_s + 2 * D, ln_b + 2 * D);
#pragma unroll
    for (int i = 0; i < XV; ++i) xs[i * TH] = x[i];
  }

  // final LayerNorm, then the head: SiLU(x hw0_h + tf hw0_t + hb0) . hw1 + hb1
  {
    float x[XV];
#pragma unroll
    for (int i = 0; i < XV; ++i) x[i] = xs[i * TH];
    ln_rows(x, a.fs, a.fb);
#pragma unroll
    for (int i = 0; i < XV; ++i) xs[i * TH] = x[i];
  }
  float o_lo = 0.f, o_hi = 0.f;
  for (int c = 0; c < a.HN / 64; ++c) {
    float hid[32];
    zero(hid);
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t xh[8][4], xl[8][4];
      x_frags<64>(xh, xl, xs, 8 * kh);
      pipe.product<64, 64>(u++, hid, xh, xl, w);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = 64 * c + col_of(i);
      const float v = activate(hid[i] + tfb[n], ACT_SILU) * __ldg(a.hw1 + n);
      if ((i / 2) % 2) o_hi += v;
      else o_lo += v;
    }
  }
  o_lo = tf::quad_sum(o_lo);
  o_hi = tf::quad_sum(o_hi);
  if (valid && lane % 4 == 0) {
    if (r_lo < N) a.out[(long long)b * N + r_lo] = o_lo + a.hb1[0];
    if (r_lo + 8 < N) a.out[(long long)b * N + r_lo + 8] = o_hi + a.hb1[0];
  }
}

template <int NK>
int launch(const DecoderArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(NK, a.HN, unit_count(a.L, a.F, a.HN));
  cudaError_t e = cudaFuncSetAttribute(energy_decoder_tf32_kernel<NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  energy_decoder_tf32_kernel<NK><<<(a.B + WG - 1) / WG, TH, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
                hw0, hb0, hw1, hb1, out, B, N, D, TE, F, HN, L, H, act,
                (int)plan.buf, (int)plan.s, scale};
  cudaError_t e = cudaFuncSetAttribute(energy_decoder_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  energy_decoder_kernel<<<B, THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// the tensor-core kernel at d_model 128 in 4 heads of 32, feed-forward and
// head widths multiples of 64 and at most 64 tokens (every shipped energy
// config); cudaErrorInvalidValue for any other shape
extern "C" int energy_decoder_tf32_forward(
    const float* tgt, const float* tf, const float* cross, const float* ln_s, const float* ln_b,
    const float* wqkv, const float* bqkv, const float* wo, const float* bo, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* fs, const float* fb,
    const float* hw0, const float* hb0, const float* hw1, const float* hb1, float* out,
    int B, int N, int D, int TE, int F, int HN, int L, int H, int act, float scale,
    void* stream) {
  const int nk = (N + 15) / 16 * 16;
  if (B < 1 || N < 1 || N > 64 || D != tc::D || H != tc::HEADS || F < 64 || F % 64 != 0 ||
      HN < 64 || HN % 64 != 0 || TE < 0 || L < 0 || tc::smem_bytes(nk, HN, tc::unit_count(L, F, HN)) > tc::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  DecoderArgs a{tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2, fs, fb,
                hw0, hb0, hw1, hb1, out, B, N, D, TE, F, HN, L, H, act, 0, 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nk) {
    case 16: return tc::launch<16>(a, st);
    case 32: return tc::launch<32>(a, st);
    case 48: return tc::launch<48>(a, st);
    default: return tc::launch<64>(a, st);
  }
}
