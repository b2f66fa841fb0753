// Streaming flash attention on separated (B, H, N, D) tensors, forward and
// backward, for Hopper (sm_90a), with an optional shared (N, N) mask.
//
// Replaces the Pallas TPU kernels of `flash_attention`
// (vit4hep_tpu/ops/flash_attention.py:188): the forward `_fwd_kernel` (:39,
// pallas_call :219), `_bwd_dkv_kernel` (:84, pallas_call :278) and
// `_bwd_dq_kernel` (:128, pallas_call :309). JAX reaches it past
// `flash_qkv_fits` (10,752 tokens at hidden 480, 6 heads) and from
// `dot_product_attention(impl="flash")`. The TPU kernel computes in f32
// throughout (every operand `.astype(jnp.float32)`, every dot_general f32),
// over query and key blocks of 256 padded to n_pad; so do these kernels, in
// 64-row tiles streamed through shared memory, at any N, never writing the
// (N, N) scores to device memory. They are K1's algorithm (the tiles of
// attention_fwd.cuh and attention_bwd.cuh) on another layout:
//  - k7_fwd_kernel<DP, HAS_MASK>: one CTA per (query tile, head, batch);
//    online softmax over the key tiles; writes o (B, H, N, D) f32 and the
//    log-sum-exp (B, H, N) f32.
//  - k7_bwd_dkv_kernel<DP, HAS_MASK>: one CTA per (key tile, head, batch),
//    looping over the query tiles (the TPU grid over key blocks); each key
//    row belongs to one CTA, so dK and dV need no atomics.
//  - k7_bwd_dq_kernel<DP, HAS_MASK>: one CTA per (query tile, head, batch),
//    looping over the key tiles.
// delta = rowsum(dO * O) is computed outside the kernels, as JAX computes
// it in plain XLA (:258).
//
// q, k and v share one stride set (sb, sh, sn) with a unit column stride,
// so the ViT's split of its qkv panel is read in place; dO has its own.
// Offsets are size_t: at the long-sequence ds3 shape (8, 6, 13500, 80) a
// tensor holds 52 million elements and the layer-causal (N, N) mask 182 MB.
//
// The pad guard and the masks (:59-64, :108-110, :147-150): keys past N
// weigh exactly 0 in the forward's sums and in the backward; a masked score
// is -1e30 in the forward, so a row whose every key is masked gets the mean
// of V over the N real keys, with lse = -1e30 + log N (-1e30 in f32). The
// backward weighs a masked key 0 (`where(valid, exp(s - lse), 0)`): such a
// row adds nothing to dK and dV, and its dQ is 0. K7 keeps that asymmetry,
// which is JAX's; K1's kernels keep their own TPU kernel's semantics for
// that row (attention_bwd.cuh).
//
// What bounds it: at the long ds3 training shape the forward does 4 B H N^2
// d = 2.8e12 FLOP a block on 0.8 GB, the backward 3.5x that; in f32 on the
// CUDA cores (67 TFLOP/s) that is ~42 ms forward and ~147 ms backward at
// best. bf16 tensor-core (wgmma) products with TMA-fed tiles are the
// redesign's levers (ROADMAP.md queue 2).

#include "attention_bwd.cuh"

using attn::THREADS;
using attn::TILE;

namespace {

// the (batch, head) cell's row-0 offset in a tensor of strides (sb, sh)
__device__ __forceinline__ size_t cell(long long sb, long long sh) {
  return (size_t)blockIdx.z * (size_t)sb + (size_t)blockIdx.y * (size_t)sh;
}

// the cell's row 0 in a contiguous (B, H, N, D) output, or (d = 1) in the
// (B, H, N) log-sum-exp
__device__ __forceinline__ size_t out_cell(int H, int n, int d) {
  return ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)n * d;
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
k7_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, long long sb, long long sh, long long sn,
              const unsigned char* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ lse, int H, int n, int d, float scale) {
  const size_t off = cell(sb, sh);
  attn::fwd_tile<DP, float, HAS_MASK>(q + off, k + off, v + off, (size_t)sn, mask,
                                      out + out_cell(H, n, d), (size_t)d,
                                      lse + out_cell(H, n, 1), blockIdx.x * TILE, n, d, scale);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
k7_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, long long sb, long long sh, long long sn,
                  const float* __restrict__ g, long long gsb, long long gsh, long long gsn,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const unsigned char* __restrict__ mask, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int n, int d, float scale) {
  const size_t off = cell(sb, sh), stats = out_cell(H, n, 1), o = out_cell(H, n, d);
  attn::bwd_dkv_tile<DP, HAS_MASK, true>(q + off, k + off, v + off, (size_t)sn,
                                         g + cell(gsb, gsh), (size_t)gsn, lse + stats,
                                         delta + stats, mask, dk + o, dv + o, (size_t)d,
                                         blockIdx.x * TILE, n, d, scale);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
k7_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, long long sb, long long sh, long long sn,
                 const float* __restrict__ g, long long gsb, long long gsh, long long gsn,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const unsigned char* __restrict__ mask, float* __restrict__ dq, int H, int n,
                 int d, float scale) {
  const size_t off = cell(sb, sh), stats = out_cell(H, n, 1);
  attn::bwd_dq_tile<DP, HAS_MASK, true>(q + off, k + off, v + off, (size_t)sn,
                                        g + cell(gsb, gsh), (size_t)gsn, lse + stats,
                                        delta + stats, mask, dq + out_cell(H, n, d), (size_t)d,
                                        blockIdx.x * TILE, n, d, scale);
}

// set the kernel's shared memory and launch it on the (query or key tile,
// head, batch) grid
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int B, int H, int n, cudaStream_t st,
                   Args... args) {
  cudaError_t e = attn::prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + TILE - 1) / TILE, H, B), THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, long long sb,
                       long long sh, long long sn, const unsigned char* mask, float* out,
                       float* lse, int B, int H, int n, int d, float scale, cudaStream_t st) {
  return launch(mask != nullptr ? k7_fwd_kernel<DP, true> : k7_fwd_kernel<DP, false>,
                attn::fwd_smem<DP>(), B, H, n, st, q, k, v, sb, sh, sn, mask, out, lse, H, n, d,
                scale);
}

template <int DP>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, long long sb,
                       long long sh, long long sn, const float* g, long long gsb, long long gsh,
                       long long gsn, const float* lse, const float* delta,
                       const unsigned char* mask, float* dk, float* dv, int B, int H, int n,
                       int d, float scale, cudaStream_t st) {
  return launch(mask != nullptr ? k7_bwd_dkv_kernel<DP, true> : k7_bwd_dkv_kernel<DP, false>,
                attn::dkv_smem<DP>(), B, H, n, st, q, k, v, sb, sh, sn, g, gsb, gsh, gsn, lse,
                delta, mask, dk, dv, H, n, d, scale);
}

template <int DP>
cudaError_t launch_dq(const float* q, const float* k, const float* v, long long sb,
                      long long sh, long long sn, const float* g, long long gsb, long long gsh,
                      long long gsn, const float* lse, const float* delta,
                      const unsigned char* mask, float* dq, int B, int H, int n, int d,
                      float scale, cudaStream_t st) {
  return launch(mask != nullptr ? k7_bwd_dq_kernel<DP, true> : k7_bwd_dq_kernel<DP, false>,
                attn::dq_smem<DP>(), B, H, n, st, q, k, v, sb, sh, sn, g, gsb, gsh, gsn, lse,
                delta, mask, dq, H, n, d, scale);
}

// batch and heads go to grid dims y and z (at most 65535 each); the query
// tiles to x (2^31 - 1)
bool bad(int B, int H, int n, int d) { return attn::bad_dims(B, n, H, d); }

}  // namespace

extern "C" int flash_attention_fwd(const float* q, const float* k, const float* v, long long sb,
                                   long long sh, long long sn, const unsigned char* mask,
                                   float* out, float* lse, int B, int H, int n, int d,
                                   float scale, void* stream) {
  if (bad(B, H, n, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, launch_fwd<DP>(q, k, v, sb, sh, sn, mask, out, lse, B, H, n, d, scale,
                                  static_cast<cudaStream_t>(stream)))
}

extern "C" int flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                       long long sb, long long sh, long long sn, const float* g,
                                       long long gsb, long long gsh, long long gsn,
                                       const float* lse, const float* delta,
                                       const unsigned char* mask, float* dk, float* dv, int B,
                                       int H, int n, int d, float scale, void* stream) {
  if (bad(B, H, n, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, launch_dkv<DP>(q, k, v, sb, sh, sn, g, gsb, gsh, gsn, lse, delta, mask, dk,
                                  dv, B, H, n, d, scale, static_cast<cudaStream_t>(stream)))
}

extern "C" int flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                      long long sb, long long sh, long long sn, const float* g,
                                      long long gsb, long long gsh, long long gsn,
                                      const float* lse, const float* delta,
                                      const unsigned char* mask, float* dq, int B, int H, int n,
                                      int d, float scale, void* stream) {
  if (bad(B, H, n, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, launch_dq<DP>(q, k, v, sb, sh, sn, g, gsb, gsh, gsn, lse, delta, mask, dq, B,
                                 H, n, d, scale, static_cast<cudaStream_t>(stream)))
}
