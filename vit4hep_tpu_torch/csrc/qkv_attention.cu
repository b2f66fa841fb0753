// Attention on the qkv projection's native layout, forward and backward, for
// Hopper (sm_90a), with an optional shared (N, N) mask.
//
// Replaces the Pallas TPU kernels of `fused_qkv_attention`
// (vit4hep_tpu/ops/fused_qkv_attention.py:178): the forward `_fused_fwd`
// (:190; per-head `_fused_kernel` :58 and `_fused_kernel_masked` :65,
// head-packed `_packed_kernel` :94 and `_packed_kernel_masked` :156,
// pallas_call :231) and the backward `_fused_bwd` (:300; `_bwd_kernel` :252
// and `_bwd_kernel_masked` :260, pallas_call :328). The TPU kernels hold one
// batch element's whole (N, 3*H*D) panel and each head's (N, N) scores in
// VMEM. A CTA here has at most 227 KB of shared memory, so K/V (forward, dQ)
// and Q/dO (dK/dV) are streamed through shared memory in tiles of 32
// (forward) or 64 rows with an online softmax: there is no limit on N, and
// the (N, N) scores never reach device memory. The head-packed TPU body only
// existed to feed a 128-lane matrix unit at head_dim <= 64; one template per
// padded head dim (16..128 in steps of 16) serves every head dim up to
// MAX_HEAD_DIM = 128.
//
// Kernels (each launched by its own wrapper in ops/fused_qkv_attention.py):
//  - tf::qkv_fwd_tf32_kernel<DP, WG, HAS_MASK> (qkv_fwd_tf32.cuh): one CTA
//    per (64-query tile, head, batch), the products on the tensor cores in
//    split TF32 (3xTF32, the f32 contract). Writes the merged (B, N, H*D)
//    context and the f32 log-sum-exp (B, H, N).
//  - bwd_delta_kernel: delta = rowsum(dO * O) per (batch, head, query), one
//    warp per row. (rowsum(dP * P) of the TPU kernel equals rowsum(dO * O);
//    this kernel uses the latter, so dK/dV need no second pass over keys.)
//  - bwd_dkv_kernel<DP, HAS_MASK>: one CTA per (key tile, head, batch), looping over
//    query tiles: P^T = exp(K Q^T * s - lse), dV += P^T dO,
//    dS^T = P^T (V dO^T - delta) * s, dK += dS^T Q.
//  - bwd_dq_kernel<DP, HAS_MASK>: one CTA per (query tile, head, batch), looping over
//    key tiles: dQ += dS K.
//  The two backward kernels run the tiles of attention_bwd.cuh (shared with
//  K7) on the panel's q, k, v column blocks.
// dK/dV and dQ are written straight into the (B, N, 3*H*D) dqkv panel at the
// q/k/v column offsets of `_fused_kernel_masked` (:70-73); every element is
// written once, so there are no atomics and the result is deterministic.
//
// The mask (uint8, row-major, 1 = attend; nullptr for none) enters where a
// score is formed, as `jnp.where(mask, s, -1e30)` does in JAX (:80, :286):
// a masked score is -1e30, so its rebuilt p = exp(-1e30 - lse) is 0. A row
// whose every key is masked is the one exception, and the kernels keep
// JAX's function there too: its lse is -1e30 + log N, which rounds to -1e30
// in f32, so JAX rebuilds p = 1 for each of its N keys and rowsum(dP * P) =
// N * rowsum(dO * O). The backward kernels scale that row's delta by N. The
// layer-causal mask of the ViT never masks a whole row; tiles wholly masked
// for a row are computed like any other (skipping them is a later lever).
// Each kernel has a masked and an unmasked instantiation (HAS_MASK), so the
// unmasked path spends no registers on the mask.
//
// What bounds it at the ds2 training shape (B = 64, N = 135, H = 6, d = 80):
// the forward does 4*B*H*N^2*d = 2.24 GFLOP on ~67 MB, the backward ~5.6
// GFLOP on ~120 MB. The forward runs its products as three TF32 tensor-core
// products each (qkv_fwd_tf32.cuh says how and why). The backward computes
// in f32 on the CUDA cores (the TPU kernels' interpret-mode precision), so
// it is bound by the f32 FMA rate (67 TFLOP/s): ~84 us at best; its products
// are register-tiled as in attention_bwd.cuh.

#include "attention_bwd.cuh"
#include "qkv_fwd_tf32.cuh"

using attn::THREADS;
using attn::TILE;

namespace {

__global__ void bwd_delta_kernel(const float* __restrict__ g, const float* __restrict__ o,
                                 float* __restrict__ delta, int B, int n, int H, int d) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * n * H) return;  // uniform per warp
  const int h = (int)(warp % H);
  const long long bn = warp / H;  // b * n + row
  const size_t off = (size_t)bn * H * d + (size_t)h * d;
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) acc = fmaf(g[off + k], o[off + k], acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const long long b = bn / n, row = bn % n;
    delta[((size_t)b * H + h) * n + row] = acc;
  }
}

// the (batch, head) cell's q, k, v and dO panels and its lse/delta rows;
// dK/dV and dQ go to the k, v and q columns of the (B, N, 3*H*D) dqkv
// panel, at the offsets of `_fused_kernel_masked` (:70-73)
template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const unsigned char* __restrict__ mask, float* __restrict__ dqkv, int n, int H,
               int d, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t ld = (size_t)3 * H * d, hd = (size_t)H * d, bh = ((size_t)b * H + h) * n;
  const float* base = qkv + (size_t)b * n * ld;
  float* dbase = dqkv + (size_t)b * n * ld;
  attn::bwd_dkv_tile<DP, HAS_MASK, false>(
      base + (size_t)h * d, base + (size_t)(H + h) * d, base + (size_t)(2 * H + h) * d, ld,
      g + (size_t)b * n * hd + (size_t)h * d, hd, lse + bh, delta + bh, mask,
      dbase + (size_t)(H + h) * d, dbase + (size_t)(2 * H + h) * d, ld, blockIdx.x * TILE, n, d,
      scale);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const unsigned char* __restrict__ mask, float* __restrict__ dqkv, int n, int H,
              int d, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t ld = (size_t)3 * H * d, hd = (size_t)H * d, bh = ((size_t)b * H + h) * n;
  const float* base = qkv + (size_t)b * n * ld;
  attn::bwd_dq_tile<DP, HAS_MASK, false>(
      base + (size_t)h * d, base + (size_t)(H + h) * d, base + (size_t)(2 * H + h) * d, ld,
      g + (size_t)b * n * hd + (size_t)h * d, hd, lse + bh, delta + bh, mask,
      dqkv + (size_t)b * n * ld + (size_t)h * d, ld, blockIdx.x * TILE, n, d, scale);
}

// one backward kernel (dK/dV or dQ): launch_dkv / launch_dq pick its masked
// instantiation for a mask and its unmasked one for nullptr
template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, size_t smem, const float* qkv, const float* g,
                       const float* lse, const float* delta, const unsigned char* mask,
                       float* dqkv, int B, int n, int H, int d, float scale, cudaStream_t st) {
  cudaError_t e = attn::prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + TILE - 1) / TILE, H, B), THREADS, smem, st>>>(qkv, g, lse, delta, mask,
                                                                  dqkv, n, H, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const float* qkv, const float* g, const float* lse, const float* delta,
                       const unsigned char* mask, float* dqkv, int B, int n, int H, int d,
                       float scale, cudaStream_t st) {
  return launch_bwd(mask != nullptr ? bwd_dkv_kernel<DP, true> : bwd_dkv_kernel<DP, false>,
                    attn::dkv_smem<DP>(), qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale, st);
}

template <int DP>
cudaError_t launch_dq(const float* qkv, const float* g, const float* lse, const float* delta,
                      const unsigned char* mask, float* dqkv, int B, int n, int H, int d,
                      float scale, cudaStream_t st) {
  return launch_bwd(mask != nullptr ? bwd_dq_kernel<DP, true> : bwd_dq_kernel<DP, false>,
                    attn::dq_smem<DP>(), qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale, st);
}

}  // namespace

extern "C" int qkv_attention_fwd(const float* qkv, const unsigned char* mask, float* out,
                                 float* lse, int B, int n, int H, int d, float scale,
                                 void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, tf::launch_fwd<DP>(qkv, mask, out, lse, B, n, H, d, scale,
                                       static_cast<cudaStream_t>(stream)))
}

extern "C" int qkv_attention_bwd_delta(const float* g, const float* o, float* delta, int B, int n,
                                       int H, int d, void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * n * H;
  const int per_block = 8;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bwd_delta_kernel<<<(unsigned)blocks, per_block * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      g, o, delta, B, n, H, d);
  return (int)cudaGetLastError();
}

extern "C" int qkv_attention_bwd_dkv(const float* qkv, const float* g, const float* lse,
                                     const float* delta, const unsigned char* mask, float* dqkv,
                                     int B, int n, int H, int d, float scale, void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, launch_dkv<DP>(qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale,
                                  static_cast<cudaStream_t>(stream)))
}

extern "C" int qkv_attention_bwd_dq(const float* qkv, const float* g, const float* lse,
                                    const float* delta, const unsigned char* mask, float* dqkv,
                                    int B, int n, int H, int d, float scale, void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, launch_dq<DP>(qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale,
                                 static_cast<cudaStream_t>(stream)))
}
