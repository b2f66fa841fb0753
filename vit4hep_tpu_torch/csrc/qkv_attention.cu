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
// and Q/dO (dK/dV) are streamed through shared memory in tiles of 16 or 32
// rows: there is no limit on N, and the (N, N) scores never reach device
// memory. The head-packed TPU body only existed to feed a 128-lane matrix
// unit at head_dim <= 64; one template per padded head dim (16..128 in steps
// of 16) serves every head dim up to MAX_HEAD_DIM = 128.
//
// Kernels (each launched by its own wrapper in ops/fused_qkv_attention.py):
//  - tf::qkv_fwd_tf32_kernel<DP, WG, HAS_MASK> (qkv_fwd_tf32.cuh): one CTA
//    per (64-query tile, head, batch), the products on the tensor cores in
//    split TF32 (3xTF32, the f32 contract). Writes the merged (B, N, H*D)
//    context and the f32 log-sum-exp (B, H, N).
//  - bwd_delta_kernel: delta = rowsum(dO * O) per (batch, head, query), one
//    warp per row. (rowsum(dP * P) of the TPU kernel equals rowsum(dO * O);
//    this kernel uses the latter, so dK/dV need no second pass over keys.)
//  - tb::qkv_bwd_dkv_tf32_kernel<DP, HAS_MASK> (qkv_bwd_tf32.cuh): one CTA
//    per (64-key tile, head, batch), looping over query tiles: P^T =
//    exp(K Q^T * s - lse), dV += P^T dO, dS^T = P^T (V dO^T - delta) * s,
//    dK += dS^T Q.
//  - tb::qkv_bwd_dq_tf32_kernel<DP, HAS_MASK> (qkv_bwd_tf32.cuh): one CTA
//    per (64-query tile, head, batch), looping over key tiles: dQ += dS K.
//  Both backward kernels run every product as three TF32 tensor-core
//  products, as the forward does. They are bound in qkv_attention_bwd.cu,
//  a library of their own: in this translation unit nvcc compiled the
//  forward kernels to other code than alone (PERF.md section 6).
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
// GFLOP on ~120 MB. As three TF32 products each they are 6.7 and 16.8 GFLOP
// (0.014 and 0.034 ms at 494.7 TFLOP/s) against 0.020 and 0.065 ms of bytes
// at 3.35 TB/s: bytes (qkv_fwd_tf32.cuh and qkv_bwd_tf32.cuh say how).

#include "qkv_fwd_tf32.cuh"

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
