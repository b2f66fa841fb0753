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
// and Q/dO (dK/dV) are streamed through shared memory in 64-row tiles with
// an online softmax: there is no limit on N, and the (N, N) scores never
// reach device memory. The head-packed TPU body only existed to feed a
// 128-lane matrix unit at head_dim <= 64; one template per padded head dim
// (16..128 in steps of 16) serves every head dim up to MAX_HEAD_DIM = 128.
//
// Kernels (each launched by its own wrapper in ops/fused_qkv_attention.py):
//  - attn::fwd_kernel<DP, float, HAS_MASK> (attention_fwd.cuh, shared with K2v): one
//    CTA per (query tile, head, batch). Writes the merged (B, N, H*D)
//    context and the f32 log-sum-exp (B, H, N).
//  - bwd_delta_kernel: delta = rowsum(dO * O) per (batch, head, query), one
//    warp per row. (rowsum(dP * P) of the TPU kernel equals rowsum(dO * O);
//    this kernel uses the latter, so dK/dV need no second pass over keys.)
//  - bwd_dkv_kernel<DP, HAS_MASK>: one CTA per (key tile, head, batch), looping over
//    query tiles: P^T = exp(K Q^T * s - lse), dV += P^T dO,
//    dS^T = P^T (V dO^T - delta) * s, dK += dS^T Q.
//  - bwd_dq_kernel<DP, HAS_MASK>: one CTA per (query tile, head, batch), looping over
//    key tiles: dQ += dS K.
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
// GFLOP on ~120 MB. This first version computes in f32 on the CUDA cores
// (the TPU kernels' interpret-mode precision), so it is bound by the f32
// FMA rate (67 TFLOP/s): ~33 us forward, ~84 us backward at best. The
// products are register-tiled as in attention_fwd.cuh. Tensor-core (bf16
// mma/wgmma) products and cp.async/TMA pipelining are the levers for a
// later change.

#include "attention_fwd.cuh"

using attn::LDT;
using attn::MASKED;
using attn::THREADS;
using attn::TILE;

namespace {

template <int DP>
constexpr size_t dkv_smem() {
  return (size_t)(4 * TILE * (DP + 4) + 2 * TILE * LDT + 2 * TILE) * sizeof(float);
}
template <int DP>
constexpr size_t dq_smem() {
  return (size_t)(4 * TILE * (DP + 4) + TILE * LDT + 2 * TILE) * sizeof(float);
}

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

// lse and delta of query tile [q0, q0 + TILE) of one (batch, head) into
// shared memory: 0 past n; a wholly masked row's delta times n (see above)
template <bool HAS_MASK>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s, const float* lse_bh,
                                               const float* del_bh, int q0, int n) {
  if (threadIdx.x < TILE) {
    const int q = q0 + threadIdx.x;
    const float ls = q < n ? lse_bh[q] : 0.f;
    const float dl = q < n ? del_bh[q] : 0.f;
    lse_s[threadIdx.x] = ls;
    del_s[threadIdx.x] = (HAS_MASK && ls == MASKED) ? dl * (float)n : dl;
  }
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const unsigned char* __restrict__ mask, float* __restrict__ dqkv, int n, int H,
               int d, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 4, CPT = DP / 16;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + TILE * LD;
  float* Ps = Gs + TILE * LD;
  float* Ds = Ps + TILE * LDT;
  float* lse_s = Ds + TILE * LDT;
  float* del_s = lse_s + TILE;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const size_t ld = (size_t)3 * H * d, hd = (size_t)H * d;
  const float* base = qkv + (size_t)b * n * ld;
  const float* gbase = g + (size_t)b * n * hd;
  const float* lse_bh = lse + ((size_t)b * H + h) * n;
  const float* del_bh = delta + ((size_t)b * H + h) * n;

  attn::load_tile<DP>(Ks, base + (size_t)(H + h) * d, k0, n, ld, d);
  attn::load_tile<DP>(Vs, base + (size_t)(2 * H + h) * d, k0, n, ld, d);
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < n; q0 += TILE) {
    __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
    attn::load_tile<DP>(Qs, base + (size_t)h * d, q0, n, ld, d);
    attn::load_tile<DP>(Gs, gbase + (size_t)h * d, q0, n, hd, d);
    load_row_stats<HAS_MASK>(lse_s, del_s, lse_bh, del_bh, q0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    attn::tile_abt<DP>(s, Ks, Qs, r, c);   // s[key][query]
    attn::tile_abt<DP>(dp, Vs, Gs, r, c);  // dp[key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = c + 16 * j, query = q0 + qi;
        const float sv = attn::score<HAS_MASK>(s[i][j], scale, query, key, n, mask);
        const float p = query < n ? expf(sv - lse_s[qi]) : 0.f;  // 0 for a key past n
        Ps[(r * 4 + i) * LDT + qi] = p;
        Ds[(r * 4 + i) * LDT + qi] = p * (dp[i][j] - del_s[qi]) * scale;
      }
    }
    __syncthreads();
    attn::tile_pv<DP>(dv, Ps, Gs, r, c);
    attn::tile_pv<DP>(dk, Ds, Qs, r, c);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + r * 4 + i;
    if (row >= n) continue;
    float* drow = dqkv + ((size_t)b * n + row) * ld;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) {
        drow[(size_t)(H + h) * d + col] = dk[i][j];
        drow[(size_t)(2 * H + h) * d + col] = dv[i][j];
      }
    }
  }
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const unsigned char* __restrict__ mask, float* __restrict__ dqkv, int n, int H,
              int d, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 4, CPT = DP / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + TILE * LD;
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ds = Vs + TILE * LD;
  float* lse_s = Ds + TILE * LDT;
  float* del_s = lse_s + TILE;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const size_t ld = (size_t)3 * H * d, hd = (size_t)H * d;
  const float* base = qkv + (size_t)b * n * ld;
  const size_t bh = ((size_t)b * H + h) * n;

  attn::load_tile<DP>(Qs, base + (size_t)h * d, q0, n, ld, d);
  attn::load_tile<DP>(Gs, g + (size_t)b * n * hd + (size_t)h * d, q0, n, hd, d);
  load_row_stats<HAS_MASK>(lse_s, del_s, lse + bh, delta + bh, q0, n);
  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the previous tile's K/dS reads are done
    attn::load_tile<DP>(Ks, base + (size_t)(H + h) * d, k0, n, ld, d);
    attn::load_tile<DP>(Vs, base + (size_t)(2 * H + h) * d, k0, n, ld, d);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    attn::tile_abt<DP>(s, Qs, Ks, r, c);   // s[query][key]
    attn::tile_abt<DP>(dp, Gs, Vs, r, c);  // dp[query][key]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = c + 16 * j;
        const float sv = attn::score<HAS_MASK>(s[i][j], scale, q0 + qi, k0 + kj, n, mask);
        const float p = expf(sv - lse_s[qi]);  // 0 for a key past n (sv = -inf)
        Ds[qi * LDT + kj] = p * (dp[i][j] - del_s[qi]) * scale;
      }
    }
    __syncthreads();
    attn::tile_pv<DP>(dq, Ds, Ks, r, c);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= n) continue;
    float* drow = dqkv + ((size_t)b * n + row) * ld + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) drow[col] = dq[i][j];
    }
  }
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
                    dkv_smem<DP>(), qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale, st);
}

template <int DP>
cudaError_t launch_dq(const float* qkv, const float* g, const float* lse, const float* delta,
                      const unsigned char* mask, float* dqkv, int B, int n, int H, int d,
                      float scale, cudaStream_t st) {
  return launch_bwd(mask != nullptr ? bwd_dq_kernel<DP, true> : bwd_dq_kernel<DP, false>,
                    dq_smem<DP>(), qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale, st);
}

}  // namespace

extern "C" int qkv_attention_fwd(const float* qkv, const unsigned char* mask, float* out,
                                 float* lse, int B, int n, int H, int d, float scale,
                                 void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, attn::launch_fwd<DP, float>(qkv, mask, out, lse, B, n, H, d, scale,
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
