// Attention on the qkv projection's native layout, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of `fused_qkv_attention`
// (vit4hep_tpu/ops/fused_qkv_attention.py:178): the forward `_fused_fwd`
// (:190; per-head `_fused_kernel` :58 and head-packed `_packed_kernel` :94,
// pallas_call :231) and the backward `_fused_bwd` (:300; `_bwd_kernel` :252,
// pallas_call :328). The TPU kernels hold one batch element's whole
// (N, 3*H*D) panel and each head's (N, N) scores in VMEM. A CTA here has at
// most 227 KB of shared memory, so K/V (forward, dQ) and Q/dO (dK/dV) are
// streamed through shared memory in 64-row tiles with an online softmax:
// there is no limit on N, and the (N, N) scores never reach device memory.
// The head-packed TPU body only existed to feed a 128-lane matrix unit at
// head_dim <= 64; one template per padded head dim (16..128 in steps of 16)
// serves every head dim up to MAX_HEAD_DIM = 128 here.
//
// Kernels (each launched by its own wrapper in ops/fused_qkv_attention.py):
//  - fwd_kernel<DP>: one CTA per (query tile, head, batch). Writes the
//    merged (B, N, H*D) context and the f32 log-sum-exp (B, H, N).
//  - bwd_delta_kernel: delta = rowsum(dO * O) per (batch, head, query), one
//    warp per row. (rowsum(dP * P) of the TPU kernel equals rowsum(dO * O);
//    this kernel uses the latter, so dK/dV need no second pass over keys.)
//  - bwd_dkv_kernel<DP>: one CTA per (key tile, head, batch), looping over
//    query tiles: P^T = exp(K Q^T * s - lse), dV += P^T dO,
//    dS^T = P^T (V dO^T - delta) * s, dK += dS^T Q.
//  - bwd_dq_kernel<DP>: one CTA per (query tile, head, batch), looping over
//    key tiles: dQ += dS K.
// dK/dV and dQ are written straight into the (B, N, 3*H*D) dqkv panel at the
// q/k/v column offsets of `_fused_kernel_masked` (:70-73); every element is
// written once, so there are no atomics and the result is deterministic.
//
// What bounds it at the ds2 training shape (B = 64, N = 135, H = 6, d = 80):
// the forward does 4*B*H*N^2*d = 2.24 GFLOP on ~67 MB, the backward ~5.6
// GFLOP on ~120 MB. This first version computes in f32 on the CUDA cores
// (the TPU kernels' interpret-mode precision), so it is bound by the f32
// FMA rate (67 TFLOP/s): ~33 us forward, ~84 us backward at best. The
// products are register-tiled: 256 threads as 16 row groups x 16 column
// groups, each thread 4 rows x 4 columns of a 64 x 64 score tile, operands
// read from shared memory as float4 (rows padded to DP + 4 floats, which
// keeps every quarter-warp's 16-byte reads on distinct banks). Tensor-core
// (bf16 mma/wgmma) products and cp.async/TMA pipelining are the levers for
// a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;       // query / key rows per tile
constexpr int THREADS = 256;   // 16 row groups x 16 column groups
constexpr int LDT = TILE + 4;  // leading dimension of the 64 x 64 score tiles
constexpr int MAX_HEAD_DIM = 128;

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// rows [row0, row0 + TILE) of a row-major panel with row stride ld, the d
// columns starting at g, into a TILE x (DP + 4) shared tile; rows >= n and
// columns >= d are zero-filled
template <int DP>
__device__ __forceinline__ void load_tile(float* s, const float* g, int row0, int n, size_t ld,
                                          int d) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < TILE * DP; idx += THREADS) {
    const int r = idx / DP, k = idx - r * DP;
    const int row = row0 + r;
    s[r * LD + k] = (row < n && k < d) ? g[(size_t)row * ld + k] : 0.f;
  }
}

// acc[i][j] += A[r*4 + i, :] . B[c + 16*j, :] over the DP columns of two
// TILE x (DP + 4) shared tiles
template <int DP>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A, const float* B,
                                         int r, int c) {
  constexpr int LD = DP + 4;
#pragma unroll 4
  for (int k = 0; k < DP; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (r * 4 + i) * LD + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (c + 16 * j) * LD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][j] += sum_t P[r*4 + i, t] * V[t, c + 16*j] for a TILE x LDT score
// tile P and a TILE x (DP + 4) tile V
template <int DP>
__device__ __forceinline__ void tile_pv(float (&acc)[4][DP / 16], const float* P, const float* V,
                                        int r, int c) {
  constexpr int LD = DP + 4, CPT = DP / 16;
#pragma unroll 2
  for (int t = 0; t < TILE; t += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(P + (r * 4 + i) * LDT + t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) v[j] = V[(t + q) * LD + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = comp(p[i], q);
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pi, v[j], acc[i][j]);
      }
    }
  }
}

// reductions over the 16 lanes of one row group (a half-warp)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DP>
constexpr size_t fwd_smem() { return (size_t)(3 * TILE * (DP + 4) + TILE * LDT) * sizeof(float); }
template <int DP>
constexpr size_t dkv_smem() {
  return (size_t)(4 * TILE * (DP + 4) + 2 * TILE * LDT + 2 * TILE) * sizeof(float);
}
template <int DP>
constexpr size_t dq_smem() {
  return (size_t)(4 * TILE * (DP + 4) + TILE * LDT + 2 * TILE) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ lse,
           int n, int H, int d, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 4, CPT = DP / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const size_t ld = (size_t)3 * H * d;
  const float* base = qkv + (size_t)b * n * ld;

  load_tile<DP>(Qs, base + (size_t)h * d, q0, n, ld, d);
  float o[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<DP>(Ks, base + (size_t)(H + h) * d, k0, n, ld, d);
    load_tile<DP>(Vs, base + (size_t)(2 * H + h) * d, k0, n, ld, d);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt<DP>(s, Qs, Ks, r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + c + 16 * j < n) ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      // every tile holds >= 1 valid key (k0 < n), so the tile max is finite
      const float mn = fmaxf(m[i], half_warp_max(mt));
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      m[i] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ls += s[i][j];
        Ps[(r * 4 + i) * LDT + c + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(ls);
#pragma unroll
      for (int j = 0; j < CPT; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    tile_pv<DP>(o, Ps, Vs, r, c);
  }

  const size_t hd = (size_t)H * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
    float* orow = out + ((size_t)b * n + row) * hd + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) orow[col] = o[i][j] * inv;
    }
    if (c == 0) lse[((size_t)b * H + h) * n + row] = m[i] + logf(l[i]);
  }
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

template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dqkv, int n, int H, int d, float scale) {
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

  load_tile<DP>(Ks, base + (size_t)(H + h) * d, k0, n, ld, d);
  load_tile<DP>(Vs, base + (size_t)(2 * H + h) * d, k0, n, ld, d);
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < n; q0 += TILE) {
    __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
    load_tile<DP>(Qs, base + (size_t)h * d, q0, n, ld, d);
    load_tile<DP>(Gs, gbase + (size_t)h * d, q0, n, hd, d);
    if (threadIdx.x < TILE) {
      const int q = q0 + threadIdx.x;
      lse_s[threadIdx.x] = q < n ? lse_bh[q] : 0.f;
      del_s[threadIdx.x] = q < n ? del_bh[q] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<DP>(s, Ks, Qs, r, c);   // s[key][query]
    tile_abt<DP>(dp, Vs, Gs, r, c);  // dp[key][query]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = c + 16 * j;
        const float p = (q0 + qi < n) ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
        Ps[(r * 4 + i) * LDT + qi] = p;
        Ds[(r * 4 + i) * LDT + qi] = p * (dp[i][j] - del_s[qi]) * scale;
      }
    }
    __syncthreads();
    tile_pv<DP>(dv, Ps, Gs, r, c);
    tile_pv<DP>(dk, Ds, Qs, r, c);
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

template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dqkv, int n, int H, int d, float scale) {
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

  load_tile<DP>(Qs, base + (size_t)h * d, q0, n, ld, d);
  load_tile<DP>(Gs, g + (size_t)b * n * hd + (size_t)h * d, q0, n, hd, d);
  if (threadIdx.x < TILE) {
    const int q = q0 + threadIdx.x;
    const size_t bh = ((size_t)b * H + h) * n;
    lse_s[threadIdx.x] = q < n ? lse[bh + q] : 0.f;
    del_s[threadIdx.x] = q < n ? delta[bh + q] : 0.f;
  }
  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the previous tile's K/dS reads are done
    load_tile<DP>(Ks, base + (size_t)(H + h) * d, k0, n, ld, d);
    load_tile<DP>(Vs, base + (size_t)(2 * H + h) * d, k0, n, ld, d);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<DP>(s, Qs, Ks, r, c);   // s[query][key]
    tile_abt<DP>(dp, Gs, Vs, r, c);  // dp[query][key]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = c + 16 * j;
        const float p = (k0 + kj < n) ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
        Ds[qi * LDT + kj] = p * (dp[i][j] - del_s[qi]) * scale;
      }
    }
    __syncthreads();
    tile_pv<DP>(dq, Ds, Ks, r, c);
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

bool bad_dims(int B, int n, int H, int d) {
  return B < 1 || n < 1 || H < 1 || d < 1 || d > MAX_HEAD_DIM || B > 65535 || H > 65535;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch_fwd(const float* qkv, float* out, float* lse, int B, int n, int H, int d,
                       float scale, cudaStream_t st) {
  cudaError_t e = prepare(fwd_kernel<DP>, fwd_smem<DP>());
  if (e != cudaSuccess) return e;
  fwd_kernel<DP><<<dim3((n + TILE - 1) / TILE, H, B), THREADS, fwd_smem<DP>(), st>>>(
      qkv, out, lse, n, H, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const float* qkv, const float* g, const float* lse, const float* delta,
                       float* dqkv, int B, int n, int H, int d, float scale, cudaStream_t st) {
  cudaError_t e = prepare(bwd_dkv_kernel<DP>, dkv_smem<DP>());
  if (e != cudaSuccess) return e;
  bwd_dkv_kernel<DP><<<dim3((n + TILE - 1) / TILE, H, B), THREADS, dkv_smem<DP>(), st>>>(
      qkv, g, lse, delta, dqkv, n, H, d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const float* qkv, const float* g, const float* lse, const float* delta,
                      float* dqkv, int B, int n, int H, int d, float scale, cudaStream_t st) {
  cudaError_t e = prepare(bwd_dq_kernel<DP>, dq_smem<DP>());
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<DP><<<dim3((n + TILE - 1) / TILE, H, B), THREADS, dq_smem<DP>(), st>>>(
      qkv, g, lse, delta, dqkv, n, H, d, scale);
  return cudaGetLastError();
}

}  // namespace

// the padded head dim DP = 16 * ceil(d / 16) selects the instantiation
#define K1_DISPATCH(d, launch, ...)                 \
  switch (((d) + 15) / 16) {                        \
    case 1: return (int)launch<16>(__VA_ARGS__);    \
    case 2: return (int)launch<32>(__VA_ARGS__);    \
    case 3: return (int)launch<48>(__VA_ARGS__);    \
    case 4: return (int)launch<64>(__VA_ARGS__);    \
    case 5: return (int)launch<80>(__VA_ARGS__);    \
    case 6: return (int)launch<96>(__VA_ARGS__);    \
    case 7: return (int)launch<112>(__VA_ARGS__);   \
    case 8: return (int)launch<128>(__VA_ARGS__);   \
    default: return (int)cudaErrorInvalidValue;     \
  }

extern "C" int qkv_attention_fwd(const float* qkv, float* out, float* lse, int B, int n, int H,
                                 int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  K1_DISPATCH(d, launch_fwd, qkv, out, lse, B, n, H, d, scale,
              static_cast<cudaStream_t>(stream))
}

extern "C" int qkv_attention_bwd_delta(const float* g, const float* o, float* delta, int B, int n,
                                       int H, int d, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * n * H;
  const int per_block = 8;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bwd_delta_kernel<<<(unsigned)blocks, per_block * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      g, o, delta, B, n, H, d);
  return (int)cudaGetLastError();
}

extern "C" int qkv_attention_bwd_dkv(const float* qkv, const float* g, const float* lse,
                                     const float* delta, float* dqkv, int B, int n, int H, int d,
                                     float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  K1_DISPATCH(d, launch_dkv, qkv, g, lse, delta, dqkv, B, n, H, d, scale,
              static_cast<cudaStream_t>(stream))
}

extern "C" int qkv_attention_bwd_dq(const float* qkv, const float* g, const float* lse,
                                    const float* delta, float* dqkv, int B, int n, int H, int d,
                                    float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  K1_DISPATCH(d, launch_dq, qkv, g, lse, delta, dqkv, B, n, H, d, scale,
              static_cast<cudaStream_t>(stream))
}
