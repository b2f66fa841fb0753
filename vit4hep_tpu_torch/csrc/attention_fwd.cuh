// Streaming attention forward, shared by K1 (qkv_attention.cu: the qkv
// projection's native layout, f32 context + log-sum-exp) and K7
// (flash_attention.cu: separated (B, H, N, D) tensors, f32 + log-sum-exp).
//
// One CTA per (64-query tile, head, batch element). K and V stream through
// shared memory in 64-row tiles with an online softmax, so there is no limit
// on N and the (N, N) scores never reach device memory. The products run in
// f32 on the CUDA cores, register-tiled: 256 threads as 16 row groups x 16
// column groups, each thread 4 rows x 4 columns of a 64 x 64 score tile,
// operands read from shared memory as float4 (rows padded to DP + 4 floats,
// which keeps every quarter-warp's 16-byte reads on distinct banks). One
// template per padded head dim DP = 16 * ceil(d / 16) serves every head dim
// up to MAX_HEAD_DIM.
//
// The optional mask is the TPU kernels' shared (N, N) uint8 matrix,
// row-major, 1 = attend. A masked score becomes the finite -1e30 of
// `jnp.where(mask, s, -1e30)` (vit4hep_tpu/ops/fused_qkv_attention.py:80),
// not -inf: a row whose every key is masked gets the mean of V, as in JAX.
// Keys past N are -inf and weigh 0. The online rescale exp(m_old - m_new)
// stays exact across the two: a tile whose keys are all masked for a row
// has max -1e30, which either sets the running max (no real key yet; the
// next real tile's rescale exp(-1e30 - m) = 0 wipes it) or leaves it (a
// real max m; its weights exp(-1e30 - m) = 0 add nothing).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int TILE = 64;       // query / key rows per tile
constexpr int THREADS = 256;   // 16 row groups x 16 column groups
constexpr int LDT = TILE + 4;  // leading dimension of the 64 x 64 score tiles
constexpr int MAX_HEAD_DIM = 128;
constexpr float MASKED = -1e30f;  // the TPU kernels' fill for a masked score

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

// the scaled score of (query, key), or MASKED where the mask forbids it
// (-inf with ZERO_MASKED: K7's backward, where a masked key weighs 0); -inf
// for a key past n. A query past n (a zero-filled tile row) reads no mask
// byte. HAS_MASK is a template parameter so that the unmasked kernels carry
// no mask logic (and no registers for it).
template <bool HAS_MASK, bool ZERO_MASKED = false>
__device__ __forceinline__ float score(float s, float scale, int query, int key, int n,
                                       const unsigned char* __restrict__ mask) {
  if (key >= n) return -INFINITY;
  if (HAS_MASK && query < n && !mask[(size_t)query * n + key])
    return ZERO_MASKED ? -INFINITY : MASKED;
  return s * scale;
}

template <int DP>
constexpr size_t fwd_smem() { return (size_t)(3 * TILE * (DP + 4) + TILE * LDT) * sizeof(float); }

// one 64-query tile of one (batch, head): q, k and v are that cell's row-0
// pointers into panels of row stride ld (unit column stride), o its output
// row 0 with row stride ldo, lse its log-sum-exp row (or nullptr); the
// query tile starts at q0. Shared by K1 (qkv panel) and K7 (separated
// (B, H, N, D) tensors): the pad and mask semantics above are both's.
template <int DP, bool HAS_MASK>
__device__ __forceinline__ void fwd_tile(const float* __restrict__ qg,
                                         const float* __restrict__ kg,
                                         const float* __restrict__ vg, size_t ld,
                                         const unsigned char* __restrict__ mask,
                                         float* __restrict__ og, size_t ldo,
                                         float* __restrict__ lse_bh, int q0, int n, int d,
                                         float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 4, CPT = DP / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;

  load_tile<DP>(Qs, qg, q0, n, ld, d);
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
    load_tile<DP>(Ks, kg, k0, n, ld, d);
    load_tile<DP>(Vs, vg, k0, n, ld, d);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt<DP>(s, Qs, Ks, r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int query = q0 + r * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score<HAS_MASK>(s[i][j], scale, query, k0 + c + 16 * j, n, mask);
        mt = fmaxf(mt, s[i][j]);
      }
      // every tile holds >= 1 key below n (k0 < n), so the tile max is
      // finite: a real score or MASKED
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
    float* orow = og + (size_t)row * ldo;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) orow[col] = o[i][j] * inv;
    }
    if (lse_bh != nullptr && c == 0) lse_bh[row] = m[i] + logf(l[i]);
  }
}

// out (B, N, H*D) merged f32 context; lse (B, H, N) f32, or nullptr (K1
// and K7 always pass one; the test stays because without it nvcc compiles
// both forwards to other code, and K1's ran up to 4% slower on the H100)
template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ qkv, const unsigned char* __restrict__ mask,
           float* __restrict__ out, float* __restrict__ lse, int n, int H, int d, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t ld = (size_t)3 * H * d, hd = (size_t)H * d;
  const float* base = qkv + (size_t)b * n * ld;
  fwd_tile<DP, HAS_MASK>(base + (size_t)h * d, base + (size_t)(H + h) * d,
                         base + (size_t)(2 * H + h) * d, ld, mask,
                         out + (size_t)b * n * hd + (size_t)h * d, hd,
                         lse == nullptr ? nullptr : lse + ((size_t)b * H + h) * n,
                         blockIdx.x * TILE, n, d, scale);
}

inline bool bad_dims(int B, int n, int H, int d) {
  return B < 1 || n < 1 || H < 1 || d < 1 || d > MAX_HEAD_DIM || B > 65535 || H > 65535;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, bool HAS_MASK>
cudaError_t launch_fwd_as(const float* qkv, const unsigned char* mask, float* out, float* lse,
                          int B, int n, int H, int d, float scale, cudaStream_t st) {
  cudaError_t e = prepare(fwd_kernel<DP, HAS_MASK>, fwd_smem<DP>());
  if (e != cudaSuccess) return e;
  fwd_kernel<DP, HAS_MASK><<<dim3((n + TILE - 1) / TILE, H, B), THREADS, fwd_smem<DP>(), st>>>(
      qkv, mask, out, lse, n, H, d, scale);
  return cudaGetLastError();
}

// the masked instantiation for a mask, the unmasked one for nullptr
template <int DP>
cudaError_t launch_fwd(const float* qkv, const unsigned char* mask, float* out, float* lse, int B,
                       int n, int H, int d, float scale, cudaStream_t st) {
  return mask != nullptr ? launch_fwd_as<DP, true>(qkv, mask, out, lse, B, n, H, d, scale, st)
                         : launch_fwd_as<DP, false>(qkv, mask, out, lse, B, n, H, d, scale, st);
}

}  // namespace attn

// Returns, as an int, the value of the expression for the padded head dim
// DP = 16 * ceil(d / 16) (a constexpr named DP inside the expression), or
// cudaErrorInvalidValue past MAX_HEAD_DIM.
#define ATTN_DISPATCH(d, ...)                                         \
  switch (((d) + 15) / 16) {                                          \
    case 1: { constexpr int DP = 16; return (int)(__VA_ARGS__); }     \
    case 2: { constexpr int DP = 32; return (int)(__VA_ARGS__); }     \
    case 3: { constexpr int DP = 48; return (int)(__VA_ARGS__); }     \
    case 4: { constexpr int DP = 64; return (int)(__VA_ARGS__); }     \
    case 5: { constexpr int DP = 80; return (int)(__VA_ARGS__); }     \
    case 6: { constexpr int DP = 96; return (int)(__VA_ARGS__); }     \
    case 7: { constexpr int DP = 112; return (int)(__VA_ARGS__); }    \
    case 8: { constexpr int DP = 128; return (int)(__VA_ARGS__); }    \
    default: return (int)cudaErrorInvalidValue;                       \
  }
