// Streaming attention backward, shared by K1 (qkv_attention.cu: the qkv
// projection's native layout) and K7 (flash_attention.cu: separated
// (B, H, N, D) tensors): the dK/dV pass over one 64-key tile and the dQ
// pass over one 64-query tile of one (batch, head), the products
// register-tiled in f32 on the CUDA cores as in attention_fwd.cuh.
//
// A cell's q, k, v (and dO) are given as row-0 pointers into panels of a
// row stride (unit column stride); the gradients go to row-0 pointers with
// their own row stride. Each key (dK/dV) or query (dQ) row belongs to one
// CTA, so every element is written once: no atomics, a deterministic
// result.
//
// P = exp(s - lse) is rebuilt from the forward's log-sum-exp; delta =
// rowsum(dO * O) comes from the caller. Keys past N weigh 0. Masked keys
// take one of two semantics, a template parameter:
//  - K1's (ZERO_MASKED false): a masked score is the -1e30 of
//    `jnp.where(mask, s, -1e30)`, so its p = exp(-1e30 - lse) is 0, except
//    on a row whose every key is masked: its lse rounds to -1e30 in f32,
//    JAX rebuilds p = 1 for each of its N keys and rowsum(dP * P) =
//    N * rowsum(dO * O), so that row's delta is scaled by N;
//  - K7's (ZERO_MASKED true): p = where(valid, exp(s - lse), 0)
//    (vit4hep_tpu/ops/flash_attention.py:110, :150): a masked key weighs 0,
//    so a wholly masked row adds nothing to dK and dV and its dQ is 0.

#pragma once

#include "attention_fwd.cuh"

namespace attn {

template <int DP>
constexpr size_t dkv_smem() {
  return (size_t)(4 * TILE * (DP + 4) + 2 * TILE * LDT + 2 * TILE) * sizeof(float);
}
template <int DP>
constexpr size_t dq_smem() {
  return (size_t)(4 * TILE * (DP + 4) + TILE * LDT + 2 * TILE) * sizeof(float);
}

// lse and delta of query tile [q0, q0 + TILE) of one (batch, head) into
// shared memory: 0 past n; under K1's semantics a wholly masked row's delta
// times n (see above)
template <bool HAS_MASK, bool ZERO_MASKED>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s, const float* lse_bh,
                                               const float* del_bh, int q0, int n) {
  if (threadIdx.x < TILE) {
    const int q = q0 + threadIdx.x;
    const float ls = q < n ? lse_bh[q] : 0.f;
    const float dl = q < n ? del_bh[q] : 0.f;
    lse_s[threadIdx.x] = ls;
    del_s[threadIdx.x] = (HAS_MASK && !ZERO_MASKED && ls == MASKED) ? dl * (float)n : dl;
  }
}

// dK and dV of key tile [k0, k0 + TILE), looping over the query tiles:
// P^T = exp(K Q^T * s - lse), dV += P^T dO, dS^T = P^T (V dO^T - delta) * s,
// dK += dS^T Q
template <int DP, bool HAS_MASK, bool ZERO_MASKED>
__device__ __forceinline__ void bwd_dkv_tile(
    const float* __restrict__ qg, const float* __restrict__ kg, const float* __restrict__ vg,
    size_t ld, const float* __restrict__ gg, size_t ldg, const float* __restrict__ lse_bh,
    const float* __restrict__ del_bh, const unsigned char* __restrict__ mask,
    float* __restrict__ dkg, float* __restrict__ dvg, size_t ldo, int k0, int n, int d,
    float scale) {
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
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;

  load_tile<DP>(Ks, kg, k0, n, ld, d);
  load_tile<DP>(Vs, vg, k0, n, ld, d);
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < n; q0 += TILE) {
    __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
    load_tile<DP>(Qs, qg, q0, n, ld, d);
    load_tile<DP>(Gs, gg, q0, n, ldg, d);
    load_row_stats<HAS_MASK, ZERO_MASKED>(lse_s, del_s, lse_bh, del_bh, q0, n);
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
      const int key = k0 + r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = c + 16 * j, query = q0 + qi;
        const float sv = score<HAS_MASK, ZERO_MASKED>(s[i][j], scale, query, key, n, mask);
        const float p = query < n ? expf(sv - lse_s[qi]) : 0.f;  // 0 for a key past n
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
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) {
        dkg[(size_t)row * ldo + col] = dk[i][j];
        dvg[(size_t)row * ldo + col] = dv[i][j];
      }
    }
  }
}

// dQ of query tile [q0, q0 + TILE), looping over the key tiles: dQ += dS K
template <int DP, bool HAS_MASK, bool ZERO_MASKED>
__device__ __forceinline__ void bwd_dq_tile(
    const float* __restrict__ qg, const float* __restrict__ kg, const float* __restrict__ vg,
    size_t ld, const float* __restrict__ gg, size_t ldg, const float* __restrict__ lse_bh,
    const float* __restrict__ del_bh, const unsigned char* __restrict__ mask,
    float* __restrict__ dqg, size_t ldo, int q0, int n, int d, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 4, CPT = DP / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + TILE * LD;
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ds = Vs + TILE * LD;
  float* lse_s = Ds + TILE * LDT;
  float* del_s = lse_s + TILE;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;

  load_tile<DP>(Qs, qg, q0, n, ld, d);
  load_tile<DP>(Gs, gg, q0, n, ldg, d);
  load_row_stats<HAS_MASK, ZERO_MASKED>(lse_s, del_s, lse_bh, del_bh, q0, n);
  float dq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the previous tile's K/dS reads are done
    load_tile<DP>(Ks, kg, k0, n, ld, d);
    load_tile<DP>(Vs, vg, k0, n, ld, d);
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
        const float sv =
            score<HAS_MASK, ZERO_MASKED>(s[i][j], scale, q0 + qi, k0 + kj, n, mask);
        const float p = expf(sv - lse_s[qi]);  // 0 for sv = -inf
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
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) dqg[(size_t)row * ldo + col] = dq[i][j];
    }
  }
}

}  // namespace attn
