// The pieces of K1's attention that its split-TF32 kernels (qkv_fwd_tf32.cuh,
// qkv_bwd_tf32.cuh) and K7's (flash_tf32.cuh) share: the head-dim bound and
// its dispatch, the argument check, and the score rule.
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

constexpr int MAX_HEAD_DIM = 128;
constexpr float MASKED = -1e30f;  // the TPU kernels' fill for a masked score

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

inline bool bad_dims(int B, int n, int H, int d) {
  return B < 1 || n < 1 || H < 1 || d < 1 || d > MAX_HEAD_DIM || B > 65535 || H > 65535;
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
