// The slab descriptors and kernel arguments of the port's bf16 attention
// kernels: K6 (flash_qkv_attention.cu: its forward in attention_wgmma.cuh,
// its backward in flash_bwd_wgmma.cuh) and K8 (vmem_attention.cu, over
// vmem_wgmma.cuh).
//
// Tensors are addressed as (batch, head, row, column) slabs with the column
// stride 1: separated (B, H, N, D) tensors, strided views of them, and the
// native (B, N, 3*H*D) qkv panel (a head's columns inside a 3*H*D-wide row)
// all fit one descriptor, so neither caller copies its layout.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace amma {

constexpr int MAX_HEAD_DIM = 128;
constexpr float MASKED = -1e30f;   // the TPU kernels' fill for a masked score

// element (b, h, row, col) at p[b * sb + h * sh + row * sn + col]
struct Slab {
  const float* p;
  long long sb, sh, sn;
};
struct OutSlab {
  float* p;
  long long sb, sh, sn;
};

struct Args {
  Slab q, k, v, g;       // inputs (g: the output's gradient)
  OutSlab o, dq, dk, dv;  // outputs
  Slab lse;              // the forward's log-sum-exp (column 0 of each row)
  OutSlab lse_out;
  Slab rt;               // the backward's row term (K6: delta; K8: from its dQ pass)
  OutSlab rt_out;
  const unsigned char* mask;  // shared (n, n) uint8, row-major, 1 = attend; or nullptr
  int n, d;
  float scale;
};

__device__ __forceinline__ const float* base(const Slab& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}
__device__ __forceinline__ float* base(const OutSlab& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}

inline bool bad_dims(int B, int n, int H, int d) {
  return B < 1 || n < 1 || H < 1 || d < 1 || d > MAX_HEAD_DIM || B > 65535 || H > 65535;
}

}  // namespace amma

// Returns, as an int, the value of the expression for the padded head dim
// DP = 16 * ceil(d / 16) (a constexpr named DP inside the expression), or
// cudaErrorInvalidValue past MAX_HEAD_DIM.
#define AMMA_DISPATCH(d, ...)                                         \
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
