// K2v's attention on wgmma, for Hopper (sm_90a): softmax(q k^T * scale) v
// per (batch element, head) straight off the ViT's (B, N, 3*H*D) f32 qkv
// panel, written as the merged (B, N, H*D) bf16 context that the
// out-projection's TMA reads. No log-sum-exp.
//
// Replaces the attention of the TPU kernel `_vit_kernel`
// (vit4hep_tpu/ops/fused_dit_block.py:1315; masked `_vit_kernel_masked`
// :1281, grouped `_vit_kernel_g` :1325; pallas_call :1463 / :1423), whose
// contract (`_attn_merged`, :67) this keeps: bf16 multiplicands, f32
// statistics and accumulation; a masked score is the finite -1e30, so a row
// whose every key is masked gets the mean of V; a key past N weighs exactly
// 0. K2b (`fused_dit_block`), K2s (`fused_dit_stack`) and K10's harness
// launch the same kernel.
//
// What bounds it: at ds3 serving (qkv (256, 450, 1440) f32) it must read the
// 664 MB panel and write 111 MB of bf16 context (0.231 ms at 3.35 TB/s)
// against 99.5 GFLOP on the bf16 tensor cores (0.101 ms): bytes. So, as in
// K6's forward (attention_wgmma.cuh, whose pieces this follows), a K/V tile
// is read once per CTA and converted to bf16 once, and the scores never
// leave the registers:
//  - WG warpgroups of 64 query rows each (64 * WG rows a CTA); each thread
//    holds two query rows (l/4 and l/4 + 8 of its warp's 16) in the wgmma
//    accumulator layout, so a row's max and sum take two quad shuffles;
//  - Q is read once from the panel into registers as the bf16 A operand of
//    S = Q K^T;
//  - K and V tiles of 64 keys stream through a ring of two f32 stages filled
//    by cp.async (16-byte vectors when d % 4 == 0), the next tile in flight
//    while this one is used; all threads convert a tile once into the bf16
//    operands wgmma reads (K K-major in 16-column chunks with the 32-byte
//    swizzle, V transposed to V^T K-major with the 128-byte swizzle);
//  - S = Q K^T is wgmma m64n64k16 (A from registers); scale, mask and the pad
//    guard in registers; the online softmax rescales O (64 x DP f32) in
//    registers; P is packed to bf16 in registers as the A operand of O += P V
//    (m64nDPk16);
//  - O / l is written from the registers as bf16 pairs.
// A warpgroup whose 64 rows all lie past N (the tail CTA of a short head)
// joins the loads, conversions and barriers but issues no product.
//
// The rows a CTA takes (WG) is the launch's choice (vit_forward.cu): the
// CTAs of one (element, head) each read its whole K and V, so taller CTAs
// read and convert K/V fewer times, while a ragged last CTA wastes up to 64
// * WG - 1 rows of products. The loader and the operand conversions are
// K6's (attention_wgmma.cuh) made generic in the thread count; K6 keeps its
// own, so that its code stays as it was.
//
// exp is the fast __expf, as in K6's and K8's wgmma kernels: its error (a
// few ulp) sits far below the bf16 rounding p takes next.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace vattn {

constexpr int KT = 64;               // keys of one tile
constexpr int RING = 2;              // f32 stages of the K/V ring
constexpr int MAX_WG = 3;            // warpgroups of one CTA at most
constexpr float MASKED = -1e30f;     // the TPU kernel's fill for a masked score

template <int DP>
__host__ __device__ constexpr int kb_bytes() {  // a bf16 operand tile: 64 keys x DP
  return KT * DP * 2;
}
template <int DP>
__host__ __device__ constexpr int ld_f32() {  // row stride (floats) of an f32 stage
  return DP + 4;
}
template <int DP>
__host__ __device__ constexpr int stage_floats() {  // K's 64 rows, then V's
  return 2 * KT * ld_f32<DP>();
}
// the bf16 K chunks and V^T, then the ring's f32 stages, and the slack that
// aligns the base to the 128-byte swizzle's 1024-byte period
template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)2 * kb_bytes<DP>() + (size_t)RING * stage_floats<DP>() * 4 + 1024;
}
static_assert(smem_bytes<128>() <= 232448, "the widest head dim must fit a CTA");
static_assert(kb_bytes<16>() % 1024 == 0, "operand tiles keep the swizzle period");

// tile [k0, k0 + 64) of K and of V (row stride ld) into an f32 stage, zero
// past n and past d; NT threads
template <int DP, int NT>
__device__ __forceinline__ void load_kv(float* st, const float* kb, const float* vb,
                                        long long ld, int k0, int n, int d, bool vec) {
  constexpr int LDF = ld_f32<DP>();
  if (vec) {  // lane c copies 16-byte chunk c of rows warp, warp + NT/32, ...
    constexpr int C = DP / 4, WARPS = NT / 32;
    static_assert(C <= 32, "a row's chunks fit one warp");
    const int lane = threadIdx.x % 32, c = 4 * lane;
    if (lane >= C) return;
#pragma unroll 4
    for (int rr = threadIdx.x / 32; rr < 2 * KT; rr += WARPS) {
      const int which = rr / KT, key = k0 + rr % KT;
      const bool in = key < n && c < d;
      const float* src = (which ? vb : kb) + (in ? (long long)key * ld + c : 0);
      hop::cp_async16(st + rr * LDF + c, src, in ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < 2 * KT * DP; u += NT) {
      const int rr = u / DP, c = u % DP, key = k0 + rr % KT;
      const bool in = key < n && c < d;
      const float* src = (rr / KT ? vb : kb) + (in ? (long long)key * ld + c : 0);
      hop::cp_async4(st + rr * LDF + c, src, in ? 4 : 0);
    }
  }
}

// K's 64 f32 rows into the K-major B operand of S = Q K^T: row r, columns
// 8c .. 8c+7 to 16-column chunk c / 2 (64 rows x 32 B), 16-byte half
// (c % 2) ^ ((r / 4) % 2) (the 32-byte swizzle)
template <int DP, int NT>
__device__ __forceinline__ void convert_k(unsigned char* dst, const float* rows) {
  constexpr int LDF = ld_f32<DP>();
  for (int u = threadIdx.x; u < KT * DP / 8; u += NT) {
    const int r = u % KT, c = u / KT;
    const float4 a = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c);
    const float4 b = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c + 4);
    const uint4 v = make_uint4(hop::pack_bf16(a.x, a.y), hop::pack_bf16(a.z, a.w),
                               hop::pack_bf16(b.x, b.y), hop::pack_bf16(b.z, b.w));
    *reinterpret_cast<uint4*>(dst + (c / 2) * KT * 32 + r * 32 +
                              (((c & 1) ^ ((r >> 2) & 1)) << 4)) = v;
  }
}

// V's 64 f32 rows transposed into the K-major B operand of O += P V: keys
// 8j .. 8j+7 of column e to row e (128 B), 16-byte chunk j ^ (e % 8) (the
// 128-byte swizzle)
template <int DP, int NT>
__device__ __forceinline__ void convert_v(unsigned char* dst, const float* rows) {
  constexpr int LDF = ld_f32<DP>();
  for (int u = threadIdx.x; u < KT * DP / 8; u += NT) {
    const int e = u % DP, j = u / DP;
    const float* col = rows + 8 * j * LDF + e;
    const uint4 v = make_uint4(hop::pack_bf16(col[0], col[LDF]),
                               hop::pack_bf16(col[2 * LDF], col[3 * LDF]),
                               hop::pack_bf16(col[4 * LDF], col[5 * LDF]),
                               hop::pack_bf16(col[6 * LDF], col[7 * LDF]));
    *reinterpret_cast<uint4*>(dst + e * 128 + ((j ^ (e & 7)) << 4)) = v;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// columns (c, c + 1) of query row `row` as a bf16 pair, 0 past n and past d
__device__ __forceinline__ uint32_t q_pair(const float* qb, long long ld, int row, int c, int n,
                                           int d) {
  const float* p = qb + (long long)row * ld;
  const bool in = row < n;
  return hop::pack_bf16(in && c < d ? p[c] : 0.f, in && c + 1 < d ? p[c + 1] : 0.f);
}

// (row, key) may attend: always without a mask; a row past n reads no byte
template <bool HAS_MASK>
__device__ __forceinline__ bool attends(int row, int key, int n, const unsigned char* mask) {
  return !HAS_MASK || row >= n || mask[(size_t)row * n + key] != 0;
}

// WG warpgroups, 64 * WG query rows of one (element, head)
template <int DP, int WG, bool HAS_MASK>
__global__ void __launch_bounds__(128 * WG, 1)
    vit_attn_wgmma_kernel(const float* __restrict__ qkv, const unsigned char* __restrict__ mask,
                          __nv_bfloat16* __restrict__ out, int n, int H, int d, float scale) {
  static_assert(DP % 16 == 0 && DP >= 16 && DP <= 128, "head dims 1..128 in steps of 16");
  static_assert(WG >= 1 && WG <= MAX_WG, "one to three warpgroups");
  constexpr int NT = 128 * WG, ROWS = 64 * WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kb16 = smem;
  unsigned char* vt16 = smem + kb_bytes<DP>();
  float* stages = reinterpret_cast<float*>(smem + 2 * kb_bytes<DP>());
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long ld = 3LL * H * d;
  const float* base = qkv + (long long)b * n * ld;
  const float* kbase = base + (long long)(H + h) * d;
  const float* vbase = base + (long long)(2 * H + h) * d;
  const int row0 = blockIdx.x * ROWS + wg * 64;
  const bool active = row0 < n;  // the same for the whole warpgroup
  const int r_lo = row0 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kbase) | reinterpret_cast<uintptr_t>(vbase)) &
                    15) == 0;
  const int tiles = (n + KT - 1) / KT;

  load_kv<DP, NT>(stages, kbase, vbase, ld, 0, n, d, vec);
  hop::cp_async_commit();

  // Q as the A operand: step c holds columns 16c .. 16c+15 of the two rows
  uint32_t qf[DP / 16][4];
  {
    const float* qb = base + (long long)h * d;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      qf[c][0] = q_pair(qb, ld, r_lo, 16 * c + c0, n, d);
      qf[c][1] = q_pair(qb, ld, r_hi, 16 * c + c0, n, d);
      qf[c][2] = q_pair(qb, ld, r_lo, 16 * c + c0 + 8, n, d);
      qf[c][3] = q_pair(qb, ld, r_hi, 16 * c + c0 + 8, n, d);
    }
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_lo = MASKED, m_hi = MASKED, l_lo = 0.f, l_hi = 0.f;  // a wholly masked row keeps p = 1
  const uint32_t kb_addr = hop::smem_u32(kb16), vt_addr = hop::smem_u32(vt16);

  for (int t = 0; t < tiles; ++t) {
    hop::cp_async_wait<0>();  // this thread's copies of tile t landed
    __syncthreads();  // everyone's; every warpgroup is done with tile t - 1's operands
    if (t + 1 < tiles)  // into the stage tile t - 1 was converted from
      load_kv<DP, NT>(stages + (t + 1) % RING * stage_floats<DP>(), kbase, vbase, ld,
                      (t + 1) * KT, n, d, vec);
    hop::cp_async_commit();
    const float* st = stages + t % RING * stage_floats<DP>();
    convert_k<DP, NT>(kb16, st);
    convert_v<DP, NT>(vt16, st + KT * ld_f32<DP>());
    hop::fence_proxy_async();
    __syncthreads();
    if (!active) continue;

    float s[KT / 2];
    hop::fence_regs(s);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      hop::Mma<KT, 0>::rs(s, qf[c], hop::desc(kb_addr + c * KT * 32, 16, 256, hop::SW32), c);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    // scale, mask, pad guard; the running max and sum of the two rows
    const int k0 = t * KT + 2 * (lane % 4);
    float t_lo = MASKED, t_hi = MASKED;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + e;
        const bool real = key < n;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = real && attends<HAS_MASK>(r_lo, key, n, mask) ? lo * scale : MASKED;
        hi = real && attends<HAS_MASK>(r_hi, key, n, mask) ? hi * scale : MASKED;
        t_lo = fmaxf(t_lo, lo);
        t_hi = fmaxf(t_hi, hi);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(t_lo)), mn_hi = fmaxf(m_hi, quad_max(t_hi));
    const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ls_lo = 0.f, ls_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real = k0 + 8 * j + e < n;  // the pad guard: exactly 0
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = real ? __expf(lo - mn_lo) : 0.f;
        hi = real ? __expf(hi - mn_hi) : 0.f;
        ls_lo += lo;
        ls_hi += hi;
      }
    }
    l_lo = l_lo * al_lo + quad_sum(ls_lo);
    l_hi = l_hi * al_hi + quad_sum(ls_hi);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al_lo;
      o[4 * j + 1] *= al_lo;
      o[4 * j + 2] *= al_hi;
      o[4 * j + 3] *= al_hi;
    }
    uint32_t pf[KT / 16][4];
#pragma unroll
    for (int k = 0; k < KT / 16; ++k) {
      pf[k][0] = hop::pack_bf16(s[8 * k], s[8 * k + 1]);
      pf[k][1] = hop::pack_bf16(s[8 * k + 2], s[8 * k + 3]);
      pf[k][2] = hop::pack_bf16(s[8 * k + 4], s[8 * k + 5]);
      pf[k][3] = hop::pack_bf16(s[8 * k + 6], s[8 * k + 7]);
    }
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < KT / 16; ++k)
      hop::Mma<DP, 0>::rs(o, pf[k], hop::desc(vt_addr + k * 32, 16, 1024, hop::SW128), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
  }
  if (!active) return;

  // O / l as bf16 pairs into the merged context (row stride H * d, head
  // column h * d): d even makes every pair 4-byte aligned
  const long long ldo = (long long)H * d;
  __nv_bfloat16* ob = out + (long long)b * n * ldo + (long long)h * d;
  const bool pairs = d % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = hh ? r_hi : r_lo;
    if (row >= n) continue;
    const float l = hh ? l_hi : l_lo, div = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = ob + (long long)row * ldo;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float v0 = o[4 * j + 2 * hh] / div, v1 = o[4 * j + 2 * hh + 1] / div;
      if (pairs && c < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < d) orow[c] = __float2bfloat16(v0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DP, int WG>
cudaError_t launch_as(const float* qkv, const unsigned char* mask, __nv_bfloat16* out, int B,
                      int n, int H, int d, float scale, cudaStream_t st) {
  auto kernel = mask != nullptr ? vit_attn_wgmma_kernel<DP, WG, true>
                                : vit_attn_wgmma_kernel<DP, WG, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes<DP>());
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + 64 * WG - 1) / (64 * WG), H, B), 128 * WG, smem_bytes<DP>(), st>>>(
      qkv, mask, out, n, H, d, scale);
  return cudaGetLastError();
}

}  // namespace vattn
