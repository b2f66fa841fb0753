// K6's forward on wgmma: online-softmax attention straight off the native
// (B, N, 3*H*D) f32 qkv panel, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of `flash_qkv_attention`
// (vit4hep_tpu/ops/flash_qkv_attention.py:62, pallas_call :305).
//
// What bounds it: at the ds3 training shape (qkv (64, 450, 1440) f32) it must
// read the 166 MB panel and write 56 MB (0.066 ms at 3.35 TB/s) against 24.9
// GFLOP on the bf16 tensor cores (0.025 ms): bytes. So each K/V tile is
// brought in once per 128 query rows and converted to bf16 once, and the
// scores never leave registers.
//
// The design, a CTA per 128 query rows of one (batch, head):
//  - two warpgroups of 64 query rows; each thread holds two query rows (l/4
//    and l/4 + 8 of its warp's 16) in the wgmma accumulator layout, so the
//    row max and sum take two quad shuffles;
//  - Q is read once from the panel into registers as the bf16 A operand of
//    S = Q K^T (d in steps of 16);
//  - K and V tiles of 64 keys stream through a ring of two f32 stages filled
//    by cp.async (16-byte vectors where the panel allows, else 4-byte), the
//    next tile in flight while this one is used; all 256 threads convert a
//    tile once into the bf16 operands wgmma reads: K K-major in 16-column
//    chunks with the 32-byte swizzle, V transposed to V^T (d rows of 64 keys)
//    K-major with the 128-byte swizzle;
//  - S = Q K^T is wgmma m64n64k16 (A from registers); scale, mask and the pad
//    guard are applied in registers; O (64 x DP f32) stays in registers and
//    is rescaled there; P is packed to bf16 in registers as the A operand of
//    O += P V (m64nDPk16): the accumulator's columns 16k .. 16k+15 are the A
//    fragment of step k as they stand;
//  - O / l and lse = m + log l are written from registers into the merged
//    (B, N, H*D) context and the (B, N, H) lse.
//
// The function is the TPU kernel's: bf16 multiplicands, f32 statistics and
// accumulation (exp as the fast __expf: its error, a few ulp and ~40 at
// exp(-30), sits far below the bf16 rounding p takes next), p rounded to
// bf16 for P V after the sum l took it in f32; a
// masked score is -1e30; a key past N counts -1e30 in the max and exactly 0
// in l and O, so a fully masked row gets the mean of V over the N real keys.
//
// Its loader (load_tile, K only or K and V) and operand conversions
// (convert_rows, convert_cols) serve K8's wgmma kernels too (vmem_wgmma.cuh).
//
// The loaders, the conversions, the Q fragments and the stores are
// templated on the element type T of the global tensors: float (K6, K8) or
// __nv_bfloat16 (K1's bf16 arm, qkv_attention_bf16.cu, which runs this
// kernel's body on a bf16 panel). A bf16 tile is copied as it is into the
// stage (half the bytes of an f32 one; its rows at the f32 stage's part
// offsets, row stride ld_b16) and from there into the swizzled operand
// layouts without a conversion; the context is stored in bf16. The f32
// instantiations are the code they were.

#pragma once

#include <type_traits>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace aw {

using amma::Args;
using amma::MASKED;

constexpr int KT = 64;              // keys of one tile
constexpr int WGS = 2;              // warpgroups, 64 query rows each
constexpr int ROWS = 64 * WGS;      // query rows of one CTA
constexpr int THREADS = 128 * WGS;
// f32 stages of the K/V ring: the next tile lands while this one is used (a
// ring of 4 measured the same on the H100: the loads are not what waits)
constexpr int RING = 2;

// shared memory: the bf16 K chunks (DP/16 x 64 keys x 32 B) and V^T (DP rows
// x 128 B), then the ring's f32 stages of K and V (64 keys x DP, row stride
// DP + 4)
template <int DP>
__host__ __device__ constexpr int kb_bytes() {
  return KT * DP * 2;
}
template <int DP>
__host__ __device__ constexpr int ld_f32() {
  return DP + 4;
}
// a bf16 stage's row stride (elements): 16-byte rows, off the bank period
template <int DP>
__host__ __device__ constexpr int ld_b16() {
  return DP + 8;
}
template <int DP>
__host__ __device__ constexpr int stage_floats() {
  return 2 * KT * ld_f32<DP>();
}
template <int DP>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)2 * kb_bytes<DP>() + (size_t)RING * stage_floats<DP>() * 4 + 1024;
}

// whether Q lives in shared memory, read by S = Q K^T as an ss operand: in
// the masked kernel at DP = 64, where ptxas took the registers of Q's
// fragments for scratch once a tile's products had read them, so every later
// tile read other values (with an all-True mask the kernel differed from the
// unmasked one by ~0.6 of the scale: PERF.md section 6)
template <int DP, bool HAS_MASK>
__host__ __device__ constexpr bool q_in_smem() {
  return HAS_MASK && DP == 64;
}
// fwd_smem and, where Q lives there, one bf16 Q tile (64 rows x DP) a
// warpgroup after the ring
template <int DP, bool HAS_MASK>
__host__ __device__ constexpr size_t fwd_smem_q() {
  return fwd_smem<DP>() + (q_in_smem<DP, HAS_MASK>() ? (size_t)ROWS * DP * 2 : 0);
}

template <typename T>
constexpr bool is_bf16 = std::is_same_v<T, __nv_bfloat16>;

// a slab's (b, h) base as a T pointer (the slab's strides count elements)
template <typename T>
__device__ __forceinline__ const T* tbase(const amma::Slab& s, int b, int h) {
  return reinterpret_cast<const T*>(s.p) + b * s.sb + h * s.sh;
}
template <typename T>
__device__ __forceinline__ T* tbase(const amma::OutSlab& s, int b, int h) {
  return reinterpret_cast<T*>(s.p) + b * s.sb + h * s.sh;
}

// an f32 value as a T
template <typename T>
__device__ __forceinline__ T to_t(float v) {
  if constexpr (is_bf16<T>)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// (row, key) may attend: always without a mask, and for a row past n
template <bool HAS_MASK>
__device__ __forceinline__ bool attends(int row, int key, int n, const unsigned char* mask) {
  return !HAS_MASK || row >= n || mask[(size_t)row * n + key] != 0;
}

// tile [k0, k0 + 64) of bf16 K (and, for PARTS = 2, V) into a stage as bf16
// rows (row stride ld_b16, each part at the f32 stage's part offset), zero
// past n and past d
template <int DP, int PARTS = 2>
__device__ __forceinline__ void load_tile(float* st, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, long long ldk, long long ldv,
                                          int k0, int n, int d, bool vec) {
  constexpr int LDF = ld_f32<DP>(), LDB = ld_b16<DP>();
  if (vec) {  // 16-byte chunks of 8 values: d % 8 == 0 and every row start 16-byte aligned
    constexpr int C = DP / 8, WARPS = THREADS / 32;
    const int lane = threadIdx.x % 32, c = 8 * lane;
    if (lane >= C) return;
#pragma unroll 4
    for (int rr = threadIdx.x / 32; rr < PARTS * KT; rr += WARPS) {
      const int which = rr / KT, r = rr % KT, key = k0 + r;
      const bool in = key < n && c < d;
      const __nv_bfloat16* src =
          (which ? vb : kb) + (in ? (long long)key * (which ? ldv : ldk) + c : 0);
      hop::cp_async16(reinterpret_cast<__nv_bfloat16*>(st + which * KT * LDF) + r * LDB + c,
                      src, in ? 16 : 0);
    }
  } else {  // value by value: cp.async copies 4 bytes at least, so plain loads and stores
    for (int u = threadIdx.x; u < PARTS * KT * DP; u += THREADS) {
      const int which = u / (KT * DP), r = u / DP % KT, c = u % DP, key = k0 + r;
      const bool in = key < n && c < d;
      reinterpret_cast<__nv_bfloat16*>(st + which * KT * LDF)[r * LDB + c] =
          in ? (which ? vb : kb)[(long long)key * (which ? ldv : ldk) + c]
             : __float2bfloat16_rn(0.f);
    }
  }
}

// tile [k0, k0 + 64) of K (and, for PARTS = 2, of V) into an f32 stage, zero
// past n and past d
template <int DP, int PARTS = 2>
__device__ __forceinline__ void load_tile(float* st, const float* kb, const float* vb,
                                          long long ldk, long long ldv, int k0, int n, int d,
                                          bool vec) {
  constexpr int LDF = ld_f32<DP>();
  if (vec) {  // 16-byte chunks: d % 4 == 0 and every row start 16-byte aligned
    // lane c copies chunk c of the rows warp, warp + 8, ... (K's 64, then V's)
    constexpr int C = DP / 4, WARPS = THREADS / 32;
    const int lane = threadIdx.x % 32, c = 4 * lane;
    if (lane >= C) return;
#pragma unroll 4
    for (int rr = threadIdx.x / 32; rr < PARTS * KT; rr += WARPS) {
      const int which = rr / KT, r = rr % KT, key = k0 + r;
      const bool in = key < n && c < d;
      const float* src = (which ? vb : kb) + (in ? (long long)key * (which ? ldv : ldk) + c : 0);
      hop::cp_async16(st + rr * LDF + c, src, in ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < PARTS * KT * DP; u += THREADS) {
      const int which = u / (KT * DP), r = u / DP % KT, c = u % DP, key = k0 + r;
      const bool in = key < n && c < d;
      const float* src = (which ? vb : kb) + (in ? (long long)key * (which ? ldv : ldk) + c : 0);
      hop::cp_async4(st + which * KT * LDF + r * LDF + c, src, in ? 4 : 0);
    }
  }
}

// 64 f32 rows of a stage (row stride ld_f32) into the K-major B (or A)
// operand of a product over DP: row r, columns 8c .. 8c+7 to 16-column chunk
// c / 2 (64 rows x 32 B), row r, 16-byte half (c % 2) ^ ((r / 4) % 2) (the
// 32-byte swizzle); bf16 rows (T) are copied as they are
template <int DP, typename T = float>
__device__ __forceinline__ void convert_rows(unsigned char* dst, const float* rows) {
  if constexpr (is_bf16<T>) {
    constexpr int LDB = ld_b16<DP>();
    const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(rows);
    for (int u = threadIdx.x; u < KT * DP / 8; u += THREADS) {
      const int r = u % KT, c = u / KT;
      *reinterpret_cast<uint4*>(dst + (c / 2) * KT * 32 + r * 32 +
                                (((c & 1) ^ ((r >> 2) & 1)) << 4)) =
          *reinterpret_cast<const uint4*>(rb + r * LDB + 8 * c);
    }
    return;
  }
  constexpr int LDF = ld_f32<DP>();
  for (int u = threadIdx.x; u < KT * DP / 8; u += THREADS) {
    const int r = u % KT, c = u / KT;
    const float4 a = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c);
    const float4 b = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c + 4);
    const uint4 v = make_uint4(hop::pack_bf16(a.x, a.y), hop::pack_bf16(a.z, a.w),
                               hop::pack_bf16(b.x, b.y), hop::pack_bf16(b.z, b.w));
    *reinterpret_cast<uint4*>(dst + (c / 2) * KT * 32 + r * 32 +
                              (((c & 1) ^ ((r >> 2) & 1)) << 4)) = v;
  }
}

// 64 f32 rows of a stage transposed into the K-major B operand of a product
// over the 64 rows: rows 8j .. 8j+7, column e to row e (128 B), 16-byte chunk
// j ^ (e % 8) (the 128-byte swizzle); bf16 rows (T) are gathered as they are
template <int DP, typename T = float>
__device__ __forceinline__ void convert_cols(unsigned char* dst, const float* rows) {
  if constexpr (is_bf16<T>) {
    constexpr int LDB = ld_b16<DP>();
    const unsigned short* rb = reinterpret_cast<const unsigned short*>(rows);
    for (int u = threadIdx.x; u < KT * DP / 8; u += THREADS) {
      const int e = u % DP, j = u / DP;
      const unsigned short* col = rb + 8 * j * LDB + e;
      const uint4 v = make_uint4(col[0] | (uint32_t)col[LDB] << 16,
                                 col[2 * LDB] | (uint32_t)col[3 * LDB] << 16,
                                 col[4 * LDB] | (uint32_t)col[5 * LDB] << 16,
                                 col[6 * LDB] | (uint32_t)col[7 * LDB] << 16);
      *reinterpret_cast<uint4*>(dst + e * 128 + ((j ^ (e & 7)) << 4)) = v;
    }
    return;
  }
  constexpr int LDF = ld_f32<DP>();
  for (int u = threadIdx.x; u < KT * DP / 8; u += THREADS) {
    const int e = u % DP, j = u / DP;
    const float* col = rows + 8 * j * LDF + e;
    const uint4 v = make_uint4(hop::pack_bf16(col[0], col[LDF]),
                               hop::pack_bf16(col[2 * LDF], col[3 * LDF]),
                               hop::pack_bf16(col[4 * LDF], col[5 * LDF]),
                               hop::pack_bf16(col[6 * LDF], col[7 * LDF]));
    *reinterpret_cast<uint4*>(dst + e * 128 + ((j ^ (e & 7)) << 4)) = v;
  }
}

// a stage into the bf16 operands: K as 16-column chunks, V as V^T
template <int DP, typename T = float>
__device__ __forceinline__ void convert_tile(unsigned char* kb16, unsigned char* vt16,
                                             const float* st) {
  convert_rows<DP, T>(kb16, st);
  convert_cols<DP, T>(vt16, st + KT * ld_f32<DP>());
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// column pair (c, c + 1) of query row `row` of a head's panel slab, 0 past
// n and past d
__device__ __forceinline__ uint32_t q_pair(const float* qb, long long ld, int row, int c, int n,
                                           int d) {
  const float* p = qb + (long long)row * ld;
  const bool in = row < n;
  return hop::pack_bf16(in && c < d ? p[c] : 0.f, in && c + 1 < d ? p[c + 1] : 0.f);
}
// the same pair of a bf16 slab, its bits as they are
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qb, long long ld, int row, int c,
                                           int n, int d) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(qb) + (long long)row * ld;
  const bool in = row < n;
  return (uint32_t)(in && c < d ? p[c] : 0) | (uint32_t)(in && c + 1 < d ? p[c + 1] : 0) << 16;
}

// the forward's body on global tensors of element type T (the lse in f32)
template <int DP, bool HAS_MASK, typename T>
__device__ __forceinline__ void flash_fwd_body(Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kb16 = smem;
  unsigned char* vt16 = smem + kb_bytes<DP>();
  float* stages = reinterpret_cast<float*>(smem + 2 * kb_bytes<DP>());
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = a.n, d = a.d;
  const int r_lo = blockIdx.x * ROWS + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const T* kbase = tbase<T>(a.k, b, h);
  const T* vbase = tbase<T>(a.v, b, h);
  constexpr int VW = 16 / sizeof(T);  // values of a 16-byte vector
  const bool vec = d % VW == 0 && a.k.sn % VW == 0 && a.v.sn % VW == 0 &&
                   ((reinterpret_cast<uintptr_t>(kbase) | reinterpret_cast<uintptr_t>(vbase)) &
                    15) == 0;
  const int tiles = (n + KT - 1) / KT;

#pragma unroll
  for (int t = 0; t < RING - 1; ++t) {  // one commit group per tile, empty past the last
    if (t < tiles)
      load_tile<DP>(stages + t * stage_floats<DP>(), kbase, vbase, a.k.sn, a.v.sn, t * KT, n,
                    d, vec);
    hop::cp_async_commit();
  }

  // Q as the A operand: step c holds columns 16c .. 16c+15 of the two rows
  uint32_t qf[DP / 16][4];
  {
    const T* qb = tbase<T>(a.q, b, h);
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      qf[c][0] = q_pair(qb, a.q.sn, r_lo, 16 * c + c0, n, d);
      qf[c][1] = q_pair(qb, a.q.sn, r_hi, 16 * c + c0, n, d);
      qf[c][2] = q_pair(qb, a.q.sn, r_lo, 16 * c + c0 + 8, n, d);
      qf[c][3] = q_pair(qb, a.q.sn, r_hi, 16 * c + c0 + 8, n, d);
    }
  }
  // where Q lives in shared memory: the fragments into the warpgroup's tile
  // in K's chunk layout (16-column chunks of 64 rows x 32 B, 32-byte
  // swizzle), made visible to the products by the loop's first fence and
  // barrier
  constexpr bool QS = q_in_smem<DP, HAS_MASK>();
  unsigned char* qs = smem + 2 * kb_bytes<DP>() + (size_t)RING * stage_floats<DP>() * 4 +
                      (size_t)wg * 64 * DP * 2;
  if constexpr (QS) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 16 + lane / 4 + 8 * (i & 1);
        *reinterpret_cast<uint32_t*>(qs + c * 64 * 32 + r * 32 +
                                     (((i >> 1) ^ ((r >> 2) & 1)) << 4) + 4 * (lane % 4)) =
            qf[c][i];
      }
    }
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_lo = MASKED, m_hi = MASKED, l_lo = 0.f, l_hi = 0.f;  // a wholly masked row keeps p = 1
  const uint32_t kb_addr = hop::smem_u32(kb16), vt_addr = hop::smem_u32(vt16);

  for (int t = 0; t < tiles; ++t) {
    hop::cp_async_wait<RING - 2>();  // this thread's copies of tile t landed
    __syncthreads();  // everyone's; every warpgroup is done with tile t - 1's operands
    if (t + RING - 1 < tiles)  // into the stage tile t - 1 was converted from
      load_tile<DP>(stages + (t + RING - 1) % RING * stage_floats<DP>(), kbase, vbase, a.k.sn,
                    a.v.sn, (t + RING - 1) * KT, n, d, vec);
    hop::cp_async_commit();
    convert_tile<DP, T>(kb16, vt16, stages + t % RING * stage_floats<DP>());
    hop::fence_proxy_async();
    __syncthreads();

    float s[KT / 2];
    hop::fence_regs(s);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      if constexpr (QS)
        hop::Mma<KT, 0>::ss(s, hop::desc(hop::smem_u32(qs) + c * 64 * 32, 16, 256, hop::SW32),
                            hop::desc(kb_addr + c * KT * 32, 16, 256, hop::SW32), c);
      else
        hop::Mma<KT, 0>::rs(s, qf[c], hop::desc(kb_addr + c * KT * 32, 16, 256, hop::SW32), c);
    }
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
        lo = real && attends<HAS_MASK>(r_lo, key, n, a.mask) ? lo * a.scale : MASKED;
        hi = real && attends<HAS_MASK>(r_hi, key, n, a.mask) ? hi * a.scale : MASKED;
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

  T* ob = tbase<T>(a.o, b, h);
  float* lb = amma::base(a.lse_out, b, h);
  const float div_lo = l_lo == 0.f ? 1.f : l_lo, div_hi = l_hi == 0.f ? 1.f : l_hi;
  const bool pairs = d % 2 == 0 && a.o.sn % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(ob) & (2 * sizeof(T) - 1)) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = hh ? r_hi : r_lo;
    if (row >= n) continue;
    const float div = hh ? div_hi : div_lo;
    T* orow = ob + (long long)row * a.o.sn;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float v0 = o[4 * j + 2 * hh] / div, v1 = o[4 * j + 2 * hh + 1] / div;
      if (pairs && c < d) {
        if constexpr (is_bf16<T>)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
      } else {
        if (c < d) orow[c] = to_t<T>(v0);
        if (c + 1 < d) orow[c + 1] = to_t<T>(v1);
      }
    }
    if (lane % 4 == 0) lb[(long long)row * a.lse_out.sn] = (hh ? m_hi : m_lo) + logf(div);
  }
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) flash_fwd_wgmma_kernel(Args a) {
  flash_fwd_body<DP, HAS_MASK, float>(a);
}

template <int DP>
cudaError_t launch_fwd(const Args& a, int B, int H, cudaStream_t st) {
  auto kernel = a.mask != nullptr ? flash_fwd_wgmma_kernel<DP, true>
                                  : flash_fwd_wgmma_kernel<DP, false>;
  const size_t smem = a.mask != nullptr ? fwd_smem_q<DP, true>() : fwd_smem_q<DP, false>();
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.n + ROWS - 1) / ROWS, H, B), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace aw
