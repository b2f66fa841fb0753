// K1's forward on the tensor cores in split TF32, for Hopper (sm_90a):
// softmax(q k^T * scale) v per (batch element, head) straight off the
// (B, N, 3*H*D) f32 qkv panel, written as the merged (B, N, H*D) f32
// context and the f32 log-sum-exp (B, H, N).
//
// Replaces the TPU kernel `_fused_fwd`
// (vit4hep_tpu/ops/fused_qkv_attention.py:190: `_fused_kernel` :58,
// `_fused_kernel_masked` :65, `_packed_kernel` :94, `_packed_kernel_masked`
// :156; pallas_call :231). The port holds K1 to an f32 contract (its plain
// version computes in f32, and K1's backward rebuilds p from this lse), so
// each product runs as three TF32 products ("3xTF32"): x = hi + lo with hi
// = tf32(x) and lo = tf32(x - hi), both rounded to nearest, and
//   A B ~ hi(A) hi(B) + hi(A) lo(B) + lo(A) hi(B),
// accumulated in f32. The dropped lo lo term and lo's own rounding leave
// ~2^-21 of each product term, against 2^-11 for one TF32 product.
//
// Semantics kept from the f32 CUDA-core kernel it replaced (attention_fwd.cuh
// keeps the score rule): an online softmax; a masked score is the finite -1e30 of
// `jnp.where(mask, s, -1e30)` (:80) and a key past N is -inf, so it weighs
// exactly 0 and a row whose every key is masked gets the mean of V with lse
// -1e30 + log N (which is -1e30 in f32, as K1's backward expects). The mask
// is a HAS_MASK instantiation, so the unmasked kernel spends nothing on it.
//
// What bounds it: at the ds2 training shape (qkv (64, 135, 1440)) the
// kernel must read 50 MB and write 17 MB (0.020 ms at 3.35 TB/s); 2.24
// GFLOP of f32-contract products are 6.7 GFLOP of TF32 (0.014 ms at 495
// TFLOP/s): bytes. The 135 keys of a head fill a 32-key tile grid to 160,
// and its 135 rows fill 64-row warpgroups to 192.
//
// The design, a CTA of WG warpgroups of 64 query rows of one (batch, head):
//  - each thread holds two query rows (l/4 and l/4 + 8 of its warp's 16) in
//    the wgmma accumulator layout, so a row's max and sum take two quad
//    shuffles;
//  - Q is read once and split into hi and lo A fragments in registers (up
//    to DP = 96; above, into shared memory, read through descriptors, so the
//    registers hold only O, S and P);
//  - K and V stream in tiles of 32 keys through a ring of two f32 stages
//    filled by cp.async (16-byte vectors when d % 4 == 0 and the rows are
//    aligned, else 4 bytes), the next tile in flight while this one is used;
//    all threads split a tile once into the hi and lo operands wgmma reads,
//    K-major (tf32 has no transpose bit): K as stored, in 8-column chunks of
//    32 rows x 32 bytes, and V transposed, in 8-key chunks of DP rows x 32
//    bytes, both with the 32-byte swizzle;
//  - S = Q K^T is 3 x DP/8 wgmma m64n32k8; scale, mask and the pad guard in
//    registers; O (64 x DP f32) is rescaled in registers;
//  - P becomes the A operand of O += P V from the registers as it stands: a
//    thread's accumulator holds columns 2t and 2t + 1 of every 8 (t = lane
//    % 4), while a tf32 A fragment of k8 holds columns t and t + 4. The sum
//    over a chunk's 8 keys takes them in any order, so V^T's chunk holds its
//    keys in the order 0, 2, 4, 6, 1, 3, 5, 7, and P's columns 2t and 2t + 1
//    sit where the fragment's t and t + 4 are read;
//  - O / l and lse = m + log l are written from the registers.
// A warpgroup whose 64 rows all lie past N joins the loads, conversions and
// barriers but issues no product.
//
// Fragment layouts (per warpgroup; w = warp % 4, l = lane, t = l % 4): an
// m64nN accumulator d[4j + 2h + e] is row 16w + l/4 + 8h, column 8j + 2t +
// e; the A fragment of a k8 step holds a[0] (row l/4, column t), a[1] (row
// l/4 + 8, column t), a[2] (row l/4, column t + 4), a[3] (row l/4 + 8,
// column t + 4).
//
// exp is the fast __expf: a few ulp at the arguments a softmax takes, far
// inside the f32 contract's 1e-4.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "hopper.cuh"

namespace tf {

constexpr int KT = 32;    // keys of one tile
constexpr int RING = 2;   // f32 stages of the K/V ring
constexpr int SMEM_MAX = 232448;

// the accumulator operands of an m64nN product: d[0 .. N/2)
#define TF32_F8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TF32_D8 TF32_F8(0)
#define TF32_D16 TF32_D8, TF32_F8(8)
#define TF32_D24 TF32_D16, TF32_F8(16)
#define TF32_D32 TF32_D24, TF32_F8(24)
#define TF32_D40 TF32_D32, TF32_F8(32)
#define TF32_D48 TF32_D40, TF32_F8(40)
#define TF32_D56 TF32_D48, TF32_F8(48)
#define TF32_D64 TF32_D56, TF32_F8(56)

// wgmma m64nNk8 on tf32 operands, f32 accumulators in registers: A from
// registers (rs: a[0..3] as the A fragment below) or shared memory (ss), B
// from shared memory; both K-major (tf32 has no transpose bit)
template <int N>
struct MmaTf32;

template <>
struct MmaTf32<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : TF32_D8
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : TF32_D16
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : TF32_D16
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<48> {
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : TF32_D24
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : TF32_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<80> {
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : TF32_D40
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<96> {
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : TF32_D48
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<112> {
  static __device__ __forceinline__ void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : TF32_D56
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : TF32_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

#undef TF32_F8
#undef TF32_D8
#undef TF32_D16
#undef TF32_D24
#undef TF32_D32
#undef TF32_D40
#undef TF32_D48
#undef TF32_D56
#undef TF32_D64

// x rounded to the nearest tf32 (its low 13 mantissa bits zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float a, float b, float c, float d, uint4& hi, uint4& lo) {
  split(a, hi.x, lo.x);
  split(b, hi.y, lo.y);
  split(c, hi.z, lo.z);
  split(d, hi.w, lo.w);
}

// descriptor of k8 chunk c of a K-major tf32 operand of `rows` rows (32
// bytes a row, 32-byte swizzle)
__device__ __forceinline__ uint64_t chunk_desc(uint32_t base, int c, int rows) {
  return hop::desc(base + c * rows * 32, 16, 256, hop::SW32);
}

// accumulator values (N/2 of a thread: columns 2t, 2t + 1 of every 8) as
// the hi and lo A fragments of the N/8 k8 steps over those columns, for a B
// whose chunks hold their 8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7
template <int N>
__device__ __forceinline__ void frags(uint32_t (&h)[N / 8][4], uint32_t (&l)[N / 8][4],
                                      const float (&v)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split(v[4 * j], h[j][0], l[j][0]);
    split(v[4 * j + 2], h[j][1], l[j][1]);
    split(v[4 * j + 1], h[j][2], l[j][2]);
    split(v[4 * j + 3], h[j][3], l[j][3]);
  }
}

// whether Q lives in shared memory: above DP = 96 (its fragments would not
// fit the registers beside O), and in the masked kernel at DP = 32, where
// ptxas took the registers of Q's fragments for scratch once a tile's
// products had read them, so every later tile read wrong lo terms (an error
// of ~1e-4 of the scale, seen in the SASS: PERF.md section 6)
template <int DP, bool HAS_MASK>
__host__ __device__ constexpr bool q_in_smem() {
  return DP > 96 || (HAS_MASK && DP == 32);
}

// the CTA of WG warpgroups at padded head dim DP, and its shared memory: the
// hi and lo operands of K and V^T (one tile each), of Q where it lives in
// shared memory, then the ring's f32 stages (K's 32 rows, then V's; row
// stride DP + 4)
template <int DP, int WG, bool QS>
struct Cta {
  static constexpr int THREADS = 128 * WG;
  static constexpr int ROWS = 64 * WG;
  static constexpr bool Q_SMEM = QS;
  static constexpr int LDF = DP + 4;
  static constexpr int STAGE = 2 * KT * LDF;
  static constexpr int TILE = KT * DP * 4;
  static constexpr int QTILE = Q_SMEM ? ROWS * DP * 4 : 0;
  static constexpr size_t SMEM = (size_t)4 * TILE + 2 * QTILE + (size_t)RING * STAGE * 4 + 1024;
  static_assert(SMEM <= SMEM_MAX, "a CTA's operands and ring must fit its shared memory");
  static_assert(!Q_SMEM || WG == 1, "Q in shared memory is laid out for one warpgroup");
};

// descriptors of k8 step c: K's chunk of 32 rows, V^T's of DP rows, Q's of 64
__device__ __forceinline__ uint64_t k_desc(uint32_t base, int c) {
  return hop::desc(base + c * KT * 32, 16, 256, hop::SW32);
}
template <int DP>
__device__ __forceinline__ uint64_t v_desc(uint32_t base, int c) {
  return hop::desc(base + c * DP * 32, 16, 256, hop::SW32);
}
__device__ __forceinline__ uint64_t q_desc(uint32_t base, int c) {
  return hop::desc(base + c * 64 * 32, 16, 256, hop::SW32);
}

// row r's 32 bytes at offset off of a chunk, halves (h0 columns 0-3, h1
// columns 4-7) swapped on rows with (r / 4) odd: the 32-byte swizzle
__device__ __forceinline__ void put_row(unsigned char* chunk, int r, const uint4& h0,
                                        const uint4& h1) {
  const int sw = ((r >> 2) & 1) << 4;
  *reinterpret_cast<uint4*>(chunk + r * 32 + sw) = h0;
  *reinterpret_cast<uint4*>(chunk + r * 32 + (sw ^ 16)) = h1;
}

// tile [k0, k0 + 32) of K and V into an f32 stage, zero past n and past d;
// one cp.async group (empty past the last tile)
template <int DP, int THREADS>
__device__ __forceinline__ void load_kv(float* st, const float* kb, const float* vb, long long ld,
                                        int k0, int n, int d, bool vec) {
  constexpr int LDF = DP + 4;
  if (k0 < n) {
    if (vec) {
      constexpr int C = DP / 4;  // 16-byte chunks of a row
      for (int u = threadIdx.x; u < 2 * KT * C; u += THREADS) {
        const int rr = u / C, c = 4 * (u % C), key = k0 + rr % KT;
        const bool in = key < n && c < d;
        const float* src = (rr < KT ? kb : vb) + (in ? (long long)key * ld + c : 0);
        hop::cp_async16(st + rr * LDF + c, src, in ? 16 : 0);
      }
    } else {
      for (int u = threadIdx.x; u < 2 * KT * DP; u += THREADS) {
        const int rr = u / DP, c = u % DP, key = k0 + rr % KT;
        const bool in = key < n && c < d;
        const float* src = (rr < KT ? kb : vb) + (in ? (long long)key * ld + c : 0);
        hop::cp_async4(st + rr * LDF + c, src, in ? 4 : 0);
      }
    }
  }
  hop::cp_async_commit();
}

// K's 32 rows of a stage into the hi and lo B operands of S = Q K^T: chunk c
// (columns 8c .. 8c+7) holds the 32 rows
template <int DP, int THREADS>
__device__ __forceinline__ void convert_k(unsigned char* hi, unsigned char* lo,
                                          const float* rows) {
  constexpr int LDF = DP + 4;
  for (int u = threadIdx.x; u < KT * DP / 8; u += THREADS) {
    const int r = u % KT, c = u / KT;
    const float4 a = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c);
    const float4 b = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c + 4);
    uint4 h0, l0, h1, l1;
    split4(a.x, a.y, a.z, a.w, h0, l0);
    split4(b.x, b.y, b.z, b.w, h1, l1);
    put_row(hi + c * KT * 32, r, h0, h1);
    put_row(lo + c * KT * 32, r, l0, l1);
  }
}

// V's 32 rows of a stage transposed into the hi and lo B operands of O += P
// V: chunk c (keys 8c .. 8c+7) holds the DP columns as rows, its 8 keys in
// the order 0, 2, 4, 6, 1, 3, 5, 7 (P's register order, above)
template <int DP, int THREADS>
__device__ __forceinline__ void convert_vt(unsigned char* hi, unsigned char* lo,
                                           const float* rows) {
  constexpr int LDF = DP + 4;
  for (int u = threadIdx.x; u < KT * DP / 8; u += THREADS) {
    const int e = u % DP, c = u / DP;
    const float* col = rows + 8 * c * LDF + e;
    uint4 h0, l0, h1, l1;
    split4(col[0], col[2 * LDF], col[4 * LDF], col[6 * LDF], h0, l0);
    split4(col[LDF], col[3 * LDF], col[5 * LDF], col[7 * LDF], h1, l1);
    put_row(hi + c * DP * 32, e, h0, h1);
    put_row(lo + c * DP * 32, e, l0, l1);
  }
}

// an element of a head's panel slab, 0 past n and past d
__device__ __forceinline__ float at(const float* qb, long long ld, int row, int c, int n, int d) {
  return row < n && c < d ? qb[(long long)row * ld + c] : 0.f;
}

// rows r_lo and r_lo + 8 of Q as the hi and lo A fragments of the k8 steps
template <int DP>
__device__ __forceinline__ void q_frags(uint32_t (&qh)[DP / 8][4], uint32_t (&ql)[DP / 8][4],
                                        const float* qb, long long ld, int r_lo, int n, int d) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    split(at(qb, ld, r_lo, 8 * c + t, n, d), qh[c][0], ql[c][0]);
    split(at(qb, ld, r_lo + 8, 8 * c + t, n, d), qh[c][1], ql[c][1]);
    split(at(qb, ld, r_lo, 8 * c + t + 4, n, d), qh[c][2], ql[c][2]);
    split(at(qb, ld, r_lo + 8, 8 * c + t + 4, n, d), qh[c][3], ql[c][3]);
  }
}

// rows q0 .. q0+63 of Q into the hi and lo A operands in shared memory:
// chunk c (columns 8c .. 8c+7) holds the 64 rows
template <int DP>
__device__ __forceinline__ void q_smem(unsigned char* hi, unsigned char* lo, const float* qb,
                                       long long ld, int q0, int n, int d) {
  for (int u = threadIdx.x; u < 64 * DP / 8; u += 128) {
    const int r = u % 64, c = u / 64, row = q0 + r;
    uint4 h0, l0, h1, l1;
    split4(at(qb, ld, row, 8 * c, n, d), at(qb, ld, row, 8 * c + 1, n, d),
           at(qb, ld, row, 8 * c + 2, n, d), at(qb, ld, row, 8 * c + 3, n, d), h0, l0);
    split4(at(qb, ld, row, 8 * c + 4, n, d), at(qb, ld, row, 8 * c + 5, n, d),
           at(qb, ld, row, 8 * c + 6, n, d), at(qb, ld, row, 8 * c + 7, n, d), h1, l1);
    put_row(hi + c * 64 * 32, r, h0, h1);
    put_row(lo + c * 64 * 32, r, l0, l1);
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

template <int DP, int WG, bool HAS_MASK>
__global__ void __launch_bounds__(128 * WG)
qkv_fwd_tf32_kernel(const float* __restrict__ qkv, const unsigned char* __restrict__ mask,
                    float* __restrict__ out, float* __restrict__ lse, int n, int H, int d,
                    float scale) {
  using C = Cta<DP, WG, q_in_smem<DP, HAS_MASK>()>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kh = smem;
  unsigned char* kl = smem + C::TILE;
  unsigned char* vh = smem + 2 * C::TILE;
  unsigned char* vl = smem + 3 * C::TILE;
  unsigned char* qhs = smem + 4 * C::TILE;
  unsigned char* qls = qhs + C::QTILE;
  float* stages = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::QTILE);
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::ROWS;
  const int r_lo = q0 + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const long long ld = 3LL * H * d, hd = (long long)H * d;
  const float* base = qkv + (long long)b * n * ld;
  const float* qb = base + (long long)h * d;
  const float* kb = base + hd + (long long)h * d;
  const float* vb = base + 2 * hd + (long long)h * d;
  const bool vec = d % 4 == 0 && ld % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kb) | reinterpret_cast<uintptr_t>(vb)) & 15) == 0;
  const int tiles = (n + KT - 1) / KT;
  const bool active = q0 + wg * 64 < n;  // this warpgroup holds a row below n

#pragma unroll
  for (int i = 0; i < RING; ++i)
    load_kv<DP, C::THREADS>(stages + i * C::STAGE, kb, vb, ld, i * KT, n, d, vec);
  uint32_t qh[C::Q_SMEM ? 1 : DP / 8][4], ql[C::Q_SMEM ? 1 : DP / 8][4];
  if constexpr (C::Q_SMEM)
    q_smem<DP>(qhs, qls, qb, ld, q0, n, d);
  else
    q_frags<DP>(qh, ql, qb, ld, r_lo, n, d);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const uint32_t akh = hop::smem_u32(kh), akl = hop::smem_u32(kl);
  const uint32_t avh = hop::smem_u32(vh), avl = hop::smem_u32(vl);
  const uint32_t aqh = hop::smem_u32(qhs), aql = hop::smem_u32(qls);
  const int kq = 2 * (lane % 4);

  for (int t = 0; t < tiles; ++t) {
    hop::cp_async_wait<RING - 1>();  // this thread's copies of tile t landed
    __syncthreads();  // everyone's; every warpgroup is done with tile t - 1's operands
    const float* st = stages + (t % RING) * C::STAGE;
    convert_k<DP, C::THREADS>(kh, kl, st);
    convert_vt<DP, C::THREADS>(vh, vl, st + KT * C::LDF);
    hop::fence_proxy_async();
    __syncthreads();
    load_kv<DP, C::THREADS>(stages + (t % RING) * C::STAGE, kb, vb, ld, (t + RING) * KT, n, d,
                            vec);
    if (!active) continue;

    // S = Q K^T in three TF32 products
    float s[KT / 2];
    hop::fence_regs(s);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      if constexpr (C::Q_SMEM) {
        MmaTf32<KT>::ss(s, q_desc(aqh, c), k_desc(akh, c), c);
        MmaTf32<KT>::ss(s, q_desc(aqh, c), k_desc(akl, c), 1);
        MmaTf32<KT>::ss(s, q_desc(aql, c), k_desc(akh, c), 1);
      } else {
        MmaTf32<KT>::rs(s, qh[c], k_desc(akh, c), c);
        MmaTf32<KT>::rs(s, qh[c], k_desc(akl, c), 1);
        MmaTf32<KT>::rs(s, ql[c], k_desc(akh, c), 1);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    // scale, mask, pad guard (attn::score: -1e30 masked, -inf past n); the
    // running max and sum of the two rows
    const int k0 = t * KT + kq;
    float t_lo = -INFINITY, t_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + e;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = attn::score<HAS_MASK>(lo, scale, r_lo, key, n, mask);
        hi = attn::score<HAS_MASK>(hi, scale, r_hi, key, n, mask);
        t_lo = fmaxf(t_lo, lo);
        t_hi = fmaxf(t_hi, hi);
      }
    }
    // every tile holds a key below n, so the tile max is finite: a real
    // score or -1e30; exp(-inf - m) = 0 on the first tile
    const float mn_lo = fmaxf(m_lo, quad_max(t_lo)), mn_hi = fmaxf(m_hi, quad_max(t_hi));
    const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ls_lo = 0.f, ls_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = __expf(lo - mn_lo);
        hi = __expf(hi - mn_hi);
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
    // P as the hi and lo A fragments of the k8 steps: columns 2t, 2t + 1 of
    // chunk j in the fragment's places of columns t, t + 4
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      split(s[4 * j], ph[j][0], pl[j][0]);
      split(s[4 * j + 2], ph[j][1], pl[j][1]);
      split(s[4 * j + 1], ph[j][2], pl[j][2]);
      split(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < KT / 8; ++c) {
      MmaTf32<DP>::rs(o, ph[c], v_desc<DP>(avh, c), 1);
      MmaTf32<DP>::rs(o, ph[c], v_desc<DP>(avl, c), 1);
      MmaTf32<DP>::rs(o, pl[c], v_desc<DP>(avh, c), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
  }

  // O / l into the merged context, m + log l into the lse (B, H, N)
  float* ob = out + (long long)b * n * hd + (long long)h * d;
  float* lb = lse + ((long long)b * H + h) * n;
  const bool pairs = d % 2 == 0 && hd % 2 == 0 && (reinterpret_cast<uintptr_t>(ob) & 7) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = hh ? r_hi : r_lo;
    if (row >= n) continue;
    const float l = hh ? l_hi : l_lo, inv = 1.f / l;
    float* orow = ob + (long long)row * hd;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + kq;
      const float v0 = o[4 * j + 2 * hh] * inv, v1 = o[4 * j + 2 * hh + 1] * inv;
      if (pairs && c < d) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
      } else {
        if (c < d) orow[c] = v0;
        if (c + 1 < d) orow[c + 1] = v1;
      }
    }
    if (lane % 4 == 0) lb[row] = (hh ? m_hi : m_lo) + logf(l);
  }
}

template <int DP, int WG, bool HAS_MASK>
cudaError_t launch_as(const float* qkv, const unsigned char* mask, float* out, float* lse, int B,
                      int n, int H, int d, float scale, cudaStream_t st) {
  using C = Cta<DP, WG, q_in_smem<DP, HAS_MASK>()>;
  auto kernel = qkv_fwd_tf32_kernel<DP, WG, HAS_MASK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + C::ROWS - 1) / C::ROWS, H, B), C::THREADS, C::SMEM, st>>>(
      qkv, mask, out, lse, n, H, d, scale);
  return cudaGetLastError();
}

// one warpgroup (64 query rows) a CTA, two CTAs an SM; from 384 tokens (and
// with Q in registers) two warpgroups share each converted K/V tile, one CTA
// an SM. On the H100 the first was faster at 135, 225 and 300 tokens, the
// second at 450, by 4-10% (PERF.md section 6).
template <int DP>
cudaError_t launch_fwd(const float* qkv, const unsigned char* mask, float* out, float* lse, int B,
                       int n, int H, int d, float scale, cudaStream_t st) {
  constexpr int WG2_MASKED = q_in_smem<DP, true>() ? 1 : 2;
  constexpr int WG2 = q_in_smem<DP, false>() ? 1 : 2;
  if (n >= 384)
    return mask != nullptr
               ? launch_as<DP, WG2_MASKED, true>(qkv, mask, out, lse, B, n, H, d, scale, st)
               : launch_as<DP, WG2, false>(qkv, mask, out, lse, B, n, H, d, scale, st);
  return mask != nullptr
             ? launch_as<DP, 1, true>(qkv, mask, out, lse, B, n, H, d, scale, st)
             : launch_as<DP, 1, false>(qkv, mask, out, lse, B, n, H, d, scale, st);
}

}  // namespace tf
