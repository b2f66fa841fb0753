// K1's backward on the tensor cores in split TF32, for Hopper (sm_90a): the
// dQ and the dK/dV passes of `fused_qkv_attention` straight off the
// (B, N, 3*H*D) f32 qkv panel, writing the (B, N, 3*H*D) dqkv panel.
//
// Replaces the TPU kernel `_fused_bwd`
// (vit4hep_tpu/ops/fused_qkv_attention.py:300: `_bwd_kernel` :252,
// `_bwd_kernel_masked` :260; pallas_call :328). Its function, held in f32
// as the port's plain version holds it (delta = rowsum(dO * O) is an input,
// from K1's delta kernel):
//   p  = exp(where(mask, s * scale, -1e30) - lse), 0 for a key past N;
//   ds = p (dp - delta) scale, dp = dO V^T;
//   dQ = ds K, dK = ds^T Q, dV = p^T dO.
// K1's dead-row rule, not K6's: a row whose every key is masked has lse
// -1e30, so it rebuilds p = 1 for each of its N keys and its delta is
// scaled by N (JAX's rowsum(dP * P) is then N rowsum(dO * O)). p is
// formed as the fast exp of a selected exponent (`attn::score`: -inf past
// N, -1e30 masked), never as a select between an exponential and 0: that
// form was miscompiled by ptxas in K6's masked dQ pass at DP = 64 (PERF.md
// section 6). A query row past N takes lse = +inf, so its p is exactly 0.
//
// Every product runs as three TF32 wgmma products, hi hi + hi lo + lo hi,
// accumulated in f32 (qkv_fwd_tf32.cuh's split: x = hi + lo, both rounded
// to the nearest tf32), which keeps K1's f32 contract (1e-4) where one TF32
// product misses it by 10x or more.
//
// What bounds it: at the ds2 training shape (qkv (64, 135, 1440)) the dQ
// pass must read the 50 MB panel and the 17 MB gradient and write 17 MB, the
// dK/dV pass write 33 MB (0.025 and 0.030 ms at 3.35 TB/s); 5.6 GFLOP of
// f32-contract products are 16.8 GFLOP of TF32 (0.034 ms at 494.7 TFLOP/s
// for both passes). So each streamed tile is read once per 64 rows and
// split once, and no score leaves the registers. One warpgroup a CTA, 64
// rows:
//  - qkv_bwd_dq_tf32_kernel: 64 query rows; Q and dO split once into hi and
//    lo A operands in shared memory (K-major as stored); the row's lse and
//    delta in registers. One sweep over the keys in tiles of T (32 up to DP
//    = 96, 16 above, so that the operands fit 227 KB): K and V as stored are
//    the B of S = Q K^T and dP = dO V^T, K transposed the B of dQ += dS K.
//  - qkv_bwd_dkv_tf32_kernel: 64 key rows; K and V split once into A
//    operands. Q and dO stream in tiles of T (32 up to DP = 80, 16 above)
//    with their lse and delta: as stored the B of S^T = K Q^T and dP^T =
//    V dO^T, transposed the B of dV += P^T dO and dK += dS^T Q. Each key row
//    is written by one CTA: no atomics.
// The streamed side goes through a ring of two f32 stages filled by
// cp.async (16-byte vectors when the rows allow), the next tile in flight
// while this one is split and used; the transposed operands are split while
// the first two products of a tile run. TF32 wgmma reads both operands K-major
// only (no transpose bit), so a transposed B is built while it is split: its
// 8-row chunks hold their rows in the order 0, 2, 4, 6, 1, 3, 5, 7, and P or
// dS enters as the register A operand as the accumulator holds it (a
// thread's columns 2t, 2t + 1 of each 8 sit where a tf32 A fragment reads
// columns t, t + 4: qkv_fwd_tf32.cuh).

#pragma once

#include "qkv_fwd_tf32.cuh"

namespace tb {

using tf::chunk_desc;

constexpr int ROWS = 64;  // the rows a CTA (one warpgroup) owns
constexpr int THREADS = 128;
constexpr int RING = 2;   // f32 stages of the streamed side

// the streamed tile's rows, where the pass's operands fit its shared memory
template <int DP>
constexpr int dq_tile() { return DP <= 96 ? 32 : 16; }
template <int DP>
constexpr int dkv_tile() { return DP <= 80 ? 32 : 16; }

// wgmma m64nNk8 on tf32 operands, both from shared memory (N = the streamed
// tile's rows)
template <int N>
struct Ss;

template <>
struct Ss<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Ss<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b,
                                           int scale_d) {
    tf::MmaTf32<32>::ss(d, a, b, scale_d);
  }
};

// the f32 stage of a tile: R rows of a, then R rows of b (row stride DP +
// 4), then R floats of each of the two statistics when there are any
template <int DP, int R>
struct Stage {
  static constexpr int LDF = DP + 4;
  static constexpr int ROWS_F = 2 * R * LDF;
  template <bool STATS>
  static constexpr int floats() { return ROWS_F + (STATS ? 2 * R : 0); }
};

// rows [r0, r0 + R) of a and b (row strides lda, ldb) into an f32 stage,
// zero past n and past d; with stats, the lse and delta of those rows (zero
// past n); one cp.async group, empty past the last tile
template <int DP, int R, bool STATS>
__device__ __forceinline__ void load_tile(float* st, const float* a, long long lda,
                                          const float* b, long long ldb, const float* s0,
                                          const float* s1, int r0, int n, int d, bool vec) {
  constexpr int LDF = DP + 4;
  if (r0 < n) {
    if (vec) {
      constexpr int C = DP / 4;
      for (int u = threadIdx.x; u < 2 * R * C; u += THREADS) {
        const int rr = u / C, c = 4 * (u % C), row = r0 + rr % R;
        const bool in = row < n && c < d;
        const float* src =
            rr < R ? a + (in ? row * lda + c : 0) : b + (in ? row * ldb + c : 0);
        hop::cp_async16(st + rr * LDF + c, src, in ? 16 : 0);
      }
    } else {
      for (int u = threadIdx.x; u < 2 * R * DP; u += THREADS) {
        const int rr = u / DP, c = u % DP, row = r0 + rr % R;
        const bool in = row < n && c < d;
        const float* src =
            rr < R ? a + (in ? row * lda + c : 0) : b + (in ? row * ldb + c : 0);
        hop::cp_async4(st + rr * LDF + c, src, in ? 4 : 0);
      }
    }
    if (STATS && threadIdx.x < 2 * R) {
      const int i = threadIdx.x % R, row = r0 + i;
      const float* src = (threadIdx.x < R ? s0 : s1) + (row < n ? row : 0);
      hop::cp_async4(st + 2 * R * LDF + threadIdx.x, src, row < n ? 4 : 0);
    }
  }
  hop::cp_async_commit();
}

// R rows of a stage into the hi and lo B operands of a product over the
// head dim: chunk c (columns 8c .. 8c+7) holds the R rows
template <int DP, int R>
__device__ __forceinline__ void split_rows(unsigned char* hi, unsigned char* lo,
                                           const float* rows) {
  constexpr int LDF = DP + 4;
  for (int u = threadIdx.x; u < R * DP / 8; u += THREADS) {
    const int r = u % R, c = u / R;
    const float4 a = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c);
    const float4 b = *reinterpret_cast<const float4*>(rows + r * LDF + 8 * c + 4);
    uint4 h0, l0, h1, l1;
    tf::split4(a.x, a.y, a.z, a.w, h0, l0);
    tf::split4(b.x, b.y, b.z, b.w, h1, l1);
    tf::put_row(hi + c * R * 32, r, h0, h1);
    tf::put_row(lo + c * R * 32, r, l0, l1);
  }
}

// R rows of a stage transposed into the hi and lo B operands of a product
// over those rows: chunk c (rows 8c .. 8c+7) holds the DP columns as rows,
// its 8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7 (the A fragments' order)
template <int DP, int R>
__device__ __forceinline__ void split_cols(unsigned char* hi, unsigned char* lo,
                                           const float* rows) {
  constexpr int LDF = DP + 4;
  for (int u = threadIdx.x; u < R * DP / 8; u += THREADS) {
    const int e = u % DP, c = u / DP;
    const float* col = rows + 8 * c * LDF + e;
    uint4 h0, l0, h1, l1;
    tf::split4(col[0], col[2 * LDF], col[4 * LDF], col[6 * LDF], h0, l0);
    tf::split4(col[LDF], col[3 * LDF], col[5 * LDF], col[7 * LDF], h1, l1);
    tf::put_row(hi + c * DP * 32, e, h0, h1);
    tf::put_row(lo + c * DP * 32, e, l0, l1);
  }
}

// acc (64 x T) = A B^T over the head dim in three TF32 products: A's 64
// rows and B's T rows, each hi and lo, chunked over the DP columns
template <int DP, int T>
__device__ __forceinline__ void ss3(float (&acc)[T / 2], uint32_t ah, uint32_t al, uint32_t bh,
                                    uint32_t bl) {
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    Ss<T>::mma(acc, chunk_desc(ah, c, ROWS), chunk_desc(bh, c, T), c);
    Ss<T>::mma(acc, chunk_desc(ah, c, ROWS), chunk_desc(bl, c, T), 1);
    Ss<T>::mma(acc, chunk_desc(al, c, ROWS), chunk_desc(bh, c, T), 1);
  }
}

// acc (64 x DP) += F B over the T streamed rows in three TF32 products: F
// as register A fragments, B a transposed operand (DP rows a chunk)
template <int DP, int T>
__device__ __forceinline__ void rs3(float (&acc)[DP / 2], const uint32_t (&fh)[T / 8][4],
                                    const uint32_t (&fl)[T / 8][4], uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int c = 0; c < T / 8; ++c) {
    tf::MmaTf32<DP>::rs(acc, fh[c], chunk_desc(bh, c, DP), 1);
    tf::MmaTf32<DP>::rs(acc, fh[c], chunk_desc(bl, c, DP), 1);
    tf::MmaTf32<DP>::rs(acc, fl[c], chunk_desc(bh, c, DP), 1);
  }
}

// p of (query, key) from the product s (K1's rule above)
template <bool HAS_MASK>
__device__ __forceinline__ float k1_p(float s, float scale, int query, int key, int n,
                                      const unsigned char* mask, float lse) {
  return __expf(attn::score<HAS_MASK>(s, scale, query, key, n, mask) - lse);
}

// a row's lse and delta as the passes use them: lse +inf past n (p = 0),
// delta 0 past n and times n on a wholly masked row
template <bool HAS_MASK>
__device__ __forceinline__ void row_stats(float& ls, float& dl, int row, int n) {
  if (row >= n) {
    ls = INFINITY;
    dl = 0.f;
  } else if (HAS_MASK && ls == attn::MASKED) {
    dl *= (float)n;
  }
}

// a thread's two rows (r_lo and r_lo + 8) of a 64 x DP accumulator into
// the d columns of a panel (row stride ld), rows below n
template <int DP>
__device__ __forceinline__ void store_rows(float* base, long long ld, const float (&acc)[DP / 2],
                                           int r_lo, int n, int d) {
  const int kq = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    if (row >= n) continue;
    float* out = base + row * ld;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + kq;
      if (c < d) out[c] = acc[4 * j + 2 * hh];
      if (c + 1 < d) out[c + 1] = acc[4 * j + 2 * hh + 1];
    }
  }
}

template <int DP>
struct DqCta {
  static constexpr int T = dq_tile<DP>();
  static constexpr int A = ROWS * DP * 4;  // one A operand (hi or lo)
  static constexpr int BT = T * DP * 4;    // one streamed B operand
  static constexpr int STAGE = Stage<DP, T>::template floats<false>();
  static constexpr size_t SMEM = (size_t)4 * A + 6 * BT + (size_t)RING * STAGE * 4 + 1024;
  static_assert(SMEM <= tf::SMEM_MAX, "the dQ pass's operands must fit its shared memory");
};

template <int DP>
struct DkvCta {
  static constexpr int T = dkv_tile<DP>();
  static constexpr int A = ROWS * DP * 4;
  static constexpr int BT = T * DP * 4;
  static constexpr int STAGE = Stage<DP, T>::template floats<true>();
  static constexpr size_t SMEM =
      (size_t)4 * A + 8 * BT + 2 * T * 4 + (size_t)RING * STAGE * 4 + 1024;
  static_assert(SMEM <= tf::SMEM_MAX, "the dK/dV pass's operands must fit its shared memory");
};

// the (batch, head) cell's panels: q, k, v column blocks of the qkv panel
// (row stride 3 H d), dO (row stride H d), lse and delta rows (B, H, N)
struct Cell {
  const float *q, *k, *v, *g, *lse, *delta;
  float *dq, *dk, *dv;
  long long ld, ldg;
};

__device__ __forceinline__ Cell cell(const float* qkv, const float* g, const float* lse,
                                     const float* delta, float* dqkv, int n, int H, int d) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long ld = 3LL * H * d, hd = (long long)H * d, bh = ((long long)b * H + h) * n;
  const long long off = (long long)b * n * ld + (long long)h * d;
  return {qkv + off, qkv + off + hd, qkv + off + 2 * hd, g + (long long)b * n * hd + h * d,
          lse + bh, delta + bh, dqkv + off, dqkv + off + hd, dqkv + off + 2 * hd, ld, hd};
}

__device__ __forceinline__ bool aligned16(const float* a, const float* b, long long lda,
                                          long long ldb, int d) {
  return d % 4 == 0 && lda % 4 == 0 && ldb % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
qkv_bwd_dq_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const unsigned char* __restrict__ mask, float* __restrict__ dqkv, int n,
                       int H, int d, float scale) {
  using C = DqCta<DP>;
  constexpr int T = C::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* qh = smem;
  unsigned char* ql = qh + C::A;
  unsigned char* gh = ql + C::A;
  unsigned char* gl = gh + C::A;
  unsigned char* kh = gl + C::A;  // K as stored: the B of S
  unsigned char* kl = kh + C::BT;
  unsigned char* vh = kl + C::BT;  // V as stored: the B of dP
  unsigned char* vl = vh + C::BT;
  unsigned char* th = vl + C::BT;  // K transposed: the B of dQ
  unsigned char* tl = th + C::BT;
  float* stages = reinterpret_cast<float*>(tl + C::BT);
  const Cell x = cell(qkv, g, lse, delta, dqkv, n, H, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q0 = blockIdx.x * ROWS;
  const int r_lo = q0 + warp * 16 + lane / 4, r_hi = r_lo + 8, kq = 2 * (lane % 4);
  const bool vec = aligned16(x.k, x.v, x.ld, x.ld, d);
  const int tiles = (n + T - 1) / T;

#pragma unroll
  for (int i = 0; i < RING; ++i)
    load_tile<DP, T, false>(stages + i * C::STAGE, x.k, x.ld, x.v, x.ld, nullptr, nullptr, i * T,
                            n, d, vec);
  tf::q_smem<DP>(qh, ql, x.q, x.ld, q0, n, d);
  tf::q_smem<DP>(gh, gl, x.g, x.ldg, q0, n, d);
  float ls_lo = r_lo < n ? x.lse[r_lo] : 0.f, ls_hi = r_hi < n ? x.lse[r_hi] : 0.f;
  float dl_lo = r_lo < n ? x.delta[r_lo] : 0.f, dl_hi = r_hi < n ? x.delta[r_hi] : 0.f;
  row_stats<HAS_MASK>(ls_lo, dl_lo, r_lo, n);
  row_stats<HAS_MASK>(ls_hi, dl_hi, r_hi, n);
  const uint32_t aqh = hop::smem_u32(qh), aql = hop::smem_u32(ql);
  const uint32_t agh = hop::smem_u32(gh), agl = hop::smem_u32(gl);
  const uint32_t akh = hop::smem_u32(kh), akl = hop::smem_u32(kl);
  const uint32_t avh = hop::smem_u32(vh), avl = hop::smem_u32(vl);
  const uint32_t ath = hop::smem_u32(th), atl = hop::smem_u32(tl);

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    hop::cp_async_wait<RING - 1>();  // this thread's copies of tile t landed
    __syncthreads();  // everyone's; the products of tile t - 1 are done
    float* st = stages + (t % RING) * C::STAGE;
    split_rows<DP, T>(kh, kl, st);
    split_rows<DP, T>(vh, vl, st + T * Stage<DP, T>::LDF);
    hop::fence_proxy_async();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, K transposed split while they run
    float s[T / 2], dp[T / 2];
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wgmma_fence();
    ss3<DP, T>(s, aqh, aql, akh, akl);
    ss3<DP, T>(dp, agh, agl, avh, avl);
    hop::wgmma_commit();
    split_cols<DP, T>(th, tl, st);
    hop::fence_proxy_async();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);
    __syncthreads();  // everyone's K^T is written, and the stage is read
    load_tile<DP, T, false>(st, x.k, x.ld, x.v, x.ld, nullptr, nullptr, (t + RING) * T, n, d,
                            vec);

    // dS = P (dP - delta) scale into s
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * T + 8 * j + kq + e;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = k1_p<HAS_MASK>(lo, scale, r_lo, key, n, mask, ls_lo) * (dp[4 * j + e] - dl_lo) *
             scale;
        hi = k1_p<HAS_MASK>(hi, scale, r_hi, key, n, mask, ls_hi) *
             (dp[4 * j + 2 + e] - dl_hi) * scale;
      }
    }
    uint32_t fh[T / 8][4], fl[T / 8][4];
    tf::frags<T>(fh, fl, s);
    hop::fence_regs(dq);
    hop::wgmma_fence();
    rs3<DP, T>(dq, fh, fl, ath, atl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dq);
  }
  store_rows<DP>(x.dq, x.ld, dq, r_lo, n, d);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
qkv_bwd_dkv_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const unsigned char* __restrict__ mask, float* __restrict__ dqkv, int n,
                        int H, int d, float scale) {
  using C = DkvCta<DP>;
  constexpr int T = C::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kh = smem;
  unsigned char* kl = kh + C::A;
  unsigned char* vh = kl + C::A;
  unsigned char* vl = vh + C::A;
  unsigned char* qh = vl + C::A;  // Q as stored: the B of S^T
  unsigned char* ql = qh + C::BT;
  unsigned char* gh = ql + C::BT;  // dO as stored: the B of dP^T
  unsigned char* gl = gh + C::BT;
  unsigned char* qth = gl + C::BT;  // Q transposed: the B of dK
  unsigned char* qtl = qth + C::BT;
  unsigned char* gth = qtl + C::BT;  // dO transposed: the B of dV
  unsigned char* gtl = gth + C::BT;
  float* stats = reinterpret_cast<float*>(gtl + C::BT);  // the tile's lse, then delta
  float* stages = stats + 2 * T;
  const Cell x = cell(qkv, g, lse, delta, dqkv, n, H, d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, k0 = blockIdx.x * ROWS;
  const int r_lo = k0 + warp * 16 + lane / 4, r_hi = r_lo + 8, kq = 2 * (lane % 4);
  const bool vec = aligned16(x.q, x.g, x.ld, x.ldg, d);
  const int tiles = (n + T - 1) / T;

#pragma unroll
  for (int i = 0; i < RING; ++i)
    load_tile<DP, T, true>(stages + i * C::STAGE, x.q, x.ld, x.g, x.ldg, x.lse, x.delta, i * T,
                           n, d, vec);
  tf::q_smem<DP>(kh, kl, x.k, x.ld, k0, n, d);
  tf::q_smem<DP>(vh, vl, x.v, x.ld, k0, n, d);
  const uint32_t akh = hop::smem_u32(kh), akl = hop::smem_u32(kl);
  const uint32_t avh = hop::smem_u32(vh), avl = hop::smem_u32(vl);
  const uint32_t aqh = hop::smem_u32(qh), aql = hop::smem_u32(ql);
  const uint32_t agh = hop::smem_u32(gh), agl = hop::smem_u32(gl);
  const uint32_t aqth = hop::smem_u32(qth), aqtl = hop::smem_u32(qtl);
  const uint32_t agth = hop::smem_u32(gth), agtl = hop::smem_u32(gtl);

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    hop::cp_async_wait<RING - 1>();
    __syncthreads();
    float* st = stages + (t % RING) * C::STAGE;
    const float* gst = st + T * Stage<DP, T>::LDF;
    split_rows<DP, T>(qh, ql, st);
    split_rows<DP, T>(gh, gl, gst);
    if (threadIdx.x < T) {
      float ls = st[Stage<DP, T>::ROWS_F + threadIdx.x];
      float dl = st[Stage<DP, T>::ROWS_F + T + threadIdx.x];
      row_stats<HAS_MASK>(ls, dl, t * T + threadIdx.x, n);
      stats[threadIdx.x] = ls;
      stats[T + threadIdx.x] = dl;
    }
    hop::fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (keys in rows, the tile's queries in
    // columns), Q and dO transposed split while they run
    float s[T / 2], dp[T / 2];
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wgmma_fence();
    ss3<DP, T>(s, akh, akl, aqh, aql);
    ss3<DP, T>(dp, avh, avl, agh, agl);
    hop::wgmma_commit();
    split_cols<DP, T>(qth, qtl, st);
    split_cols<DP, T>(gth, gtl, gst);
    hop::fence_proxy_async();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);
    __syncthreads();  // everyone's Q^T and dO^T are written, and the stage is read
    load_tile<DP, T, true>(st, x.q, x.ld, x.g, x.ldg, x.lse, x.delta, (t + RING) * T, n, d,
                           vec);

    // P^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + kq + e, query = t * T + col;
        const float ls = stats[col], dl = stats[T + col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float p = k1_p<HAS_MASK>(s[i], scale, query, hh ? r_hi : r_lo, n, mask, ls);
          s[i] = p;
          dp[i] = p * (dp[i] - dl) * scale;
        }
      }
    }
    uint32_t ph[T / 8][4], pl[T / 8][4], fh[T / 8][4], fl[T / 8][4];
    tf::frags<T>(ph, pl, s);
    tf::frags<T>(fh, fl, dp);
    hop::fence_regs(dv);
    hop::fence_regs(dk);
    hop::wgmma_fence();
    rs3<DP, T>(dv, ph, pl, agth, agtl);
    rs3<DP, T>(dk, fh, fl, aqth, aqtl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dv);
    hop::fence_regs(dk);
  }
  store_rows<DP>(x.dk, x.ld, dk, r_lo, n, d);
  store_rows<DP>(x.dv, x.ld, dv, r_lo, n, d);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const float* qkv, const float* g,
                   const float* lse, const float* delta, const unsigned char* mask, float* dqkv,
                   int B, int n, int H, int d, float scale, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + ROWS - 1) / ROWS, H, B), THREADS, smem, st>>>(qkv, g, lse, delta, mask,
                                                                  dqkv, n, H, d, scale);
  return cudaGetLastError();
}

// the masked instantiation for a mask, the unmasked one for nullptr
template <int DP>
cudaError_t launch_dq(const float* qkv, const float* g, const float* lse, const float* delta,
                      const unsigned char* mask, float* dqkv, int B, int n, int H, int d,
                      float scale, cudaStream_t st) {
  return launch(mask != nullptr ? qkv_bwd_dq_tf32_kernel<DP, true>
                                : qkv_bwd_dq_tf32_kernel<DP, false>,
                DqCta<DP>::SMEM, qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale, st);
}

template <int DP>
cudaError_t launch_dkv(const float* qkv, const float* g, const float* lse, const float* delta,
                       const unsigned char* mask, float* dqkv, int B, int n, int H, int d,
                       float scale, cudaStream_t st) {
  return launch(mask != nullptr ? qkv_bwd_dkv_tf32_kernel<DP, true>
                                : qkv_bwd_dkv_tf32_kernel<DP, false>,
                DkvCta<DP>::SMEM, qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale, st);
}

}  // namespace tb
