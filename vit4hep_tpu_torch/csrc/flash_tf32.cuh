// K7's passes in split TF32 on the Hopper tensor cores (sm_90a): the
// streaming flash attention on separated (B, H, N, D) f32 tensors, forward,
// dK/dV and dQ, with its operands split into tf32 hi and lo parts once a
// call by a pre-pass of its own.
//
// Replaces the Pallas TPU kernels of `flash_attention`
// (vit4hep_tpu/ops/flash_attention.py:188): `_fwd_kernel` (:39, call :219),
// `_bwd_dkv_kernel` (:84, call :278) and `_bwd_dq_kernel` (:128, call :309).
// The TPU kernel casts every operand to f32 (:40-48, :88-101, :132-142), so
// each product here runs as three TF32 wgmma products, hi hi + hi lo + lo
// hi, with hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest, and
// f32 accumulators (qkv_fwd_tf32.cuh explains the split): ~2^-21 of each
// product term, where one TF32 product misses the f32 contract's 1e-4 by
// 10x.
//
// What bounds it: at the ds3_long serving shape (2, 6, 13500, 80) the
// forward's 7.0e11 f32-contract FLOP are 2.1e12 TF32 FLOP (4.24 ms at
// 494.7 TFLOP/s), the dK/dV pass's 8.5 ms, the dQ pass's 6.4 ms, against
// ~0.1 GB of operands: operations. What stood between K1's split-TF32
// kernels and that rate was the split itself (a streamed tile took ~3,000
// cycles to split against ~2,600 of products, PERF.md section 6), done by
// every CTA for every tile it streams: at 13,500 tokens each K/V tile by
// the 211 query CTAs of its head. Here it leaves the loops:
//
//  - k7_split_kernel: the pre-pass. It reads each strided f32 operand once
//    and writes its hi and lo parts into contiguous buffers of N_pad = N
//    rounded up to 64 rows and DP = 16 ceil(d / 16) columns, zero past N
//    and past d, in the two K-major layouts TF32 wgmma reads (it has no
//    transpose bit), 32-byte swizzle already applied:
//      rows: X as stored (K for S = Q K^T, Q and dO for S^T = K Q^T and
//        dP^T = V dO^T, and the A operands Q, dO, K, V): 8-row group g,
//        8-column chunk c, row r of the group at byte g DP 32 + c 256 + r
//        32, its two 16-byte halves swapped on rows with r / 4 odd;
//      cols: X^T (V for O += P V, K for dQ += dS K, Q and dO for dK += dS^T
//        Q and dV += P^T dO): 8-row chunk k, column e at byte k DP 32 + e
//        32, its 8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7, so that P and
//        dS enter as the register A operand as the accumulator holds them
//        (qkv_fwd_tf32.cuh), halves swapped on columns with (e % 8) / 4 odd.
//    Any run of whole 8-row groups is contiguous in either layout, so a
//    tile of T rows is one bulk copy of T DP 4 bytes: its descriptors take
//    a stride of DP 32 bytes between 8-row groups (rows) or 256 (cols).
//  - k7_fwd_kernel<DP, HAS_MASK>: 64 query rows a consumer warpgroup, two
//    warpgroups a CTA (one above DP = 96, where Q lives in shared memory),
//    Q split once into registers; K (rows) and V^T (cols) stream in tiles
//    of 32 keys through a ring of 2-4 stages filled by bulk copies
//    (cp.async.bulk, completing on mbarriers) that one producer thread
//    issues (its warpgroup hands its registers to the two consumer ones
//    through setmaxnreg); K1's online softmax in the registers
//    (qkv_fwd_tf32.cuh).
//  - k7_bwd_dkv_kernel<DP, HAS_MASK>: 64 key rows, K and V (rows) as the
//    shared-memory A operands; Q and dO stream in tiles of 32 queries (16
//    above DP = 80, where the operands would not fit), each tile in two
//    halves through a ring of three slots: Q, dO (rows) with the tile's
//    padded lse and delta for S^T and dP^T, then Q^T, dO^T (cols) for dK
//    and dV. Each key row is written by one CTA: no atomics.
//  - k7_bwd_dq_kernel<DP, HAS_MASK>: 64 query rows, Q and dO (rows) as the
//    A operands; K, V (rows) then K^T (cols) stream in halves the same way;
//    the rows' lse and delta in registers.
// Every consumer warp signals a slot free on its mbarrier once its products
// have read it, so the producer refills it while the next slot is used.
//
// JAX's masked-key semantics, not K1's: a masked score is -1e30 in the
// forward (a wholly masked row gets the mean of V over the N real keys,
// lse -1e30 + log N = -1e30 in f32) and -inf in the backward (`attn::score`
// with ZERO_MASKED), so a masked key weighs exactly 0 there and a wholly
// masked row adds nothing to dK and dV and gets dQ 0. A key past N is -inf
// in both. p is the fast exp of that selected exponent, never a select
// between an exponential and 0 (PERF.md section 6: ptxas miscompiled that
// form in K6's masked dQ pass). A query past N takes lse +inf (its padded
// lse), so its p is exactly 0.

#pragma once

#include "qkv_bwd_tf32.cuh"

namespace k7 {

constexpr int SMEM_MAX = 232448;
constexpr int PAD = 64;  // the split buffers' rows: N rounded up to PAD

__host__ __device__ constexpr int n_padded(int n) { return (n + PAD - 1) / PAD * PAD; }

__host__ __device__ constexpr int round256(int bytes) { return (bytes + 255) / 256 * 256; }

// `bytes` (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(hop::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hop::smem_u32(bar))
      : "memory");
}

// the consumer warpgroup's own barrier (128 threads; the producer warp is
// not in it)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// descriptor of k8 step c of a rows-layout operand (8-row groups DP 32 bytes
// apart)
template <int DP>
__device__ __forceinline__ uint64_t rdesc(uint32_t base, int c) {
  return hop::desc(base + c * 256, 16, DP * 32, hop::SW32);
}

// ------------------------------------------------------------------ pre-pass
// one operand: x (B, H, N, D) f32 at strides (sb, sh, sn), unit column
// stride; the hi and lo buffers of its rows and cols layouts, each nullptr
// where the call does not need it
struct SplitJob {
  const float* x;
  long long sb, sh, sn;
  float *rows_hi, *rows_lo, *cols_hi, *cols_lo;
};
constexpr int MAX_JOBS = 4;
struct SplitJobs {
  SplitJob job[MAX_JOBS];
};

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint4 h, l;
  tf::split4(x.x, x.y, x.z, x.w, h, l);
  lo = make_float4(__uint_as_float(l.x), __uint_as_float(l.y), __uint_as_float(l.z),
                   __uint_as_float(l.w));
  return make_float4(__uint_as_float(h.x), __uint_as_float(h.y), __uint_as_float(h.z),
                     __uint_as_float(h.w));
}

// one thread per 16-byte unit of a cell's buffer (N_pad DP / 4 units),
// blockIdx.y the job; the unit's four values gathered from x, 0 past n and d
template <int DP>
__global__ void __launch_bounds__(256)
k7_split_kernel(SplitJobs jobs, int H, int n, int n_pad, int d, long long units) {
  const long long u = (long long)blockIdx.x * 256 + threadIdx.x;
  if (u >= units) return;
  const SplitJob& j = jobs.job[blockIdx.y];
  const int cell_units = n_pad * DP / 4;
  const long long bh = u / cell_units;
  const int w = (int)(u % cell_units);
  const float* xb = j.x + (bh / H) * j.sb + (bh % H) * j.sh;
  const int g = w / (2 * DP), rem = w % (2 * DP);  // 8-row group (rows) or chunk (cols)
  if (j.rows_hi != nullptr) {
    const int c = rem >> 4, r = (rem >> 1) & 7, half = (rem & 1) ^ ((r >> 2) & 1);
    const int row = 8 * g + r, col = 8 * c + 4 * half;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = row < n && col + i < d ? xb[(long long)row * j.sn + col + i] : 0.f;
    float4 lo;
    const float4 hi = split4(make_float4(v[0], v[1], v[2], v[3]), lo);
    reinterpret_cast<float4*>(j.rows_hi)[u] = hi;
    reinterpret_cast<float4*>(j.rows_lo)[u] = lo;
  }
  if (j.cols_hi != nullptr) {
    const int e = rem >> 1, half = (rem & 1) ^ ((e >> 2) & 1);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 8 * g + half + 2 * i;  // slots 0-3: keys 0, 2, 4, 6; 4-7: 1, 3, 5, 7
      v[i] = key < n && e < d ? xb[(long long)key * j.sn + e] : 0.f;
    }
    float4 lo;
    const float4 hi = split4(make_float4(v[0], v[1], v[2], v[3]), lo);
    reinterpret_cast<float4*>(j.cols_hi)[u] = hi;
    reinterpret_cast<float4*>(j.cols_lo)[u] = lo;
  }
}

// ------------------------------------------------------------------- forward
// Q in shared memory above DP = 96 (its fragments would not fit the
// registers beside O) and in the masked kernel at DP = 32: with Q's
// fragments in registers there, ptxas took them for scratch once a tile's
// products had read them, as in K1's forward, and the forward missed f64
// by 1.8e-4 to 2.7e-4 of the scale (PERF.md section 6)
template <int DP, bool HAS_MASK>
__host__ __device__ constexpr bool fwd_q_smem() {
  return DP > 96 || (HAS_MASK && DP == 32);
}

template <int DP, bool QS>
struct Fwd {
  static constexpr int WG = QS ? 1 : 2;   // consumer warpgroups
  static constexpr int ROWS = 64 * WG;
  // and the producer: a warp, or with two consumer warpgroups a warpgroup
  // of its own that hands its registers to them (setmaxnreg: 12 warps an SM
  // start at 168 registers a thread, and the consumers' S, P, O and Q
  // fragments need more at DP 64-96)
  static constexpr int PRODUCER = WG == 2 ? 128 : 32;
  static constexpr int THREADS = 128 * WG + PRODUCER;
  static constexpr int KT = 32;           // keys of a tile
  static constexpr int TILE = KT * DP * 4;  // one hi or lo operand of a tile
  static constexpr int STAGE = 4 * TILE;  // K hi, K lo, V^T hi, V^T lo
  static constexpr int QTILE = QS ? 64 * DP * 4 : 0;
  static constexpr int FIT = (SMEM_MAX - 2048 - 2 * QTILE) / STAGE;
  static constexpr int RING = FIT > 4 ? 4 : FIT;
  static constexpr size_t SMEM = (size_t)RING * STAGE + 2 * QTILE + 1024 + 2 * RING * 8;
  static_assert(RING >= 2 && SMEM <= SMEM_MAX, "the forward's ring must fit shared memory");
};

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(Fwd<DP, fwd_q_smem<DP, HAS_MASK>()>::THREADS, 1)
k7_fwd_kernel(const float* __restrict__ q, long long sb, long long sh, long long sn,
              const float* __restrict__ k_hi, const float* __restrict__ k_lo,
              const float* __restrict__ vt_hi, const float* __restrict__ vt_lo,
              const unsigned char* __restrict__ mask, float* __restrict__ out,
              float* __restrict__ lse, int H, int n, int n_pad, int d, float scale) {
  using C = Fwd<DP, fwd_q_smem<DP, HAS_MASK>()>;
  constexpr int KT = C::KT, RING = C::RING;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* qhs = smem + RING * C::STAGE;
  unsigned char* qls = qhs + C::QTILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(qls + C::QTILE);
  uint64_t* empty = full + RING;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::ROWS;
  const int n_active = min(C::WG, (n - q0 + 63) / 64);  // warpgroups with a row below n
  const int tiles = (n + KT - 1) / KT;
  const size_t cell = ((size_t)b * H + h) * (size_t)n_pad * DP;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 4 * n_active);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::WG) {  // the producer: one thread keeps the ring full
    if constexpr (C::WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % RING;
        if (t >= RING) hop::mbar_wait(&empty[s], (t / RING + 1) & 1);
        unsigned char* st = smem + s * C::STAGE;
        const size_t off = cell + (size_t)t * KT * DP;
        hop::mbar_expect_tx(&full[s], C::STAGE);
        bulk_load(st, k_hi + off, C::TILE, &full[s]);
        bulk_load(st + C::TILE, k_lo + off, C::TILE, &full[s]);
        bulk_load(st + 2 * C::TILE, vt_hi + off, C::TILE, &full[s]);
        bulk_load(st + 3 * C::TILE, vt_lo + off, C::TILE, &full[s]);
      }
    }
    return;
  }
  if constexpr (C::WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  if (wg >= n_active) return;  // all its rows past n: it takes no part

  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, kq = 2 * (lane % 4);
  const int r_lo = q0 + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const float* qb = q + (size_t)b * sb + (size_t)h * sh;
  uint32_t qh[C::QTILE ? 1 : DP / 8][4], ql[C::QTILE ? 1 : DP / 8][4];
  if constexpr (C::QTILE != 0) {
    tf::q_smem<DP>(qhs, qls, qb, sn, q0, n, d);
    hop::fence_proxy_async();
    consumers_sync();
  } else {
    tf::q_frags<DP>(qh, ql, qb, sn, r_lo, n, d);
  }
  const uint32_t aqh = hop::smem_u32(qhs), aql = hop::smem_u32(qls);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int s = t % RING;
    hop::mbar_wait(&full[s], (t / RING) & 1);
    const uint32_t kh = hop::smem_u32(smem + s * C::STAGE), kl = kh + C::TILE;
    const uint32_t vh = kh + 2 * C::TILE, vl = kh + 3 * C::TILE;

    // S = Q K^T in three TF32 products
    float sc[KT / 2];
    hop::fence_regs(sc);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      if constexpr (C::QTILE != 0) {
        tf::MmaTf32<KT>::ss(sc, tf::q_desc(aqh, c), rdesc<DP>(kh, c), c);
        tf::MmaTf32<KT>::ss(sc, tf::q_desc(aqh, c), rdesc<DP>(kl, c), 1);
        tf::MmaTf32<KT>::ss(sc, tf::q_desc(aql, c), rdesc<DP>(kh, c), 1);
      } else {
        tf::MmaTf32<KT>::rs(sc, qh[c], rdesc<DP>(kh, c), c);
        tf::MmaTf32<KT>::rs(sc, qh[c], rdesc<DP>(kl, c), 1);
        tf::MmaTf32<KT>::rs(sc, ql[c], rdesc<DP>(kh, c), 1);
      }
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // scale, mask (-1e30) and the pad guard (-inf past n); the running max
    // and sum of the thread's two rows
    const int k0 = t * KT + kq;
    float t_lo = -INFINITY, t_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + e;
        float& lo = sc[4 * j + e];
        float& hi = sc[4 * j + 2 + e];
        lo = attn::score<HAS_MASK>(lo, scale, r_lo, key, n, mask);
        hi = attn::score<HAS_MASK>(hi, scale, r_hi, key, n, mask);
        t_lo = fmaxf(t_lo, lo);
        t_hi = fmaxf(t_hi, hi);
      }
    }
    // every tile holds a key below n: the tile max is finite (a real score
    // or -1e30), and exp(-inf - m) = 0 on the first tile
    const float mn_lo = fmaxf(m_lo, tf::quad_max(t_lo)), mn_hi = fmaxf(m_hi, tf::quad_max(t_hi));
    const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ls_lo = 0.f, ls_hi = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& lo = sc[4 * j + e];
        float& hi = sc[4 * j + 2 + e];
        lo = __expf(lo - mn_lo);
        hi = __expf(hi - mn_hi);
        ls_lo += lo;
        ls_hi += hi;
      }
    }
    l_lo = l_lo * al_lo + tf::quad_sum(ls_lo);
    l_hi = l_hi * al_hi + tf::quad_sum(ls_hi);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al_lo;
      o[4 * j + 1] *= al_lo;
      o[4 * j + 2] *= al_hi;
      o[4 * j + 3] *= al_hi;
    }
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
    tf::frags<KT>(ph, pl, sc);
    hop::fence_regs(o);
    hop::wgmma_fence();
    tb::rs3<DP, KT>(o, ph, pl, vh, vl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    if (lane == 0) hop::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // O / l into the contiguous (B, H, N, D) output, m + log l into the lse
  const size_t bh = (size_t)b * H + h;
  float* ob = out + bh * n * d;
  float* lb = lse + bh * n;
  const bool pairs = d % 2 == 0 && (reinterpret_cast<uintptr_t>(ob) & 7) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = hh ? r_hi : r_lo;
    if (row >= n) continue;
    const float l = hh ? l_hi : l_lo, inv = 1.f / l;
    float* orow = ob + (size_t)row * d;
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

// ------------------------------------------------------------------ backward
// acc (64 x T) = A B^T over the head dim in three TF32 products, A (64 rows)
// and B (T rows) both in the rows layout
template <int DP, int T>
__device__ __forceinline__ void ss3(float (&acc)[T / 2], uint32_t ah, uint32_t al, uint32_t bh,
                                    uint32_t bl) {
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    tb::Ss<T>::mma(acc, rdesc<DP>(ah, c), rdesc<DP>(bh, c), c);
    tb::Ss<T>::mma(acc, rdesc<DP>(ah, c), rdesc<DP>(bl, c), 1);
    tb::Ss<T>::mma(acc, rdesc<DP>(al, c), rdesc<DP>(bh, c), 1);
  }
}

// the backward passes' shared memory: the four A operands (64 rows of two
// tensors, hi and lo), then NSLOT slots the streamed halves of the tiles
// pass through (first half: two rows-layout tensors, hi and lo, and with
// STATS the tile's lse and delta; second half: one (dQ) or two (dK/dV)
// cols-layout tensors), then the mbarriers
template <int DP, bool DKV>
constexpr int half_bytes(int t) {
  return round256(4 * t * DP * 4 + (DKV ? 2 * t * 4 : 0));
}

template <int DP, bool DKV>
struct Bwd {
  static constexpr int A = 64 * DP * 4;
  static constexpr int NSLOT = 3;
  static constexpr int T =
      4 * A + NSLOT * half_bytes<DP, DKV>(32) + 2048 <= SMEM_MAX ? 32 : 16;
  static constexpr int TB = T * DP * 4;  // one streamed operand (hi or lo) of a tile
  static constexpr int SLOT = half_bytes<DP, DKV>(T);
  static constexpr size_t SMEM = (size_t)4 * A + (size_t)NSLOT * SLOT + 1024 + 256;
  static_assert(SMEM <= SMEM_MAX, "a backward pass's operands must fit shared memory");
};

// the producer's schedule of a backward pass: the A operands on `abar`, then
// half i of the stream (tile i / 2: even the rows half, odd the cols half)
// into slot i % NSLOT once the consumers have freed it
template <int DP, bool DKV>
__device__ __forceinline__ void bwd_produce(unsigned char* smem, uint64_t* abar, uint64_t* full,
                                            uint64_t* empty, const float* const (&a)[4],
                                            const float* const (&rows)[4],
                                            const float* const (&cols)[4], const float* s0,
                                            const float* s1, size_t cell, size_t stats, int r0,
                                            int tiles) {
  using C = Bwd<DP, DKV>;
  constexpr int NC = DKV ? 4 : 2;  // cols-layout operands of the second half
  hop::mbar_expect_tx(abar, 4 * C::A);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bulk_load(smem + i * C::A, a[i] + cell + (size_t)r0 * DP, C::A, abar);
  unsigned char* slots = smem + 4 * C::A;
  for (int i = 0; i < 2 * tiles; ++i) {
    const int s = i % C::NSLOT, t = i / 2;
    if (i >= C::NSLOT) hop::mbar_wait(&empty[s], (i / C::NSLOT + 1) & 1);
    unsigned char* dst = slots + s * C::SLOT;
    const size_t off = cell + (size_t)t * C::T * DP;
    if (i % 2 == 0) {
      hop::mbar_expect_tx(&full[s], 4 * C::TB + (DKV ? 2 * C::T * 4 : 0));
#pragma unroll
      for (int k = 0; k < 4; ++k) bulk_load(dst + k * C::TB, rows[k] + off, C::TB, &full[s]);
      if constexpr (DKV) {
        bulk_load(dst + 4 * C::TB, s0 + stats + (size_t)t * C::T, C::T * 4, &full[s]);
        bulk_load(dst + 4 * C::TB + C::T * 4, s1 + stats + (size_t)t * C::T, C::T * 4, &full[s]);
      }
    } else {
      hop::mbar_expect_tx(&full[s], NC * C::TB);
#pragma unroll
      for (int k = 0; k < NC; ++k) bulk_load(dst + k * C::TB, cols[k] + off, C::TB, &full[s]);
    }
  }
}

// a thread's two rows (r_lo, r_lo + 8) of a 64 x DP accumulator into a
// contiguous (N, d) panel, rows below n
template <int DP>
__device__ __forceinline__ void store_rows(float* base, const float (&acc)[DP / 2], int r_lo,
                                           int n, int d) {
  const int kq = 2 * (threadIdx.x % 4);
  const bool pairs = d % 2 == 0 && (reinterpret_cast<uintptr_t>(base) & 7) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    if (row >= n) continue;
    float* out = base + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + kq;
      const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (pairs && c < d) {
        *reinterpret_cast<float2*>(out + c) = make_float2(v0, v1);
      } else {
        if (c < d) out[c] = v0;
        if (c + 1 < d) out[c + 1] = v1;
      }
    }
  }
}

// p of (query, key): the exponent selected first (-inf masked or past n)
template <bool HAS_MASK>
__device__ __forceinline__ float k7_p(float s, float scale, int query, int key, int n,
                                      const unsigned char* mask, float lse) {
  return __expf(attn::score<HAS_MASK, true>(s, scale, query, key, n, mask) - lse);
}

// the split operands of the backward: {hi, lo} of each layout (the wrappers
// fill ops/flash_attention.py's BwdOps, built with these field names in this
// order, by name)
struct BwdOps {
  const float *q_hi, *q_lo, *g_hi, *g_lo, *k_hi, *k_lo, *v_hi, *v_lo;  // rows
  const float *qt_hi, *qt_lo, *gt_hi, *gt_lo, *kt_hi, *kt_lo;            // cols
};

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(160)
k7_bwd_dq_kernel(BwdOps x, const float* __restrict__ lse, const float* __restrict__ delta,
                 const unsigned char* __restrict__ mask, float* __restrict__ dq, int H, int n,
                 int n_pad, int d, float scale) {
  using C = Bwd<DP, false>;
  constexpr int T = C::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* slots = smem + 4 * C::A;
  uint64_t* abar = reinterpret_cast<uint64_t*>(slots + C::NSLOT * C::SLOT);
  uint64_t* full = abar + 1;
  uint64_t* empty = full + C::NSLOT;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * 64;
  const size_t bh = (size_t)b * H + h, cell = bh * n_pad * DP;
  const int tiles = (n + T - 1) / T;
  if (threadIdx.x == 0) {
    hop::mbar_init(abar, 1);
    for (int i = 0; i < C::NSLOT; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 4);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {
      const float* const a[4] = {x.q_hi, x.q_lo, x.g_hi, x.g_lo};
      const float* const rows[4] = {x.k_hi, x.k_lo, x.v_hi, x.v_lo};
      const float* const cols[4] = {x.kt_hi, x.kt_lo, nullptr, nullptr};
      bwd_produce<DP, false>(smem, abar, full, empty, a, rows, cols, nullptr, nullptr, cell, 0,
                             q0, tiles);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, kq = 2 * (lane % 4);
  const int r_lo = q0 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const float* lb = lse + bh * n;
  const float* db = delta + bh * n;
  // lse +inf past n: p = 0 there
  const float ls_lo = r_lo < n ? lb[r_lo] : INFINITY, ls_hi = r_hi < n ? lb[r_hi] : INFINITY;
  const float dl_lo = r_lo < n ? db[r_lo] : 0.f, dl_hi = r_hi < n ? db[r_hi] : 0.f;
  const uint32_t aqh = hop::smem_u32(smem), aql = aqh + C::A;
  const uint32_t agh = aqh + 2 * C::A, agl = aqh + 3 * C::A;
  const uint32_t aslots = hop::smem_u32(slots);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  hop::mbar_wait(abar, 0);
  for (int t = 0; t < tiles; ++t) {
    // S = Q K^T and dP = dO V^T from the rows half
    const int sr = (2 * t) % C::NSLOT;
    hop::mbar_wait(&full[sr], ((2 * t) / C::NSLOT) & 1);
    const uint32_t kh = aslots + sr * C::SLOT, kl = kh + C::TB, vh = kh + 2 * C::TB,
                   vl = kh + 3 * C::TB;
    float s[T / 2], dp[T / 2];
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wgmma_fence();
    ss3<DP, T>(s, aqh, aql, kh, kl);
    ss3<DP, T>(dp, agh, agl, vh, vl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);
    if (lane == 0) hop::mbar_arrive(&empty[sr]);

    // dS = P (dP - delta) scale into s
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * T + 8 * j + kq + e;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = k7_p<HAS_MASK>(lo, scale, r_lo, key, n, mask, ls_lo) * (dp[4 * j + e] - dl_lo) *
             scale;
        hi = k7_p<HAS_MASK>(hi, scale, r_hi, key, n, mask, ls_hi) *
             (dp[4 * j + 2 + e] - dl_hi) * scale;
      }
    }
    uint32_t fh[T / 8][4], fl[T / 8][4];
    tf::frags<T>(fh, fl, s);

    // dQ += dS K from the cols half
    const int sc = (2 * t + 1) % C::NSLOT;
    hop::mbar_wait(&full[sc], ((2 * t + 1) / C::NSLOT) & 1);
    const uint32_t th = aslots + sc * C::SLOT, tl = th + C::TB;
    hop::fence_regs(acc);
    hop::wgmma_fence();
    tb::rs3<DP, T>(acc, fh, fl, th, tl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (lane == 0) hop::mbar_arrive(&empty[sc]);
  }
  store_rows<DP>(dq + bh * n * d, acc, r_lo, n, d);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(160)
k7_bwd_dkv_kernel(BwdOps x, const float* __restrict__ lse_p, const float* __restrict__ delta_p,
                  const unsigned char* __restrict__ mask, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int n, int n_pad, int d, float scale) {
  using C = Bwd<DP, true>;
  constexpr int T = C::T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* slots = smem + 4 * C::A;
  uint64_t* abar = reinterpret_cast<uint64_t*>(slots + C::NSLOT * C::SLOT);
  uint64_t* full = abar + 1;
  uint64_t* empty = full + C::NSLOT;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * 64;
  const size_t bh = (size_t)b * H + h, cell = bh * n_pad * DP;
  const int tiles = (n + T - 1) / T;
  if (threadIdx.x == 0) {
    hop::mbar_init(abar, 1);
    for (int i = 0; i < C::NSLOT; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 4);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {
      const float* const a[4] = {x.k_hi, x.k_lo, x.v_hi, x.v_lo};
      const float* const rows[4] = {x.q_hi, x.q_lo, x.g_hi, x.g_lo};
      const float* const cols[4] = {x.qt_hi, x.qt_lo, x.gt_hi, x.gt_lo};
      bwd_produce<DP, true>(smem, abar, full, empty, a, rows, cols, lse_p, delta_p, cell,
                            bh * n_pad, k0, tiles);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, kq = 2 * (lane % 4);
  const int r_lo = k0 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const uint32_t akh = hop::smem_u32(smem), akl = akh + C::A;
  const uint32_t avh = akh + 2 * C::A, avl = akh + 3 * C::A;
  const uint32_t aslots = hop::smem_u32(slots);

  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  hop::mbar_wait(abar, 0);
  for (int t = 0; t < tiles; ++t) {
    // S^T = K Q^T and dP^T = V dO^T (keys in rows, the tile's queries in
    // columns) from the rows half
    const int sr = (2 * t) % C::NSLOT;
    hop::mbar_wait(&full[sr], ((2 * t) / C::NSLOT) & 1);
    const uint32_t qh = aslots + sr * C::SLOT, ql = qh + C::TB, gh = qh + 2 * C::TB,
                   gl = qh + 3 * C::TB;
    const float* stats = reinterpret_cast<const float*>(slots + sr * C::SLOT + 4 * C::TB);
    float s[T / 2], dp[T / 2];
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wgmma_fence();
    ss3<DP, T>(s, akh, akl, qh, ql);
    ss3<DP, T>(dp, avh, avl, gh, gl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);

    // P^T into s, dS^T into dp; the tile's lse (+inf past n) and delta
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + kq + e, query = t * T + col;
        const float ls = stats[col], dl = stats[T + col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float p = k7_p<HAS_MASK>(s[i], scale, query, hh ? r_hi : r_lo, n, mask, ls);
          s[i] = p;
          dp[i] = p * (dp[i] - dl) * scale;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[sr]);  // products and stats read
    uint32_t ph[T / 8][4], pl[T / 8][4], fh[T / 8][4], fl[T / 8][4];
    tf::frags<T>(ph, pl, s);
    tf::frags<T>(fh, fl, dp);

    // dV += P^T dO and dK += dS^T Q from the cols half
    const int sc = (2 * t + 1) % C::NSLOT;
    hop::mbar_wait(&full[sc], ((2 * t + 1) / C::NSLOT) & 1);
    const uint32_t qth = aslots + sc * C::SLOT, qtl = qth + C::TB, gth = qth + 2 * C::TB,
                   gtl = qth + 3 * C::TB;
    hop::fence_regs(acc_v);
    hop::fence_regs(acc_k);
    hop::wgmma_fence();
    tb::rs3<DP, T>(acc_v, ph, pl, gth, gtl);
    tb::rs3<DP, T>(acc_k, fh, fl, qth, qtl);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc_v);
    hop::fence_regs(acc_k);
    if (lane == 0) hop::mbar_arrive(&empty[sc]);
  }
  store_rows<DP>(dk + bh * n * d, acc_k, r_lo, n, d);
  store_rows<DP>(dv + bh * n * d, acc_v, r_lo, n, d);
}

// ------------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch_split(const SplitJobs& jobs, int njobs, int B, int H, int n, int d,
                         cudaStream_t st) {
  const long long units = (long long)B * H * n_padded(n) * DP / 4;
  k7_split_kernel<DP><<<dim3((unsigned)((units + 255) / 256), njobs), 256, 0, st>>>(
      jobs, H, n, n_padded(n), d, units);
  return cudaGetLastError();
}

template <int DP, bool HAS_MASK>
cudaError_t launch_fwd_as(const float* q, long long sb, long long sh, long long sn,
                          const float* const (&kv)[4], const unsigned char* mask, float* out,
                          float* lse, int B, int H, int n, int d, float scale, cudaStream_t st) {
  using C = Fwd<DP, fwd_q_smem<DP, HAS_MASK>()>;
  auto kernel = k7_fwd_kernel<DP, HAS_MASK>;
  cudaError_t e = prepare(kernel, C::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + C::ROWS - 1) / C::ROWS, H, B), C::THREADS, C::SMEM, st>>>(
      q, sb, sh, sn, kv[0], kv[1], kv[2], kv[3], mask, out, lse, H, n, n_padded(n), d, scale);
  return cudaGetLastError();
}

// the masked instantiation for a mask, the unmasked one for nullptr
template <int DP>
cudaError_t launch_fwd(const float* q, long long sb, long long sh, long long sn,
                       const float* const (&kv)[4], const unsigned char* mask, float* out,
                       float* lse, int B, int H, int n, int d, float scale, cudaStream_t st) {
  return mask != nullptr
             ? launch_fwd_as<DP, true>(q, sb, sh, sn, kv, mask, out, lse, B, H, n, d, scale, st)
             : launch_fwd_as<DP, false>(q, sb, sh, sn, kv, mask, out, lse, B, H, n, d, scale, st);
}

template <int DP>
cudaError_t launch_dq(const BwdOps& x, const float* lse, const float* delta,
                      const unsigned char* mask, float* dq, int B, int H, int n, int d,
                      float scale, cudaStream_t st) {
  auto kernel = mask != nullptr ? k7_bwd_dq_kernel<DP, true> : k7_bwd_dq_kernel<DP, false>;
  cudaError_t e = prepare(kernel, Bwd<DP, false>::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + 63) / 64, H, B), 160, Bwd<DP, false>::SMEM, st>>>(
      x, lse, delta, mask, dq, H, n, n_padded(n), d, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const BwdOps& x, const float* lse_p, const float* delta_p,
                       const unsigned char* mask, float* dk, float* dv, int B, int H, int n,
                       int d, float scale, cudaStream_t st) {
  auto kernel = mask != nullptr ? k7_bwd_dkv_kernel<DP, true> : k7_bwd_dkv_kernel<DP, false>;
  cudaError_t e = prepare(kernel, Bwd<DP, true>::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + 63) / 64, H, B), 160, Bwd<DP, true>::SMEM, st>>>(
      x, lse_p, delta_p, mask, dk, dv, H, n, n_padded(n), d, scale);
  return cudaGetLastError();
}

}  // namespace k7
