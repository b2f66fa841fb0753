// K8's forward and backward on wgmma, for Hopper (sm_90a): the one-shot
// exact-softmax attention of `vmem_attention` on separated (B, H, N, D) f32
// slabs (strided views of the ViT's qkv panel included), with an optional
// shared (N, N) mask.
//
// Replaces the TPU kernels `_oneshot_kernel`
// (vit4hep_tpu/ops/vmem_attention.py:47, pallas_call :111) and `_bwd_kernel`
// (:140, pallas_call :193). The TPU kernel holds a (batch, head)'s whole
// (N, N) score block in VMEM and takes the softmax in one max/exp/sum over
// it; here the scores live in the registers of a wgmma accumulator, 64 keys
// at a time, and the kernels keep that function:
//  - forward: s = bf16(q) bf16(k)^T in f32 times the scale; a masked score
//    is the finite -1e30; m is the row's max over every key (a key past n
//    does not count), p = exp(s - m), l = sum p in f32, O = bf16(p) bf16(v)
//    / l (l = 0 read as 1), lse = m + log l. A wholly masked row gets the
//    mean of V and lse = -1e30.
//  - backward: p = exp(where(mask, s, -1e30) - lse) rebuilt on the same
//    products, dp = bf16(dO) bf16(V)^T, K8's own row term rt = rowsum(dp p)
//    (:164; not rowsum(dO O)), ds = p (dp - rt) scale; dV = bf16(p)^T dO,
//    dQ = bf16(ds) K, dK = bf16(ds)^T Q.
//
// What bounds it: at the ds3 training shape (q, k, v (64, 6, 450, 80) f32)
// the forward must read 166 MB and write 56 MB (0.066 ms at 3.35 TB/s)
// against 24.9 GFLOP on the bf16 tensor cores (0.025 ms): bytes, and the
// backward passes likewise. So every operand tile is read once per 128 rows,
// converted to bf16 once, and no score leaves the registers.
//
// The design reuses K6's wgmma pieces (attention_wgmma.cuh): 256 threads in
// two warpgroups of 64 rows, each thread holding two rows of an accumulator
// (l/4 and l/4 + 8 of its warp's 16); the streamed side in 64-row tiles
// through a cp.async ring of f32 stages (`Ring`), converted once per tile by
// all threads into the K-major bf16 operands wgmma reads (`convert_rows`:
// 16-column chunks, 32-byte swizzle; `convert_cols`: the transpose, 128-byte
// swizzle); the next tiles land while this one is used.
//  - vmem_fwd_wgmma_kernel: 128 query rows, Q in registers as the A operand.
//    Sweep 1 streams only K and takes each row's max from S = Q K^T in
//    registers; sweep 2 streams K and V, forms p against the final max (no
//    rescale of O), sums l and runs O += bf16(p) V with P straight from the
//    accumulator (its 16-column slices are the A fragments as they stand).
//  - vmem_bwd_dq_wgmma_kernel: 128 query rows, Q and dO in registers. Sweep
//    1 computes S and dP and sums rt; sweep 2 computes them again, forms ds
//    in registers and runs dQ += bf16(ds) K against K^T (`convert_cols`).
//    It writes dQ and rt.
//  - vmem_bwd_dkv_wgmma_kernel: 128 key rows, K and V converted once into
//    shared memory as the A operands of S^T = K Q^T and dP^T = V dO^T (the
//    registers hold dK and dV); Q and dO stream with their lse and rt, each
//    tile converted as rows (the B of S^T and dP^T) and as columns (the B
//    of dV += bf16(p^T) dO and dK += bf16(ds^T) Q). Each key row is written
//    by one CTA: no atomics.
// exp is the fast __expf (a few ulp; ~40 at exp(-30)), far below the bf16
// rounding p and ds take next. A key or query past n counts exactly 0.

#pragma once

#include "attention_wgmma.cuh"

namespace aw {

// one f32 stage of the ring: two tiles of 64 rows and the per-row
// statistics streamed with them (lse and rt of the dK/dV pass)
template <int DP>
__host__ __device__ constexpr int vstage_floats() {
  return stage_floats<DP>() + 2 * KT;
}
template <int DP>
__host__ __device__ constexpr int vstage_bytes() {
  return vstage_floats<DP>() * 4;
}

// shared memory: the bf16 operand tiles (kb_bytes each), then the ring
template <int DP>
__host__ __device__ constexpr size_t vmem_fwd_smem() {
  return (size_t)2 * kb_bytes<DP>() + (size_t)RING * vstage_bytes<DP>() + 1024;
}
template <int DP>
__host__ __device__ constexpr size_t vmem_dq_smem() {
  return (size_t)3 * kb_bytes<DP>() + (size_t)RING * vstage_bytes<DP>() + 1024;
}
// K and V of 128 rows, Q and dO as rows and as columns, the tile's lse and rt
template <int DP>
__host__ __device__ constexpr size_t vmem_dkv_smem(int ring) {
  return (size_t)8 * kb_bytes<DP>() + 2 * KT * 4 + (size_t)ring * vstage_bytes<DP>() + 1024;
}
// the dK/dV pass's ring: two stages where they fit (DP <= 96), else one
// (the next tile then lands while this one's products run)
constexpr int SMEM_MAX = 232448;
template <int DP>
__host__ __device__ constexpr int dkv_ring() {
  return vmem_dkv_smem<DP>(2) <= SMEM_MAX ? 2 : 1;
}
static_assert(vmem_dkv_smem<128>(1) <= SMEM_MAX && vmem_dq_smem<128>() <= SMEM_MAX,
              "the widest head dim must fit a CTA's shared memory");

// the streamed side: tiles of 64 rows of one or two slabs (PARTS), and for
// the dK/dV pass the rows' lse and rt, through RING f32 stages. Each call of
// load commits one cp.async group (empty past the last tile), so tile t is
// group t and RING - 1 newer groups may be in flight while it is used. T is
// the rows' element type (K1's bf16 arm streams bf16 rows: load_tile's bf16 overload).
template <int DP, int RING_, int PARTS, typename T = float>
struct Ring {
  float* stages;
  const T* rows0;
  const T* rows1;
  long long ld0, ld1;
  int n, d;
  bool vec;
  const float* stat0 = nullptr;  // lse and rt, (n) each with a row stride
  const float* stat1 = nullptr;
  long long sld0 = 0, sld1 = 0;

  __device__ int tiles() const { return (n + KT - 1) / KT; }
  __device__ float* stage(int t) const { return stages + (t % RING_) * vstage_floats<DP>(); }

  __device__ void load(int t) const {
    if (t < tiles()) {
      load_tile<DP, PARTS>(stage(t), rows0, rows1, ld0, ld1, t * KT, n, d, vec);
      if (stat0 != nullptr && threadIdx.x < 2 * KT) {
        const int which = threadIdx.x / KT, r = t * KT + threadIdx.x % KT;
        const bool in = r < n;
        const float* src = which ? stat1 + (in ? r * sld1 : 0) : stat0 + (in ? r * sld0 : 0);
        hop::cp_async4(stage(t) + 2 * KT * ld_f32<DP>() + threadIdx.x, src, in ? 4 : 0);
      }
    }
    hop::cp_async_commit();
  }
  // the first RING tiles
  __device__ void start() const {
#pragma unroll
    for (int i = 0; i < RING_; ++i) load(i);
  }
  // tile t's stage, once every thread's copies landed and every warpgroup is
  // done with the operands converted from tile t - 1
  __device__ const float* wait(int t) const {
    hop::cp_async_wait<RING_ - 1>();
    __syncthreads();
    return stage(t);
  }
  // after this thread converted tile t: the operands become visible to
  // wgmma, and tile t + RING goes into the freed stage
  __device__ void release(int t) const {
    hop::fence_proxy_async();
    __syncthreads();
    load(t + RING_);
  }
};

// The steps below are the ones K6's forward (flash_fwd_wgmma_kernel) writes
// inline; routed through these helpers, K6's kernel compiled to other code
// that ran 0.5-2% slower on the H100 (PERF.md section 6), so it keeps its own.

// rows of a head's slab (row stride ld) go in as 16-byte vectors: d % 4 == 0
// and every row start 16-byte aligned
__device__ __forceinline__ bool vec_rows(int d, long long ld0, long long ld1, const float* p0,
                                         const float* p1) {
  return d % 4 == 0 && ld0 % 4 == 0 && ld1 % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1)) & 15) == 0;
}
// bf16 rows: d % 8 == 0 and every row start 16-byte aligned
__device__ __forceinline__ bool vec_rows(int d, long long ld0, long long ld1,
                                         const __nv_bfloat16* p0, const __nv_bfloat16* p1) {
  return d % 8 == 0 && ld0 % 8 == 0 && ld1 % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1)) & 15) == 0;
}

// descriptors of k16 step c of the two operand layouts
__device__ __forceinline__ uint64_t rows_desc(uint32_t base, int c) {
  return hop::desc(base + c * KT * 32, 16, 256, hop::SW32);
}
__device__ __forceinline__ uint64_t cols_desc(uint32_t base, int c) {
  return hop::desc(base + c * 32, 16, 1024, hop::SW128);
}

// rows r_lo and r_lo + 8 of a slab as the register A operand: step c holds
// columns 16c .. 16c+15
template <int DP, typename T>
__device__ __forceinline__ void a_rows(uint32_t (&f)[DP / 16][4], const T* base, long long ld,
                                       int r_lo, int n, int d) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    f[c][0] = q_pair(base, ld, r_lo, 16 * c + c0, n, d);
    f[c][1] = q_pair(base, ld, r_lo + 8, 16 * c + c0, n, d);
    f[c][2] = q_pair(base, ld, r_lo, 16 * c + c0 + 8, n, d);
    f[c][3] = q_pair(base, ld, r_lo + 8, 16 * c + c0 + 8, n, d);
  }
}

// an m64n64 accumulator as the A operand of four k16 steps, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&f)[KT / 16][4], const float (&s)[KT / 2]) {
#pragma unroll
  for (int k = 0; k < KT / 16; ++k) {
    f[k][0] = hop::pack_bf16(s[8 * k], s[8 * k + 1]);
    f[k][1] = hop::pack_bf16(s[8 * k + 2], s[8 * k + 3]);
    f[k][2] = hop::pack_bf16(s[8 * k + 4], s[8 * k + 5]);
    f[k][3] = hop::pack_bf16(s[8 * k + 6], s[8 * k + 7]);
  }
}

// rows r_lo and r_lo + 8 of an m64nDP accumulator, divided by div_lo /
// div_hi, into a slab (row stride ld): columns below d, rows below n
template <int DP>
__device__ __forceinline__ void store_acc(float* ob, long long ld, const float (&o)[DP / 2],
                                          int r_lo, int n, int d, float div_lo, float div_hi) {
  const int lane = threadIdx.x % 32;
  const bool pairs = d % 2 == 0 && ld % 2 == 0 && (reinterpret_cast<uintptr_t>(ob) & 7) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    if (row >= n) continue;
    const float div = hh ? div_hi : div_lo;
    float* orow = ob + (long long)row * ld;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float v0 = o[4 * j + 2 * hh] / div, v1 = o[4 * j + 2 * hh + 1] / div;
      if (pairs && c < d) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
      } else {
        if (c < d) orow[c] = v0;
        if (c + 1 < d) orow[c + 1] = v1;
      }
    }
  }
}

// the same rows stored in bf16, rounded to nearest
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* ob, long long ld,
                                          const float (&o)[DP / 2], int r_lo, int n, int d,
                                          float div_lo, float div_hi) {
  const int lane = threadIdx.x % 32;
  const bool pairs = d % 2 == 0 && ld % 2 == 0 && (reinterpret_cast<uintptr_t>(ob) & 3) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    if (row >= n) continue;
    const float div = hh ? div_hi : div_lo;
    __nv_bfloat16* orow = ob + (long long)row * ld;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float v0 = o[4 * j + 2 * hh] / div, v1 = o[4 * j + 2 * hh + 1] / div;
      if (pairs && c < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < d) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// a product of row `row` and key `key` as the softmax takes it: scaled, or
// -1e30 where the mask closes the pair
template <bool HAS_MASK>
struct Score {
  int n;
  const unsigned char* mask;
  float scale;
  __device__ float operator()(float s, int row, int key) const {
    return attends<HAS_MASK>(row, key, n, mask) ? s * scale : MASKED;
  }
};

// s = A B^T over DP (A in registers; B 64 rows as 16-column chunks), issued
// into the open wgmma group
template <int DP>
__device__ __forceinline__ void mma_rows(float (&s)[KT / 2], const uint32_t (&f)[DP / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) hop::Mma<KT, 0>::rs(s, f[c], rows_desc(b, c), c);
}

// acc += P B over the 64 rows of a tile (P an accumulator packed to bf16; B
// the tile as columns), issued into the open wgmma group
template <int DP>
__device__ __forceinline__ void mma_cols(float (&acc)[DP / 2], const uint32_t (&p)[KT / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int k = 0; k < KT / 16; ++k) hop::Mma<DP, 0>::rs(acc, p[k], cols_desc(b, k), 1);
}

template <int R>
__device__ __forceinline__ void zero(float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = 0.f;
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) vmem_fwd_wgmma_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kc16 = smem;
  unsigned char* vt16 = smem + kb_bytes<DP>();
  float* stages = reinterpret_cast<float*>(smem + 2 * kb_bytes<DP>());
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, n = a.n, d = a.d;
  const int r_lo = blockIdx.x * ROWS + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const float* kb = amma::base(a.k, b, h);
  const float* vb = amma::base(a.v, b, h);
  const bool vec = vec_rows(d, a.k.sn, a.v.sn, kb, vb);
  const Ring<DP, RING, 1> keys{stages, kb, vb, a.k.sn, a.v.sn, n, d, vec};
  keys.start();
  uint32_t qf[DP / 16][4];
  a_rows<DP>(qf, amma::base(a.q, b, h), a.q.sn, r_lo, n, d);
  const uint32_t kc = hop::smem_u32(kc16), vt = hop::smem_u32(vt16);
  const int kq = 2 * (lane % 4);
  const Score<HAS_MASK> score{n, a.mask, a.scale};

  // sweep 1: each row's max over all its keys' scores
  float m_lo = MASKED, m_hi = MASKED;
  for (int t = 0; t < keys.tiles(); ++t) {
    convert_rows<DP>(kc16, keys.wait(t));
    keys.release(t);
    float s[KT / 2];
    hop::fence_regs(s);
    hop::wgmma_fence();
    mma_rows<DP>(s, qf, kc);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * KT + kq + 8 * j + e;
        if (key < n) {
          m_lo = fmaxf(m_lo, score(s[4 * j + e], r_lo, key));
          m_hi = fmaxf(m_hi, score(s[4 * j + 2 + e], r_hi, key));
        }
      }
    }
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);

  // sweep 2: p = exp(s - m) against the final max, l = sum p, O += bf16(p) V
  const Ring<DP, RING, 2> kv{stages, kb, vb, a.k.sn, a.v.sn, n, d, vec};
  kv.start();
  float o[DP / 2];
  zero(o);
  float l_lo = 0.f, l_hi = 0.f;
  for (int t = 0; t < kv.tiles(); ++t) {
    const float* st = kv.wait(t);
    convert_rows<DP>(kc16, st);
    convert_cols<DP>(vt16, st + KT * ld_f32<DP>());
    kv.release(t);
    float s[KT / 2];
    hop::fence_regs(s);
    hop::wgmma_fence();
    mma_rows<DP>(s, qf, kc);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * KT + kq + 8 * j + e;
        const bool real = key < n;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = real ? __expf(score(lo, r_lo, key) - m_lo) : 0.f;
        hi = real ? __expf(score(hi, r_hi, key) - m_hi) : 0.f;
        l_lo += lo;
        l_hi += hi;
      }
    }
    uint32_t pf[KT / 16][4];
    pack_a(pf, s);
    hop::fence_regs(o);
    hop::wgmma_fence();
    mma_cols<DP>(o, pf, vt);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
  }
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);

  float* lb = amma::base(a.lse_out, b, h);
  const float div_lo = l_lo == 0.f ? 1.f : l_lo, div_hi = l_hi == 0.f ? 1.f : l_hi;
  store_acc<DP>(amma::base(a.o, b, h), a.o.sn, o, r_lo, n, d, div_lo, div_hi);
  if (lane % 4 == 0) {
    if (r_lo < n) lb[(long long)r_lo * a.lse_out.sn] = m_lo + logf(div_lo);
    if (r_hi < n) lb[(long long)r_hi * a.lse_out.sn] = m_hi + logf(div_hi);
  }
}

// S = Q K^T and dP = dO V^T of one key tile into registers
template <int DP>
__device__ __forceinline__ void s_dp(float (&s)[KT / 2], float (&dp)[KT / 2],
                                     const uint32_t (&qf)[DP / 16][4],
                                     const uint32_t (&gf)[DP / 16][4], uint32_t kc, uint32_t vc) {
  hop::fence_regs(s);
  hop::fence_regs(dp);
  hop::wgmma_fence();
  mma_rows<DP>(s, qf, kc);
  mma_rows<DP>(dp, gf, vc);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  hop::fence_regs(dp);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) vmem_bwd_dq_wgmma_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kc16 = smem;
  unsigned char* vc16 = smem + kb_bytes<DP>();
  unsigned char* kt16 = smem + 2 * kb_bytes<DP>();
  float* stages = reinterpret_cast<float*>(smem + 3 * kb_bytes<DP>());
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, n = a.n, d = a.d;
  const int r_lo = blockIdx.x * ROWS + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const float* kb = amma::base(a.k, b, h);
  const float* vb = amma::base(a.v, b, h);
  const Ring<DP, RING, 2> kv{stages, kb, vb, a.k.sn, a.v.sn, n, d,
                             vec_rows(d, a.k.sn, a.v.sn, kb, vb)};
  kv.start();
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  a_rows<DP>(qf, amma::base(a.q, b, h), a.q.sn, r_lo, n, d);
  a_rows<DP>(gf, amma::base(a.g, b, h), a.g.sn, r_lo, n, d);
  const float* lb = amma::base(a.lse, b, h);
  const float lse_lo = r_lo < n ? lb[(long long)r_lo * a.lse.sn] : 0.f;
  const float lse_hi = r_hi < n ? lb[(long long)r_hi * a.lse.sn] : 0.f;
  const uint32_t kc = hop::smem_u32(kc16), vc = hop::smem_u32(vc16), kt = hop::smem_u32(kt16);
  const int kq = 2 * (lane % 4);
  const Score<HAS_MASK> score{n, a.mask, a.scale};

  // sweep 1: the row term rt = rowsum(dp * p) over every key
  float rt_lo = 0.f, rt_hi = 0.f;
  for (int t = 0; t < kv.tiles(); ++t) {
    const float* st = kv.wait(t);
    convert_rows<DP>(kc16, st);
    convert_rows<DP>(vc16, st + KT * ld_f32<DP>());
    kv.release(t);
    float s[KT / 2], dp[KT / 2];
    s_dp<DP>(s, dp, qf, gf, kc, vc);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * KT + kq + 8 * j + e;
        if (key < n) {
          rt_lo += __expf(score(s[4 * j + e], r_lo, key) - lse_lo) * dp[4 * j + e];
          rt_hi += __expf(score(s[4 * j + 2 + e], r_hi, key) - lse_hi) *
                   dp[4 * j + 2 + e];
        }
      }
    }
  }
  rt_lo = quad_sum(rt_lo);
  rt_hi = quad_sum(rt_hi);

  // sweep 2: ds = p (dp - rt) scale, dQ += bf16(ds) K
  kv.start();
  float dq[DP / 2];
  zero(dq);
  for (int t = 0; t < kv.tiles(); ++t) {
    const float* st = kv.wait(t);
    convert_rows<DP>(kc16, st);
    convert_rows<DP>(vc16, st + KT * ld_f32<DP>());
    convert_cols<DP>(kt16, st);
    kv.release(t);
    float s[KT / 2], dp[KT / 2];
    s_dp<DP>(s, dp, qf, gf, kc, vc);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * KT + kq + 8 * j + e;
        const bool real = key < n;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        const float p_lo = real ? __expf(score(lo, r_lo, key) - lse_lo) : 0.f;
        const float p_hi = real ? __expf(score(hi, r_hi, key) - lse_hi) : 0.f;
        lo = p_lo * (dp[4 * j + e] - rt_lo) * a.scale;
        hi = p_hi * (dp[4 * j + 2 + e] - rt_hi) * a.scale;
      }
    }
    uint32_t df[KT / 16][4];
    pack_a(df, s);
    hop::fence_regs(dq);
    hop::wgmma_fence();
    mma_cols<DP>(dq, df, kt);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dq);
  }

  store_acc<DP>(amma::base(a.dq, b, h), a.dq.sn, dq, r_lo, n, d, 1.f, 1.f);
  if (lane % 4 == 0) {
    float* rb = amma::base(a.rt_out, b, h);
    if (r_lo < n) rb[(long long)r_lo * a.rt_out.sn] = rt_lo;
    if (r_hi < n) rb[(long long)r_hi * a.rt_out.sn] = rt_hi;
  }
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) vmem_bwd_dkv_wgmma_kernel(Args a) {
  constexpr int TB = kb_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kc16 = smem;           // two warpgroups' 64 key rows each
  unsigned char* vc16 = smem + 2 * TB;
  unsigned char* qc16 = smem + 4 * TB;  // the query tile as rows and as columns
  unsigned char* gc16 = smem + 5 * TB;
  unsigned char* qt16 = smem + 6 * TB;
  unsigned char* gt16 = smem + 7 * TB;
  float* stats = reinterpret_cast<float*>(smem + 8 * TB);  // the tile's lse, then rt
  float* stages = stats + 2 * KT;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, n = a.n, d = a.d;
  const int k0 = blockIdx.x * ROWS;
  const int r_lo = k0 + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;

  // this CTA's K and V rows into their bf16 operands, 64 at a time
  {
    const float* kb = amma::base(a.k, b, h);
    const float* vb = amma::base(a.v, b, h);
    const bool vec = vec_rows(d, a.k.sn, a.v.sn, kb, vb);
    for (int half = 0; half < ROWS / KT; ++half) {
      load_tile<DP>(stages, kb, vb, a.k.sn, a.v.sn, k0 + half * KT, n, d, vec);
      hop::cp_async_commit();
      hop::cp_async_wait<0>();
      __syncthreads();
      convert_rows<DP>(kc16 + half * TB, stages);
      convert_rows<DP>(vc16 + half * TB, stages + KT * ld_f32<DP>());
      __syncthreads();  // the stage is read before it is filled again
    }
  }
  const float* qb = amma::base(a.q, b, h);
  const float* gb = amma::base(a.g, b, h);
  Ring<DP, dkv_ring<DP>(), 2> qg{stages, qb, gb, a.q.sn, a.g.sn, n, d,
                                 vec_rows(d, a.q.sn, a.g.sn, qb, gb)};
  qg.stat0 = amma::base(a.lse, b, h);
  qg.stat1 = amma::base(a.rt, b, h);
  qg.sld0 = a.lse.sn;
  qg.sld1 = a.rt.sn;
  qg.start();

  const uint32_t kc = hop::smem_u32(kc16 + wg * TB), vc = hop::smem_u32(vc16 + wg * TB);
  const uint32_t qc = hop::smem_u32(qc16), gc = hop::smem_u32(gc16);
  const uint32_t qt = hop::smem_u32(qt16), gt = hop::smem_u32(gt16);
  const int kq = 2 * (lane % 4);
  const Score<HAS_MASK> score{n, a.mask, a.scale};
  float dk[DP / 2], dv[DP / 2];
  zero(dk);
  zero(dv);
  for (int t = 0; t < qg.tiles(); ++t) {
    const float* st = qg.wait(t);
    convert_rows<DP>(qc16, st);
    convert_rows<DP>(gc16, st + KT * ld_f32<DP>());
    convert_cols<DP>(qt16, st);
    convert_cols<DP>(gt16, st + KT * ld_f32<DP>());
    if (threadIdx.x < 2 * KT) stats[threadIdx.x] = st[2 * KT * ld_f32<DP>() + threadIdx.x];
    qg.release(t);

    // S^T = K Q^T and dP^T = V dO^T: keys in rows, the tile's queries in columns
    float s[KT / 2], dp[KT / 2];
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      hop::Mma<KT, 0>::ss(s, rows_desc(kc, c), rows_desc(qc, c), c);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      hop::Mma<KT, 0>::ss(dp, rows_desc(vc, c), rows_desc(gc, c), c);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);

    // p^T into s, ds^T into dp
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kq + 8 * j + e, query = t * KT + col;
        const float lse = stats[col], rt = stats[KT + col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = hh ? r_hi : r_lo, i = 4 * j + 2 * hh + e;
          const float p = query < n && key < n
                              ? __expf(score(s[i], query, key) - lse) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - rt) * a.scale;
        }
      }
    }
    uint32_t pf[KT / 16][4], df[KT / 16][4];
    pack_a(pf, s);
    pack_a(df, dp);
    hop::fence_regs(dv);
    hop::fence_regs(dk);
    hop::wgmma_fence();
    mma_cols<DP>(dv, pf, gt);
    mma_cols<DP>(dk, df, qt);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dv);
    hop::fence_regs(dk);
  }

  store_acc<DP>(amma::base(a.dk, b, h), a.dk.sn, dk, r_lo, n, d, 1.f, 1.f);
  store_acc<DP>(amma::base(a.dv, b, h), a.dv.sn, dv, r_lo, n, d, 1.f, 1.f);
}

// launch over (row blocks of 128, heads, batch) with the kernel's dynamic
// shared memory
template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, size_t smem, const Args& a, int B, int H,
                        cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.n + ROWS - 1) / ROWS, H, B), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_vmem_fwd(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr
             ? launch_rows(vmem_fwd_wgmma_kernel<DP, true>, vmem_fwd_smem<DP>(), a, B, H, st)
             : launch_rows(vmem_fwd_wgmma_kernel<DP, false>, vmem_fwd_smem<DP>(), a, B, H, st);
}

template <int DP>
cudaError_t launch_vmem_dq(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr
             ? launch_rows(vmem_bwd_dq_wgmma_kernel<DP, true>, vmem_dq_smem<DP>(), a, B, H, st)
             : launch_rows(vmem_bwd_dq_wgmma_kernel<DP, false>, vmem_dq_smem<DP>(), a, B, H, st);
}

template <int DP>
cudaError_t launch_vmem_dkv(const Args& a, int B, int H, cudaStream_t st) {
  constexpr size_t smem = vmem_dkv_smem<DP>(dkv_ring<DP>());
  return a.mask != nullptr
             ? launch_rows(vmem_bwd_dkv_wgmma_kernel<DP, true>, smem, a, B, H, st)
             : launch_rows(vmem_bwd_dkv_wgmma_kernel<DP, false>, smem, a, B, H, st);
}

}  // namespace aw
