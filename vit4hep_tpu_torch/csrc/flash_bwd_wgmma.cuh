// K6's backward on wgmma, for Hopper (sm_90a): the dQ and the dK/dV passes
// of `flash_qkv_attention` straight off the native (B, N, 3*H*D) f32 qkv
// panel, writing the merged (B, N, 3*H*D) cotangent in place. Their bodies
// also run K1's bf16 arm (qkv_attention_bf16.cu) on a bf16 panel, with K1's
// dead-row rule (k6_p, k1_delta).
//
// Replaces the TPU kernels `_bwd_dq_kernel`
// (vit4hep_tpu/ops/flash_qkv_attention.py:119, pallas_call :360) and
// `_bwd_dkv_kernel` (:164, pallas_call :389). Their function: bf16
// multiplicands with f32 accumulation (:225); delta = rowsum(dO * O) is an
// input (K1's delta kernel, (B, H, N)); lse is the forward's (B, N, H);
//   p  = exp(s * scale - lse) where the key is real and the mask lets the
//        pair attend, else exactly 0 (`where(valid, exp(s - lse), 0)`,
//        :148 and :195: a wholly masked row weighs every key 0);
//   ds = p (dp - delta) scale, with dp = bf16(dO) bf16(V)^T;
//   dQ = bf16(ds) K, dK = bf16(ds)^T Q, dV = bf16(p)^T dO.
// The dead-row rule is K6's own: K8 and K1 rebuild p = 1 on such a row from
// its lse of -1e30. So these kernels take K8's wgmma pieces
// (vmem_wgmma.cuh: the cp.async `Ring`, the operand conversions, the
// register A fragments) but form p themselves (`k6_p`); K8's kernels stay as
// they are.
//
// What bounds them: at the ds3 training shape (qkv (64, 450, 1440) f32) the
// dQ pass must read the 166 MB panel, the 55 MB upstream gradient and the
// statistics and write 55 MB of dQ (0.083 ms at 3.35 TB/s) against 37 GFLOP
// on the bf16 tensor cores (0.038 ms); dK/dV writes 111 MB (0.099 ms) for 50
// GFLOP: bytes. So, as in K8's backward, a streamed tile is read once per 128
// rows and converted to bf16 once, and no score leaves the registers:
//  - flash_bwd_dq_wgmma_kernel: 128 query rows a CTA in two warpgroups, Q and
//    dO in registers as the A operands, the row's lse and delta read once.
//    One sweep over the keys (delta is an input, unlike K8's row term): per
//    64-key tile S = Q K^T and dP = dO V^T on wgmma, ds formed in registers,
//    dQ += bf16(ds) K against K^T (`convert_cols`).
//  - flash_bwd_dkv_wgmma_kernel: 128 key rows, K and V converted once into
//    shared memory as the A operands of S^T = K Q^T and dP^T = V dO^T; Q and
//    dO stream with their lse (row stride H) and delta (row stride 1); dV +=
//    bf16(p^T) dO and dK += bf16(ds^T) Q. Each key row is written by one CTA:
//    no atomics.
// exp is the fast __expf (a few ulp; ~40 at exp(-30)), far below the bf16
// rounding p and ds take next. A key or query past n counts exactly 0.

#pragma once

#include "vmem_wgmma.cuh"

namespace aw {

// p of (query, key) from the product s: 0 for a key or query past n, exp(s
// * scale - lse) where the pair attends, exp(-inf) = 0 where the mask closes
// it (whatever the row's lse, so a wholly masked row weighs every key 0).
// Written as a select of the exponent: with the mask selecting between the
// exponential and 0 instead, ptxas reused the registers of dO's A fragments
// as scratch inside the key loop of the masked dQ pass at DP = 64, and dQ
// came out wrong (its SASS, read on the H100: PERF.md section 6).
// With K1 the rule is K1's (qkv_bwd_tf32.cuh): a closed pair's exponent is
// -1e30, so a wholly masked row (lse -1e30) weighs each key 1, and its
// delta is scaled by n where the passes read it (k1_delta).
template <bool HAS_MASK, bool K1 = false>
__device__ __forceinline__ float k6_p(float s, int query, int key, int n,
                                      const unsigned char* mask, float scale, float lse) {
  if (query >= n || key >= n) return 0.f;
  return __expf((attends<HAS_MASK>(query, key, n, mask) ? s * scale : (K1 ? MASKED : -INFINITY)) -
                lse);
}

// a row's delta as the passes use it: with K1's rule, times n on a wholly
// masked row (JAX's rowsum(dP * P) over its n keys of weight 1)
template <bool HAS_MASK, bool K1>
__device__ __forceinline__ float k1_delta(float dl, float lse, int n) {
  return K1 && HAS_MASK && lse == MASKED ? dl * (float)n : dl;
}

// the dQ pass's body on global tensors of element type T (lse and delta in
// f32), with K6's dead-row rule or K1's
template <int DP, bool HAS_MASK, typename T, bool K1>
__device__ __forceinline__ void flash_bwd_dq_body(Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kc16 = smem;
  unsigned char* vc16 = smem + kb_bytes<DP>();
  unsigned char* kt16 = smem + 2 * kb_bytes<DP>();
  float* stages = reinterpret_cast<float*>(smem + 3 * kb_bytes<DP>());
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, n = a.n, d = a.d;
  const int r_lo = blockIdx.x * ROWS + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const T* kb = tbase<T>(a.k, b, h);
  const T* vb = tbase<T>(a.v, b, h);
  const Ring<DP, RING, 2, T> kv{stages, kb, vb, a.k.sn, a.v.sn, n, d,
                                vec_rows(d, a.k.sn, a.v.sn, kb, vb)};
  kv.start();
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  a_rows<DP>(qf, tbase<T>(a.q, b, h), a.q.sn, r_lo, n, d);
  a_rows<DP>(gf, tbase<T>(a.g, b, h), a.g.sn, r_lo, n, d);
  const float* lb = amma::base(a.lse, b, h);
  const float* rb = amma::base(a.rt, b, h);
  const float lse_lo = r_lo < n ? lb[(long long)r_lo * a.lse.sn] : 0.f;
  const float lse_hi = r_hi < n ? lb[(long long)r_hi * a.lse.sn] : 0.f;
  const float dl_lo =
      r_lo < n ? k1_delta<HAS_MASK, K1>(rb[(long long)r_lo * a.rt.sn], lse_lo, n) : 0.f;
  const float dl_hi =
      r_hi < n ? k1_delta<HAS_MASK, K1>(rb[(long long)r_hi * a.rt.sn], lse_hi, n) : 0.f;
  const uint32_t kc = hop::smem_u32(kc16), vc = hop::smem_u32(vc16), kt = hop::smem_u32(kt16);
  const int kq = 2 * (lane % 4);

  float dq[DP / 2];
  zero(dq);
  for (int t = 0; t < kv.tiles(); ++t) {
    const float* st = kv.wait(t);
    convert_rows<DP, T>(kc16, st);
    convert_rows<DP, T>(vc16, st + KT * ld_f32<DP>());
    convert_cols<DP, T>(kt16, st);
    kv.release(t);
    float s[KT / 2], dp[KT / 2];
    s_dp<DP>(s, dp, qf, gf, kc, vc);
    // ds = p (dp - delta) scale into s
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * KT + kq + 8 * j + e;
        float& lo = s[4 * j + e];
        float& hi = s[4 * j + 2 + e];
        lo = k6_p<HAS_MASK, K1>(lo, r_lo, key, n, a.mask, a.scale, lse_lo) *
             (dp[4 * j + e] - dl_lo) * a.scale;
        hi = k6_p<HAS_MASK, K1>(hi, r_hi, key, n, a.mask, a.scale, lse_hi) *
             (dp[4 * j + 2 + e] - dl_hi) * a.scale;
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

  store_acc<DP>(tbase<T>(a.dq, b, h), a.dq.sn, dq, r_lo, n, d, 1.f, 1.f);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_wgmma_kernel(Args a) {
  flash_bwd_dq_body<DP, HAS_MASK, float, false>(a);
}

// the dK/dV pass's body on global tensors of element type T (lse and delta
// in f32), with K6's dead-row rule or K1's
template <int DP, bool HAS_MASK, typename T, bool K1>
__device__ __forceinline__ void flash_bwd_dkv_body(Args a) {
  constexpr int TB = kb_bytes<DP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* kc16 = smem;           // two warpgroups' 64 key rows each
  unsigned char* vc16 = smem + 2 * TB;
  unsigned char* qc16 = smem + 4 * TB;  // the query tile as rows and as columns
  unsigned char* gc16 = smem + 5 * TB;
  unsigned char* qt16 = smem + 6 * TB;
  unsigned char* gt16 = smem + 7 * TB;
  float* stats = reinterpret_cast<float*>(smem + 8 * TB);  // the tile's lse, then delta
  float* stages = stats + 2 * KT;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, n = a.n, d = a.d;
  const int k0 = blockIdx.x * ROWS;
  const int r_lo = k0 + wg * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;

  // this CTA's K and V rows into their bf16 operands, 64 at a time
  {
    const T* kb = tbase<T>(a.k, b, h);
    const T* vb = tbase<T>(a.v, b, h);
    const bool vec = vec_rows(d, a.k.sn, a.v.sn, kb, vb);
    for (int half = 0; half < ROWS / KT; ++half) {
      load_tile<DP>(stages, kb, vb, a.k.sn, a.v.sn, k0 + half * KT, n, d, vec);
      hop::cp_async_commit();
      hop::cp_async_wait<0>();
      __syncthreads();
      convert_rows<DP, T>(kc16 + half * TB, stages);
      convert_rows<DP, T>(vc16 + half * TB, stages + KT * ld_f32<DP>());
      __syncthreads();  // the stage is read before it is filled again
    }
  }
  const T* qb = tbase<T>(a.q, b, h);
  const T* gb = tbase<T>(a.g, b, h);
  Ring<DP, dkv_ring<DP>(), 2, T> qg{stages, qb, gb, a.q.sn, a.g.sn, n, d,
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
  float dk[DP / 2], dv[DP / 2];
  zero(dk);
  zero(dv);
  for (int t = 0; t < qg.tiles(); ++t) {
    const float* st = qg.wait(t);
    convert_rows<DP, T>(qc16, st);
    convert_rows<DP, T>(gc16, st + KT * ld_f32<DP>());
    convert_cols<DP, T>(qt16, st);
    convert_cols<DP, T>(gt16, st + KT * ld_f32<DP>());
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
        const float lse = stats[col], dl = k1_delta<HAS_MASK, K1>(stats[KT + col], lse, n);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float p =
              k6_p<HAS_MASK, K1>(s[i], query, hh ? r_hi : r_lo, n, a.mask, a.scale, lse);
          s[i] = p;
          dp[i] = p * (dp[i] - dl) * a.scale;
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

  store_acc<DP>(tbase<T>(a.dk, b, h), a.dk.sn, dk, r_lo, n, d, 1.f, 1.f);
  store_acc<DP>(tbase<T>(a.dv, b, h), a.dv.sn, dv, r_lo, n, d, 1.f, 1.f);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_wgmma_kernel(Args a) {
  flash_bwd_dkv_body<DP, HAS_MASK, float, false>(a);
}

template <int DP>
cudaError_t launch_flash_dq(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr
             ? launch_rows(flash_bwd_dq_wgmma_kernel<DP, true>, vmem_dq_smem<DP>(), a, B, H, st)
             : launch_rows(flash_bwd_dq_wgmma_kernel<DP, false>, vmem_dq_smem<DP>(), a, B, H,
                           st);
}

template <int DP>
cudaError_t launch_flash_dkv(const Args& a, int B, int H, cudaStream_t st) {
  constexpr size_t smem = vmem_dkv_smem<DP>(dkv_ring<DP>());
  return a.mask != nullptr
             ? launch_rows(flash_bwd_dkv_wgmma_kernel<DP, true>, smem, a, B, H, st)
             : launch_rows(flash_bwd_dkv_wgmma_kernel<DP, false>, smem, a, B, H, st);
}

}  // namespace aw
