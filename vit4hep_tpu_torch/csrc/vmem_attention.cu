// One-shot exact-softmax attention on separated (B, H, N, D) tensors,
// forward and backward, for Hopper (sm_90a), with an optional shared (N, N)
// mask.
//
// Replaces the Pallas TPU kernels of `vmem_attention`
// (vit4hep_tpu/ops/vmem_attention.py:82): the forward `_oneshot_kernel` (:47,
// pallas_call :111) and the backward `_bwd_kernel` (:140, pallas_call :193).
// The TPU kernel gives each (batch, head) grid cell its whole K/V panel and
// its whole (N, N) f32 score block in VMEM (810 KB at N = 450, 4 MB at N =
// 1024), and takes the softmax in one max/exp/sum over it. A CTA here has at
// most 227 KB of shared memory, so the work is split by query rows and the
// scores are never resident: each CTA owns 64 query rows of one (batch,
// head) (16 per warp) and streams K/V in 64-row tiles twice, once for each
// row's exact max over every key and once for p = exp(s - max), l = sum p and
// O = p . V. The softmax is the TPU kernel's exact, non-online one: p is
// rounded to bf16 for the product against the row's final max, never
// rescaled.
//
// The backward rebuilds s with the same bf16 products as the forward, so p =
// exp(s - lse) is the forward's own softmax (the JAX docstring, :22-26), and
// takes K8's own row term rowsum(dp * p) (:164), not rowsum(dO * O):
//  - bwd_dq_kernel<DP, HAS_MASK, true> (attention_mma.cuh): per 64 query
//    rows, one sweep over the keys sums the row term, a second forms ds and
//    dQ = ds . K; it writes dQ and the row term;
//  - bwd_dkv_kernel<DP, HAS_MASK, true>: per 64 key rows, a sweep over the
//    queries forms p and ds from the saved lse and row term, dV = p^T . dO,
//    dK = ds^T . Q. dK and dV sum over every query, and each key row is
//    written by one CTA: no atomics.
// A masked score is the finite -1e30 of `jnp.where(mask, s, -1e30)`: a row
// whose every key is masked gets the mean of V and lse = -1e30 + log N (which
// is -1e30 in f32), so its backward rebuilds p = 1 for every key, as JAX's.
//
// What bounds it on this card: at the ds3 training shape (q, k, v (64, 6,
// 450, 80) f32) the forward reads 166 MB and writes 56 MB, 0.066 ms at 3.35
// TB/s, against 24.9 GFLOP of products, 0.025 ms on the bf16 tensor cores:
// it is bound by bytes. The design keeps the scores on chip (the TPU kernel's
// point) and reads each K/V tile from L2 once per 64 query rows; it pays a
// second QK^T sweep for the exact max and converts f32 to bf16 on load.
// wgmma, TMA and cp.async pipelining are the levers for a later change.

#include "attention_mma.cuh"

using namespace amma;

namespace {

template <int DP>
constexpr size_t fwd_smem() {
  return (size_t)3 * ROWS * (DP + 8) * 2 + (size_t)ROWS * LDS * 4 + (size_t)ROWS * LDP * 2;
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) vmem_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DP + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + ROWS * LD;
  __nv_bfloat16* Vs = Ks + KT * LD;
  float* S = reinterpret_cast<float*>(Vs + KT * LD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(S + ROWS * LDS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS, r0 = q0 + warp * WR;
  const int n = a.n, d = a.d;
  float* Sw = S + warp * WR * LDS;
  __nv_bfloat16* Pw = Ps + warp * WR * LDP;
  const __nv_bfloat16* Qw = Qs + warp * WR * LD;
  const float* kb = base(a.k, b, h);
  const float* vb = base(a.v, b, h);

  load_rows<DP>(Qs, base(a.q, b, h), a.q.sn, q0, ROWS, n, d);
  // sweep 1: each row's max over all its scores (a masked one counts -1e30)
  float m[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) m[r] = -INFINITY;
  for (int k0 = 0; k0 < n; k0 += KT) {
    __syncthreads();
    load_rows<DP>(Ks, kb, a.k.sn, k0, KT, n, d);
    __syncthreads();
    warp_abt<DP>(Sw, Qw, Ks);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      float t = -INFINITY;
#pragma unroll
      for (int c = lane; c < KT; c += 32) {
        const int key = k0 + c;
        if (key < n)
          t = fmaxf(t, attends<HAS_MASK>(r0 + r, key, n, a.mask) ? Sw[r * LDS + c] * a.scale
                                                                 : MASKED);
      }
      m[r] = fmaxf(m[r], warp_max(t));
    }
  }

  // sweep 2: p = exp(s - m) against the final max, l = sum p, O = p . V
  float l[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) l[r] = 0.f;
  Acc o[DP / 16];
  zero<DP>(o);
  for (int k0 = 0; k0 < n; k0 += KT) {
    __syncthreads();
    load_rows<DP>(Ks, kb, a.k.sn, k0, KT, n, d);
    load_rows<DP>(Vs, vb, a.v.sn, k0, KT, n, d);
    __syncthreads();
    warp_abt<DP>(Sw, Qw, Ks);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      float ls = 0.f;
#pragma unroll
      for (int c = lane; c < KT; c += 32) {
        const int key = k0 + c;
        float p = 0.f;
        if (key < n)
          p = expf((attends<HAS_MASK>(r0 + r, key, n, a.mask) ? Sw[r * LDS + c] * a.scale
                                                              : MASKED) - m[r]);
        ls += p;
        Pw[r * LDP + c] = __float2bfloat16(p);
      }
      l[r] += warp_sum(ls);
    }
    __syncwarp();
    warp_pv<DP>(o, Pw, Vs);
  }

  __syncthreads();  // every warp is done with K/V: its output staging reuses them
  float* Ow = reinterpret_cast<float*>(Ks) + warp * WR * (DP + 4);
#pragma unroll
  for (int r = 0; r < WR; ++r) l[r] = l[r] == 0.f ? 1.f : l[r];
  warp_write<DP>(Ow, o, base(a.o, b, h), a.o.sn, r0, n, d, l);
  if (lane == 0) {
    float* lo = base(a.lse_out, b, h);
#pragma unroll
    for (int r = 0; r < WR; ++r)
      if (r0 + r < n) lo[(long long)(r0 + r) * a.lse_out.sn] = m[r] + logf(l[r]);
  }
}

template <int DP>
cudaError_t launch_fwd(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr ? launch(vmem_fwd_kernel<DP, true>, fwd_smem<DP>(), a, B, H, st)
                           : launch(vmem_fwd_kernel<DP, false>, fwd_smem<DP>(), a, B, H, st);
}

// q, k, v: (B, H, n, d) with strides (sb, sh, sn, 1), shared by the three;
// g: its own strides; outputs contiguous (B, H, n, d), lse and the row term
// contiguous (B, H, n)
Args make_args(const float* q, const float* k, const float* v, long long sb, long long sh,
               long long sn, const unsigned char* mask, int n, int d, float scale) {
  Args a{};
  a.q = {q, sb, sh, sn};
  a.k = {k, sb, sh, sn};
  a.v = {v, sb, sh, sn};
  a.mask = mask;
  a.n = n;
  a.d = d;
  a.scale = scale;
  return a;
}

OutSlab out_bhnd(float* p, int H, int n, int d) {
  return {p, (long long)H * n * d, (long long)n * d, d};
}
Slab stat_bhn(const float* p, int H, int n) { return {p, (long long)H * n, n, 1}; }
OutSlab stat_out_bhn(float* p, int H, int n) { return {p, (long long)H * n, n, 1}; }

}  // namespace

extern "C" int vmem_attention_fwd(const float* q, const float* k, const float* v, long long sb,
                                  long long sh, long long sn, const unsigned char* mask,
                                  float* out, float* lse, int B, int H, int n, int d, float scale,
                                  void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, sb, sh, sn, mask, n, d, scale);
  a.o = out_bhnd(out, H, n, d);
  a.lse_out = stat_out_bhn(lse, H, n);
  AMMA_DISPATCH(d, launch_fwd<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}

extern "C" int vmem_attention_bwd_dq(const float* q, const float* k, const float* v, long long sb,
                                     long long sh, long long sn, const float* g, long long gsb,
                                     long long gsh, long long gsn, const float* lse,
                                     const unsigned char* mask, float* dq, float* rowterm, int B,
                                     int H, int n, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, sb, sh, sn, mask, n, d, scale);
  a.g = {g, gsb, gsh, gsn};
  a.lse = stat_bhn(lse, H, n);
  a.dq = out_bhnd(dq, H, n, d);
  a.rt_out = stat_out_bhn(rowterm, H, n);
  AMMA_DISPATCH(d, (launch_dq<DP, true>(a, B, H, static_cast<cudaStream_t>(stream))))
}

extern "C" int vmem_attention_bwd_dkv(const float* q, const float* k, const float* v, long long sb,
                                      long long sh, long long sn, const float* g, long long gsb,
                                      long long gsh, long long gsn, const float* lse,
                                      const float* rowterm, const unsigned char* mask, float* dk,
                                      float* dv, int B, int H, int n, int d, float scale,
                                      void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, sb, sh, sn, mask, n, d, scale);
  a.g = {g, gsb, gsh, gsn};
  a.lse = stat_bhn(lse, H, n);
  a.rt = stat_bhn(rowterm, H, n);
  a.dk = out_bhnd(dk, H, n, d);
  a.dv = out_bhnd(dv, H, n, d);
  AMMA_DISPATCH(d, (launch_dkv<DP, true>(a, B, H, static_cast<cudaStream_t>(stream))))
}
