// Online-softmax attention straight off the native (B, N, 3*H*D) qkv panel,
// forward and backward, for Hopper (sm_90a), with an optional shared (N, N)
// mask.
//
// Replaces the Pallas TPU kernels of `flash_qkv_attention`
// (vit4hep_tpu/ops/flash_qkv_attention.py:270): the forward `_fwd_kernel`
// (:62, pallas_call :305), the backward `_bwd_dq_kernel` (:119, pallas_call
// :360) and `_bwd_dkv_kernel` (:164, pallas_call :389). The TPU kernel keeps
// one element's whole bf16 panel resident in VMEM and loops over the heads
// inside a grid cell; here a CTA owns 64 query rows (16 per warp) of one
// (batch, head) and reads the head's 80-wide column slices of the 1440-wide
// rows straight from device memory into bf16 tiles, so the merged context
// (B, N, H*D), the per-head lse (B, N, H) and the merged cotangent (B, N,
// 3*H*D) need no transposes and no copies.
//
//  - flash_fwd_kernel<DP, HAS_MASK>: K/V stream in 64-row tiles with an
//    online softmax (running max m, sum l, context O rescaled by exp(m_old
//    - m_new)); p is rounded to bf16 for the P . V product, which runs on the
//    tensor cores, as the TPU kernel's `_mm` does. The pad guard of the TPU
//    kernel (:88-93): a key past N counts -1e30 in the max and exactly 0 in l
//    and O, so a fully masked row gets the mean of V over the N real keys,
//    whatever tile size pads N (JAX pads to n_pad = 512 at ds3, this kernel
//    to a multiple of 64).
//  - backward (attention_mma.cuh): delta = rowsum(dO * O) per head comes
//    from K1's delta kernel (qkv_attention.cu, `qkv_attention_bwd_delta`),
//    then bwd_dq_kernel<DP, HAS_MASK, false> writes the q columns of dqkv and
//    bwd_dkv_kernel<DP, HAS_MASK, false> the k and v columns, each element
//    once. p = exp(s - lse) on the mask and 0 off it (also on a fully masked
//    row, as JAX's `where(valid, ...)`, :148 and :195).
//
// What bounds it on this card: at the ds3 training shape (qkv (64, 450,
// 1440) f32) the forward reads 166 MB and writes 56 MB (0.066 ms at 3.35
// TB/s) against 24.9 GFLOP on the bf16 tensor cores (0.025 ms): it is bound
// by bytes. The scores stay on chip; each K/V tile is read from L2 once per
// 64 query rows and converted to bf16 on load. The O accumulator goes
// through shared memory once per key tile for its rescale (WMMA's fragment
// layout is opaque). wgmma, TMA and cp.async pipelining, and a register
// layout that rescales O in place, are the levers for a later change.

#include "attention_mma.cuh"

using namespace amma;

namespace {

template <int DP>
constexpr size_t fwd_smem() {
  return (size_t)3 * ROWS * (DP + 8) * 2 + (size_t)ROWS * LDS * 4 + (size_t)ROWS * LDP * 2 +
         (size_t)ROWS * (DP + 4) * 4;
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DP + 8, LDO = DP + 4;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + ROWS * LD;
  __nv_bfloat16* Vs = Ks + KT * LD;
  float* S = reinterpret_cast<float*>(Vs + KT * LD);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(S + ROWS * LDS);
  float* O = reinterpret_cast<float*>(Ps + ROWS * LDP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS, r0 = q0 + warp * WR;
  const int n = a.n, d = a.d;
  float* Sw = S + warp * WR * LDS;
  __nv_bfloat16* Pw = Ps + warp * WR * LDP;
  float* Ow = O + warp * WR * LDO;
  const __nv_bfloat16* Qw = Qs + warp * WR * LD;
  const float* kb = base(a.k, b, h);
  const float* vb = base(a.v, b, h);

  load_rows<DP>(Qs, base(a.q, b, h), a.q.sn, q0, ROWS, n, d);
  for (int i = lane; i < WR * LDO; i += 32) Ow[i] = 0.f;
  float m[WR], l[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    m[r] = MASKED;  // as `jnp.full(..., _NEG_INF)`: a wholly masked row keeps p = 1
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += KT) {
    __syncthreads();
    load_rows<DP>(Ks, kb, a.k.sn, k0, KT, n, d);
    load_rows<DP>(Vs, vb, a.v.sn, k0, KT, n, d);
    __syncthreads();
    warp_abt<DP>(Sw, Qw, Ks);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      float s[KT / 32], t = MASKED;
#pragma unroll
      for (int j = 0; j < KT / 32; ++j) {
        const int key = k0 + lane + 32 * j;
        s[j] = (key < n && attends<HAS_MASK>(r0 + r, key, n, a.mask))
                   ? Sw[r * LDS + lane + 32 * j] * a.scale
                   : MASKED;
        t = fmaxf(t, s[j]);
      }
      const float mn = fmaxf(m[r], warp_max(t));
      const float alpha = expf(m[r] - mn);
      m[r] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 32; ++j) {
        const float p = k0 + lane + 32 * j < n ? expf(s[j] - mn) : 0.f;  // the pad guard
        ls += p;
        Pw[r * LDP + lane + 32 * j] = __float2bfloat16(p);
      }
      l[r] = l[r] * alpha + warp_sum(ls);
      for (int c = lane; c < DP; c += 32) Ow[r * LDO + c] *= alpha;
    }
    __syncwarp();
    Acc o[DP / 16];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      wmma::load_matrix_sync(o[j], Ow + j * 16, LDO, wmma::mem_row_major);
    warp_pv<DP>(o, Pw, Vs);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      wmma::store_matrix_sync(Ow + j * 16, o[j], LDO, wmma::mem_row_major);
    __syncwarp();
  }

  float* ob = base(a.o, b, h);
  float* lo = base(a.lse_out, b, h);
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    if (r0 + r >= n) break;
    const float ls = l[r] == 0.f ? 1.f : l[r];
    float* orow = ob + (long long)(r0 + r) * a.o.sn;
    for (int c = lane; c < d; c += 32) orow[c] = Ow[r * LDO + c] / ls;
    if (lane == 0) lo[(long long)(r0 + r) * a.lse_out.sn] = m[r] + logf(ls);
  }
}

template <int DP>
cudaError_t launch_fwd(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr ? launch(flash_fwd_kernel<DP, true>, fwd_smem<DP>(), a, B, H, st)
                           : launch(flash_fwd_kernel<DP, false>, fwd_smem<DP>(), a, B, H, st);
}

// the panel's q, k and v slabs (row stride 3*H*d) and the lse (B, n, H);
// the backward's g and the context share the (B, n, H*d) layout, delta is
// K1's (B, H, n)
Args panel_args(const float* qkv, const unsigned char* mask, int H, int n, int d, float scale) {
  const long long ld = 3LL * H * d;
  Args a{};
  a.q = {qkv, n * ld, d, ld};
  a.k = {qkv + (long long)H * d, n * ld, d, ld};
  a.v = {qkv + 2LL * H * d, n * ld, d, ld};
  a.mask = mask;
  a.n = n;
  a.d = d;
  a.scale = scale;
  return a;
}

// the backward's arguments: g like the context, K1's delta (B, H, n), and
// dqkv like the panel
Args bwd_args(const float* qkv, const float* g, const float* lse, const float* delta,
              const unsigned char* mask, float* dqkv, int H, int n, int d, float scale) {
  Args a = panel_args(qkv, mask, H, n, d, scale);
  const long long hd = (long long)H * d, ld = 3 * hd;
  a.g = {g, n * hd, d, hd};
  a.lse = {lse, (long long)n * H, 1, H};
  a.rt = {delta, (long long)H * n, n, 1};
  a.dq = {dqkv, n * ld, d, ld};
  a.dk = {dqkv + hd, n * ld, d, ld};
  a.dv = {dqkv + 2 * hd, n * ld, d, ld};
  return a;
}

}  // namespace

extern "C" int flash_qkv_fwd(const float* qkv, const unsigned char* mask, float* out, float* lse,
                             int B, int H, int n, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  Args a = panel_args(qkv, mask, H, n, d, scale);
  const long long hd = (long long)H * d;
  a.o = {out, n * hd, d, hd};
  a.lse_out = {lse, (long long)n * H, 1, H};
  AMMA_DISPATCH(d, launch_fwd<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}

// dQ: the q columns of dqkv
extern "C" int flash_qkv_bwd_dq(const float* qkv, const float* g, const float* lse,
                                const float* delta, const unsigned char* mask, float* dqkv, int B,
                                int H, int n, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const Args a = bwd_args(qkv, g, lse, delta, mask, dqkv, H, n, d, scale);
  AMMA_DISPATCH(d, (launch_dq<DP, false>(a, B, H, static_cast<cudaStream_t>(stream))))
}

// dK and dV: the k and v columns of dqkv
extern "C" int flash_qkv_bwd_dkv(const float* qkv, const float* g, const float* lse,
                                 const float* delta, const unsigned char* mask, float* dqkv, int B,
                                 int H, int n, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const Args a = bwd_args(qkv, g, lse, delta, mask, dqkv, H, n, d, scale);
  AMMA_DISPATCH(d, (launch_dkv<DP, false>(a, B, H, static_cast<cudaStream_t>(stream))))
}
