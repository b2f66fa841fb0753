// Online-softmax attention straight off the native (B, N, 3*H*D) qkv panel,
// forward and backward, for Hopper (sm_90a), with an optional shared (N, N)
// mask.
//
// Replaces the Pallas TPU kernels of `flash_qkv_attention`
// (vit4hep_tpu/ops/flash_qkv_attention.py:270): the forward `_fwd_kernel`
// (:62, pallas_call :305), the backward `_bwd_dq_kernel` (:119, pallas_call
// :360) and `_bwd_dkv_kernel` (:164, pallas_call :389). The TPU kernel keeps
// one element's whole bf16 panel resident in VMEM and loops over the heads
// inside a grid cell; here a CTA owns query (or, for dK/dV, key) rows of one
// (batch, head) and reads the head's 80-wide column slices of the 1440-wide
// rows straight from device memory into bf16 tiles, so the merged context
// (B, N, H*D), the per-head lse (B, N, H) and the merged cotangent (B, N,
// 3*H*D) need no transposes and no copies.
//
//  - the forward, aw::flash_fwd_wgmma_kernel<DP, HAS_MASK>
//    (attention_wgmma.cuh): K/V stream in 64-row tiles through a cp.async
//    ring, converted once per 128 query rows into the bf16 operands of
//    wgmma; S, O and the online-softmax statistics (running max m, sum l, O
//    rescaled by exp(m_old - m_new)) stay in registers; p is rounded to bf16
//    for the P . V product, as the TPU kernel's `_mm` does. The pad guard of
//    the TPU kernel (:88-93): a key past N counts -1e30 in the max and
//    exactly 0 in l and O, so a fully masked row gets the mean of V over the
//    N real keys, whatever tile size pads N (JAX pads to n_pad = 512 at ds3,
//    this kernel to a multiple of 64).
//  - backward (flash_bwd_wgmma.cuh): delta = rowsum(dO * O) per head comes
//    from K1's delta kernel (qkv_attention.cu, `qkv_attention_bwd_delta`),
//    then aw::flash_bwd_dq_wgmma_kernel<DP, HAS_MASK> writes the q columns
//    of dqkv in one sweep over the keys and
//    aw::flash_bwd_dkv_wgmma_kernel<DP, HAS_MASK> the k and v columns, each
//    element once, on K8's wgmma pieces (vmem_wgmma.cuh). p = exp(s - lse)
//    on the mask and 0 off it (also on a fully masked row, as JAX's
//    `where(valid, ...)`, :148 and :195).
//
// What bounds it on this card: at the ds3 training shape (qkv (64, 450,
// 1440) f32) the forward reads 166 MB and writes 56 MB (0.066 ms at 3.35
// TB/s) against 24.9 GFLOP on the bf16 tensor cores (0.025 ms), and the
// backward passes likewise: bytes (attention_wgmma.cuh and
// flash_bwd_wgmma.cuh say how their designs meet that).

#include "flash_bwd_wgmma.cuh"

using namespace amma;

namespace {

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
  AMMA_DISPATCH(d, aw::launch_fwd<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}

// dQ: the q columns of dqkv
extern "C" int flash_qkv_bwd_dq(const float* qkv, const float* g, const float* lse,
                                const float* delta, const unsigned char* mask, float* dqkv, int B,
                                int H, int n, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const Args a = bwd_args(qkv, g, lse, delta, mask, dqkv, H, n, d, scale);
  AMMA_DISPATCH(d, aw::launch_flash_dq<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}

// dK and dV: the k and v columns of dqkv
extern "C" int flash_qkv_bwd_dkv(const float* qkv, const float* g, const float* lse,
                                 const float* delta, const unsigned char* mask, float* dqkv, int B,
                                 int H, int n, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const Args a = bwd_args(qkv, g, lse, delta, mask, dqkv, H, n, d, scale);
  AMMA_DISPATCH(d, aw::launch_flash_dkv<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}
