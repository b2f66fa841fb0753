// One-shot exact-softmax attention on separated (B, H, N, D) tensors,
// forward and backward, for Hopper (sm_90a), with an optional shared (N, N)
// mask: the C interface of K8's kernels.
//
// Replaces the Pallas TPU kernels of `vmem_attention`
// (vit4hep_tpu/ops/vmem_attention.py:82): the forward `_oneshot_kernel` (:47,
// pallas_call :111) and the backward `_bwd_kernel` (:140, pallas_call :193).
// The kernels are vmem_wgmma.cuh's, which says what they compute, what
// bounds them and how: the forward vmem_fwd_wgmma_kernel (two sweeps over
// the keys for the exact softmax), then for the gradient the dQ pass
// vmem_bwd_dq_wgmma_kernel (writes dQ and K8's own row term rowsum(dp * p))
// and the dK/dV pass vmem_bwd_dkv_wgmma_kernel (reads the row term).
// q, k and v share one stride set (a strided view of the ViT's qkv panel
// goes in as it is); the upstream gradient has its own; every output is
// contiguous.

#include "vmem_wgmma.cuh"

using namespace amma;

namespace {

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
  AMMA_DISPATCH(d, aw::launch_vmem_fwd<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
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
  AMMA_DISPATCH(d, aw::launch_vmem_dq<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
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
  AMMA_DISPATCH(d, aw::launch_vmem_dkv<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}
