// K1's backward passes in split TF32 (qkv_bwd_tf32.cuh), bound apart from
// the forward and the delta kernel (qkv_attention.cu): with these kernels in
// its translation unit nvcc compiled K1's forward kernels to other code than
// alone (PERF.md section 6), so each gets its own library.
//
// Replaces the TPU kernel `_fused_bwd`
// (vit4hep_tpu/ops/fused_qkv_attention.py:300: `_bwd_kernel` :252,
// `_bwd_kernel_masked` :260; pallas_call :328). dK/dV and dQ are written
// into the (B, N, 3*H*D) dqkv panel at the k/v and q column offsets of
// `_fused_kernel_masked` (:70-73), every element once.

#include "qkv_bwd_tf32.cuh"

extern "C" int qkv_attention_bwd_dkv(const float* qkv, const float* g, const float* lse,
                                     const float* delta, const unsigned char* mask, float* dqkv,
                                     int B, int n, int H, int d, float scale, void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, tb::launch_dkv<DP>(qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale,
                                      static_cast<cudaStream_t>(stream)))
}

extern "C" int qkv_attention_bwd_dq(const float* qkv, const float* g, const float* lse,
                                    const float* delta, const unsigned char* mask, float* dqkv,
                                    int B, int n, int H, int d, float scale, void* stream) {
  if (attn::bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, tb::launch_dq<DP>(qkv, g, lse, delta, mask, dqkv, B, n, H, d, scale,
                                 static_cast<cudaStream_t>(stream)))
}
