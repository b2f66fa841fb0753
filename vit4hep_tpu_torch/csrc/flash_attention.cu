// Streaming flash attention on separated (B, H, N, D) tensors, forward and
// backward, for Hopper (sm_90a), with an optional shared (N, N) mask: K7.
//
// Replaces the Pallas TPU kernels of `flash_attention`
// (vit4hep_tpu/ops/flash_attention.py:188): the forward `_fwd_kernel` (:39,
// pallas_call :219), `_bwd_dkv_kernel` (:84, pallas_call :278) and
// `_bwd_dq_kernel` (:128, pallas_call :309). JAX reaches it past
// `flash_qkv_fits` (10,752 tokens at hidden 480, 6 heads) and from
// `dot_product_attention(impl="flash")`. The TPU kernel computes in f32
// throughout (every operand `.astype(jnp.float32)`, every dot_general f32);
// so do these kernels, each product as three TF32 wgmma products on
// operands split into tf32 hi and lo parts once a call by the pre-pass
// (flash_tf32.cuh: the layouts, the design and what bounds it):
//  - flash_attention_split: k7_split_kernel, the operands' hi and lo parts
//    into padded contiguous buffers (up to four operands a launch);
//  - flash_attention_fwd: k7_fwd_kernel over q (strided, split in the CTA)
//    and K, V^T from the split buffers; writes o (B, H, N, D) f32 and the
//    log-sum-exp (B, H, N) f32;
//  - flash_attention_bwd_dkv: k7_bwd_dkv_kernel, one CTA per (64 key rows,
//    head, batch) looping over the queries (the TPU grid over key blocks);
//  - flash_attention_bwd_dq: k7_bwd_dq_kernel, one CTA per (64 query rows,
//    head, batch) looping over the keys.
// delta = rowsum(dO * O) is computed outside the kernels, as JAX computes
// it in plain XLA (:258), and handed to the dK/dV pass padded to N_pad with
// the lse (+inf past N).
//
// q, k and v share one stride set (sb, sh, sn) with a unit column stride,
// so the ViT's split of its qkv panel is read in place; dO has its own.
// Offsets are size_t: at the long-sequence ds3 shape (8, 6, 13500, 80) a
// tensor holds 52 million elements and the layer-causal (N, N) mask 182 MB.

#include "flash_tf32.cuh"

namespace {

// batch and heads go to grid dims y and z (at most 65535 each); the row
// tiles to x (2^31 - 1)
bool bad(int B, int H, int n, int d) { return attn::bad_dims(B, n, H, d); }

}  // namespace

// jobs: njobs (1-4) records of 8 values: x, its strides sb, sh, sn, then the
// rows layout's hi and lo buffers and the cols layout's (0 = not wanted),
// each buffer (B, H, N_pad, DP) f32
extern "C" int flash_attention_split(const long long* jobs, int njobs, int B, int H, int n, int d,
                                     void* stream) {
  if (bad(B, H, n, d) || njobs < 1 || njobs > k7::MAX_JOBS) return (int)cudaErrorInvalidValue;
  k7::SplitJobs js{};
  for (int i = 0; i < njobs; ++i) {
    const long long* r = jobs + 8 * i;
    js.job[i] = {reinterpret_cast<const float*>(r[0]), r[1], r[2], r[3],
                 reinterpret_cast<float*>(r[4]), reinterpret_cast<float*>(r[5]),
                 reinterpret_cast<float*>(r[6]), reinterpret_cast<float*>(r[7])};
    if ((js.job[i].rows_hi == nullptr) != (js.job[i].rows_lo == nullptr) ||
        (js.job[i].cols_hi == nullptr) != (js.job[i].cols_lo == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  ATTN_DISPATCH(d, k7::launch_split<DP>(js, njobs, B, H, n, d,
                                        static_cast<cudaStream_t>(stream)))
}

// kv: K's rows-layout hi and lo, V's cols-layout hi and lo
extern "C" int flash_attention_fwd(const float* q, long long sb, long long sh, long long sn,
                                   const float* k_hi, const float* k_lo, const float* vt_hi,
                                   const float* vt_lo, const unsigned char* mask, float* out,
                                   float* lse, int B, int H, int n, int d, float scale,
                                   void* stream) {
  if (bad(B, H, n, d)) return (int)cudaErrorInvalidValue;
  const float* const kv[4] = {k_hi, k_lo, vt_hi, vt_lo};
  ATTN_DISPATCH(d, k7::launch_fwd<DP>(q, sb, sh, sn, kv, mask, out, lse, B, H, n, d, scale,
                                      static_cast<cudaStream_t>(stream)))
}

// ops: the split buffers, filled by field name (ops/flash_attention.py's
// BwdOps); lse_p, delta_p: the lse (+inf past N) and delta (0 past N),
// (B, H, N_pad)
extern "C" int flash_attention_bwd_dkv(const k7::BwdOps* ops, const float* lse_p,
                                       const float* delta_p, const unsigned char* mask,
                                       float* dk, float* dv, int B, int H, int n, int d,
                                       float scale, void* stream) {
  if (bad(B, H, n, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, k7::launch_dkv<DP>(*ops, lse_p, delta_p, mask, dk, dv, B, H, n, d, scale,
                                      static_cast<cudaStream_t>(stream)))
}

// lse, delta: (B, H, N) as the forward and delta_plain give them
extern "C" int flash_attention_bwd_dq(const k7::BwdOps* ops, const float* lse,
                                      const float* delta, const unsigned char* mask, float* dq,
                                      int B, int H, int n, int d, float scale, void* stream) {
  if (bad(B, H, n, d)) return (int)cudaErrorInvalidValue;
  ATTN_DISPATCH(d, k7::launch_dq<DP>(*ops, lse, delta, mask, dq, B, H, n, d, scale,
                                     static_cast<cudaStream_t>(stream)))
}
