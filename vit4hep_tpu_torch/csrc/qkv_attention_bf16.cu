// K1's bf16 arm: attention on a bfloat16 qkv panel, forward and backward,
// for Hopper (sm_90a), with an optional shared (N, N) mask.
//
// Replaces the Pallas TPU kernels of `fused_qkv_attention` on a bf16 panel
// (vit4hep_tpu/ops/fused_qkv_attention.py:178; the forward `_fused_fwd` :190,
// pallas_call :231, and the backward `_fused_bwd` :300, pallas_call :328),
// which a ViT with `compute_dtype: bfloat16` feeds. The TPU kernels take the
// panel as it is: the products on bf16 multiplicands with f32 accumulation
// (`mm_dtype` bf16 off interpret mode, :219 and :321), p and ds rounded to
// bf16 before their products, the softmax statistics in f32; the context is
// stored in the panel's dtype and the lse in f32 (:240-241), dqkv in the
// panel's dtype (:333).
//
// That is the function K6's wgmma kernels compute (attention_wgmma.cuh,
// flash_bwd_wgmma.cuh) off an f32 panel that they convert to bf16 in shared
// memory. This arm runs their bodies on the bf16 panel itself: its tiles are
// copied as they are (half the bytes of an f32 tile) into the swizzled
// operand layouts, each product is one bf16 wgmma pass, and the context and
// dqkv are stored in bf16:
//  - qkv_fwd_bf16_kernel<DP, HAS_MASK>: flash_fwd_body on bf16; the merged
//    (B, N, H*D) bf16 context and K1's (B, H, N) f32 lse.
//  - bwd_delta_bf16_kernel: delta = rowsum(dO * O) in f32 from the bf16 g and
//    context, one warp per (batch, query, head) row, (B, H, N) f32.
//  - qkv_bwd_dkv_bf16_kernel / qkv_bwd_dq_bf16_kernel: flash_bwd_dkv_body and
//    flash_bwd_dq_body on bf16 with K1's dead-row rule (a wholly masked row
//    has lse -1e30, weighs each key 1 and takes delta times n, as JAX's K1
//    rebuilds it), writing the k/v and the q columns of the bf16 dqkv.
// A library of its own: K1's f32 kernels (qkv_attention.cu,
// qkv_attention_bwd.cu) keep their translation units and their code.
//
// What bounds it at the ds2 training shape (qkv (64, 135, 1440) bf16, 6 heads
// of 80): the forward reads 25 MB and writes 8.3 MB (0.010 ms at 3.35 TB/s)
// against 2.24 GFLOP (0.0023 ms at 989 TFLOP/s); the backward passes read
// the panel, g and the statistics and write dqkv: bytes. So each streamed
// tile is read once per 128 rows and no score leaves the registers.

#include "flash_bwd_wgmma.cuh"

using namespace amma;

namespace {

// K1's layouts on a bf16 panel: q, k, v slabs of the (B, n, 3*H*d) panel,
// the (B, H, n) lse; the slabs' pointers carry bf16 data (aw::tbase reads
// them as such) and their strides count elements
Args panel_args(const __nv_bfloat16* qkv, const unsigned char* mask, int H, int n, int d,
                float scale) {
  const long long ld = 3LL * H * d;
  const float* p = reinterpret_cast<const float*>(qkv);
  const __nv_bfloat16* k = qkv + (long long)H * d;
  const __nv_bfloat16* v = qkv + 2LL * H * d;
  Args a{};
  a.q = {p, n * ld, d, ld};
  a.k = {reinterpret_cast<const float*>(k), n * ld, d, ld};
  a.v = {reinterpret_cast<const float*>(v), n * ld, d, ld};
  a.mask = mask;
  a.n = n;
  a.d = d;
  a.scale = scale;
  return a;
}

Args bwd_args(const __nv_bfloat16* qkv, const __nv_bfloat16* g, const float* lse,
              const float* delta, const unsigned char* mask, __nv_bfloat16* dqkv, int H, int n,
              int d, float scale) {
  Args a = panel_args(qkv, mask, H, n, d, scale);
  const long long hd = (long long)H * d, ld = 3 * hd;
  a.g = {reinterpret_cast<const float*>(g), n * hd, d, hd};
  a.lse = {lse, (long long)H * n, n, 1};
  a.rt = {delta, (long long)H * n, n, 1};
  a.dq = {reinterpret_cast<float*>(dqkv), n * ld, d, ld};
  a.dk = {reinterpret_cast<float*>(dqkv + hd), n * ld, d, ld};
  a.dv = {reinterpret_cast<float*>(dqkv + 2 * hd), n * ld, d, ld};
  return a;
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(aw::THREADS) qkv_fwd_bf16_kernel(Args a) {
  aw::flash_fwd_body<DP, HAS_MASK, __nv_bfloat16>(a);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(aw::THREADS) qkv_bwd_dq_bf16_kernel(Args a) {
  aw::flash_bwd_dq_body<DP, HAS_MASK, __nv_bfloat16, true>(a);
}

template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(aw::THREADS) qkv_bwd_dkv_bf16_kernel(Args a) {
  aw::flash_bwd_dkv_body<DP, HAS_MASK, __nv_bfloat16, true>(a);
}

__global__ void bwd_delta_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                                      const __nv_bfloat16* __restrict__ o,
                                      float* __restrict__ delta, int B, int n, int H, int d) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * n * H) return;  // uniform per warp
  const int h = (int)(warp % H);
  const long long bn = warp / H;  // b * n + row
  const size_t off = (size_t)bn * H * d + (size_t)h * d;
  float acc = 0.f;
  for (int k = lane; k < d; k += 32)
    acc = fmaf(__bfloat162float(g[off + k]), __bfloat162float(o[off + k]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const long long b = bn / n, row = bn % n;
    delta[((size_t)b * H + h) * n + row] = acc;
  }
}

template <int DP>
cudaError_t launch_fwd(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr
             ? aw::launch_rows(qkv_fwd_bf16_kernel<DP, true>, aw::fwd_smem_q<DP, true>(), a, B,
                               H, st)
             : aw::launch_rows(qkv_fwd_bf16_kernel<DP, false>, aw::fwd_smem_q<DP, false>(), a,
                               B, H, st);
}

template <int DP>
cudaError_t launch_dq(const Args& a, int B, int H, cudaStream_t st) {
  constexpr size_t smem = aw::vmem_dq_smem<DP>();
  return a.mask != nullptr ? aw::launch_rows(qkv_bwd_dq_bf16_kernel<DP, true>, smem, a, B, H, st)
                           : aw::launch_rows(qkv_bwd_dq_bf16_kernel<DP, false>, smem, a, B, H,
                                             st);
}

template <int DP>
cudaError_t launch_dkv(const Args& a, int B, int H, cudaStream_t st) {
  constexpr size_t smem = aw::vmem_dkv_smem<DP>(aw::dkv_ring<DP>());
  return a.mask != nullptr
             ? aw::launch_rows(qkv_bwd_dkv_bf16_kernel<DP, true>, smem, a, B, H, st)
             : aw::launch_rows(qkv_bwd_dkv_bf16_kernel<DP, false>, smem, a, B, H, st);
}

}  // namespace

extern "C" int qkv_attention_fwd_bf16(const __nv_bfloat16* qkv, const unsigned char* mask,
                                      __nv_bfloat16* out, float* lse, int B, int n, int H, int d,
                                      float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  Args a = panel_args(qkv, mask, H, n, d, scale);
  const long long hd = (long long)H * d;
  a.o = {reinterpret_cast<float*>(out), n * hd, d, hd};
  a.lse_out = {lse, (long long)H * n, n, 1};
  AMMA_DISPATCH(d, launch_fwd<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}

extern "C" int qkv_attention_bwd_delta_bf16(const __nv_bfloat16* g, const __nv_bfloat16* o,
                                            float* delta, int B, int n, int H, int d,
                                            void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * n * H;
  const int per_block = 8;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  bwd_delta_bf16_kernel<<<(unsigned)blocks, per_block * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(g, o, delta, B, n, H, d);
  return (int)cudaGetLastError();
}

// dK and dV: the k and v columns of dqkv
extern "C" int qkv_attention_bwd_dkv_bf16(const __nv_bfloat16* qkv, const __nv_bfloat16* g,
                                          const float* lse, const float* delta,
                                          const unsigned char* mask, __nv_bfloat16* dqkv, int B,
                                          int n, int H, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const Args a = bwd_args(qkv, g, lse, delta, mask, dqkv, H, n, d, scale);
  AMMA_DISPATCH(d, launch_dkv<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}

// dQ: the q columns of dqkv
extern "C" int qkv_attention_bwd_dq_bf16(const __nv_bfloat16* qkv, const __nv_bfloat16* g,
                                         const float* lse, const float* delta,
                                         const unsigned char* mask, __nv_bfloat16* dqkv, int B,
                                         int n, int H, int d, float scale, void* stream) {
  if (bad_dims(B, n, H, d)) return (int)cudaErrorInvalidValue;
  const Args a = bwd_args(qkv, g, lse, delta, mask, dqkv, H, n, d, scale);
  AMMA_DISPATCH(d, launch_dq<DP>(a, B, H, static_cast<cudaStream_t>(stream)))
}
