// Whole-ViT sampler forward for Hopper (sm_90a), as a set of kernels.
//
// Replaces the Pallas TPU kernels of `fused_vit_forward`
// (vit4hep_tpu/ops/fused_dit_block.py:1362): `_vit_kernel` (:1315,
// pallas_call at :1463), the masked `_vit_kernel_masked` (:1281) and the
// grouped `_vit_kernel_g` (:1325, pallas_call at :1423) -- patch embedding
// + positional add, L adaLN-Zero DiT blocks, and the FinalLayer. The
// grouped TPU body packs G elements into one grid cell, with a
// block-diagonal mask (`_grouped_mask`, :287) so that they do not attend to
// each other: per element it is the ungrouped function, which these kernels
// compute over all B*N rows at once for any G.
//
// What bounds it on this card: the TPU kernel keeps one element's whole
// 6-block panel in 128 MiB of VMEM. Here one element's 135 x 480 f32
// activation alone (259 KB) exceeds a CTA's 227 KB of shared memory, so the
// work is split across kernels and the (B*N, H) panels make round trips
// through device memory / L2 between them. At ds2 (B=256) the forward is
// ~1.2 TFLOP per net eval, ~95% of it in the qkv, out-projection and MLP
// products, so it is bound by tensor-core throughput: the products run on
// bf16 multiplicands with f32 accumulation (the TPU kernel's precision),
// through wgmma.
//
// The kernels:
//  - gemm_wgmma_kernel<BN, EPI>: out = epilogue(A (M, K) @ W (K, N) + bias)
//    over all B*N rows, bf16 multiplicands, f32 accumulation. This is what
//    bounds the forward, so it is built the way this card's tensor cores
//    want:
//      * 192 x BN output tiles (BN = 160 for N = 480, 1440, 1920, which it
//        divides; 96 or 64 for the narrow final products, N = 90 and 48);
//        three consumer warpgroups each own 64 rows and issue
//        wgmma.mma_async m64nBNk16 with f32 accumulators in registers. The
//        mainloop is bound by what it reads from L2 (W is read once per
//        row tile, A once per column tile), so the tile is as tall as the
//        registers allow: 192 rows cut W's traffic by a third against 128
//        (M = 135 or 450 tokens x 64 or 256 elements is a multiple of 192);
//      * A and W stream through a ring of STAGES = 4 shared-memory stages of
//        K = 64, filled by TMA from one producer thread and signalled by
//        mbarriers (full: bytes landed; empty: every consumer done). A is
//        K-major with the 128-byte swizzle; W (K, N) row-major is read as
//        it is, the MN-major B operand (transpose bit set), in 32-column
//        boxes with the 64-byte swizzle. Rows past M and the K tail (480 =
//        7.5 x 64) are zero-filled by TMA's out-of-bounds fill;
//      * a persistent grid (one CTA per SM walking the tiles, N fastest so
//        that A's rows stay in L2): the producer fills the next tile's
//        stages while the consumers run this tile's epilogue;
//      * the epilogue runs from the accumulator registers in their
//        documented layout, column pairs as float2 / bf16x2 stores. Its
//        family: bias; bias + positional embedding pos[row % n_tok]; bias +
//        tanh-GELU written as bf16 (the next product's A), optionally saving
//        the pre-GELU a1 as bf16; gated residual out = resid + gate[row /
//        n_tok] * (. + bias) on the f32 residual stream (in place when resid
//        is out), optionally saving y = . + bias as bf16. The training
//        forward (K5a, `_vit_fwd_train`, vit4hep_tpu/ops/fused_dit_block.py:
//        1491, pallas_call :1549) uses the same kernel with those saves (the
//        residual writes of `_store_block_res`, :489), and K9
//        (`fused_mlp_half`'s `_kernel`, vit4hep_tpu/ops/fused_mlp.py:51)
//        chains it with modln_kernel.
//    TMA needs 16-byte row strides: the wrapper casts an f32 A to bf16
//    (round to nearest even) and pads A to K8 = K rounded up to 8 columns
//    and W to (K8, N8) with zeros (ds3's 90-wide patches and final layer);
//    the kernel stores only the N real columns. Bound at ds2 (M = 34,560):
//    the qkv product is 47.8 GFLOP (0.048 ms at the bf16 peak) against 33
//    MB of A and 199 MB of f32 output (0.069 ms at 3.35 TB/s): the six
//    products of a forward sit near the balance of bytes and operations.
//  - modln_kernel: LayerNorm (no affine, eps 1e-6) + adaLN modulate
//    (1 + scale) * . + shift, one warp per row, written as bf16.
//  - attention: vattn::vit_attn_wgmma_kernel of vit_attention_wgmma.cuh,
//    the online-softmax attention on wgmma straight off the qkv panel (64-key
//    K/V tiles through a cp.async ring, converted once to bf16; S and O in
//    registers; optional shared (N, N) mask), writing the merged (B, N, H*D)
//    context as bf16 and no log-sum-exp. Its shared memory is fixed (107,520
//    B at d = 80) whatever N: ds3's 450 tokens run as ds2's 135 do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"
#include "vit_attention_wgmma.cuh"

namespace {

constexpr int CONSUMERS = 3;                   // warpgroups of 64 rows
constexpr int BM = 64 * CONSUMERS, BK = 64, STAGES = 4;
constexpr int GEMM_THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;           // one stage of A: BM rows x 128 B
constexpr int W_BOX = 32;                      // W's box: 64 K-rows x 32 columns (64 B)
constexpr int W_BOX_BYTES = BK * W_BOX * 2;

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN * BK * 2;
}

template <int BN>
__host__ __device__ constexpr size_t gemm_smem() {
  return (size_t)STAGES * stage_bytes<BN>() + 2 * STAGES * sizeof(uint64_t) + 1024;
}

enum Epi { EPI_BIAS = 0, EPI_BIAS_POS = 1, EPI_BIAS_GELU = 2, EPI_GATED_RESID = 3 };

struct GemmArgs {
  const float* bias;
  void* out;
  const float* aux;  // EPI_BIAS_POS: pos (n_tok, N); EPI_GATED_RESID: gate rows (B, *)
  long long aux_stride;
  const float* resid;     // EPI_GATED_RESID: the residual added to (may be out)
  __nv_bfloat16* save;    // EPI_BIAS_GELU: a1; EPI_GATED_RESID: y; or nullptr
  int M, N, K, n_tok;
  bool vec;  // column pairs as 8-byte vectors: N even, every pointer and aux_stride aligned
};

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// columns (col, col + 1) of row-major data p, zero past N; one 8-byte load
// when the columns are aligned pairs
__device__ __forceinline__ float2 load_pair(const float* p, int col, const GemmArgs& g) {
  if (col >= g.N) return make_float2(0.f, 0.f);
  if (g.vec) return *reinterpret_cast<const float2*>(p + col);
  return make_float2(p[col], col + 1 < g.N ? p[col + 1] : 0.f);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, int col, float v0, float v1, const GemmArgs& g) {
  if (g.vec) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(p + col) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(v0, v1);
  } else if constexpr (sizeof(T) == 4) {
    p[col] = v0;
    if (col + 1 < g.N) p[col + 1] = v1;
  } else {
    p[col] = __float2bfloat16(v0);
    if (col + 1 < g.N) p[col + 1] = __float2bfloat16(v1);
  }
}

// the epilogue of a consumer's 64 x BN accumulators: thread (warp w, lane l)
// holds rows row0 and row0 + 8 (row0 = tile row + 16 w + l / 4), columns
// col0 + 8 j + {0, 1} (col0 = tile column + 2 (l % 4)). Every load of a
// group of EPI_GROUP column pairs is issued before its stores, so that their
// latencies overlap (the gated residual may run in place: a store can alias
// a later load, so the compiler cannot hoist loads past stores itself).
constexpr int EPI_GROUP = 4;

template <int BN, int EPI>
__device__ __forceinline__ void epilogue(const GemmArgs& g, const float (&acc)[BN / 2], int row0,
                                         int col0) {
  static_assert((BN / 8) % EPI_GROUP == 0, "whole groups of column pairs");
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_GROUP) {
    float2 bias[EPI_GROUP], x[2][EPI_GROUP], gate[2][EPI_GROUP];
#pragma unroll
    for (int c = 0; c < EPI_GROUP; ++c) {
      const int col = col0 + 8 * (j0 + c);
      bias[c] = load_pair(g.bias, col, g);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const bool in = row < g.M;
        if (EPI == EPI_BIAS_POS)
          x[h][c] = in ? load_pair(g.aux + (size_t)(row % g.n_tok) * g.N, col, g) : zero;
        if (EPI == EPI_GATED_RESID) {
          x[h][c] = in ? load_pair(g.resid + (size_t)row * g.N, col, g) : zero;
          gate[h][c] = in ? load_pair(g.aux + (size_t)(row / g.n_tok) * g.aux_stride, col, g)
                          : zero;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < EPI_GROUP; ++c) {
      const int j = j0 + c, col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= g.M || col >= g.N) continue;
        float v0 = acc[4 * j + 2 * h] + bias[c].x, v1 = acc[4 * j + 2 * h + 1] + bias[c].y;
        if (EPI == EPI_BIAS_POS) {
          v0 += x[h][c].x;
          v1 += x[h][c].y;
        }
        const size_t r = (size_t)row * g.N;
        if ((EPI == EPI_BIAS_GELU || EPI == EPI_GATED_RESID) && g.save != nullptr)
          store_pair(g.save + r, col, v0, v1, g);
        if (EPI == EPI_BIAS_GELU) {
          store_pair(static_cast<__nv_bfloat16*>(g.out) + r, col, gelu_tanh(v0), gelu_tanh(v1),
                     g);
          continue;
        }
        if (EPI == EPI_GATED_RESID) {
          v0 = x[h][c].x + gate[h][c].x * v0;
          v1 = x[h][c].y + gate[h][c].y * v1;
        }
        store_pair(static_cast<float*>(g.out) + r, col, v0, v1, g);
      }
    }
  }
}

template <int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_w, GemmArgs g) {
  static_assert(BN % W_BOX == 0, "a stage holds whole W boxes: its byte count is their sum");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * stage_bytes<BN>());
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (g.N + BN - 1) / BN;
  const int tiles = (g.M + BM - 1) / BM * n_tiles;
  const int k_steps = (g.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CONSUMERS * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // the producer: one thread keeps STAGES boxes of A and W in flight
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * stage_bytes<BN>();
          hop::mbar_expect_tx(&full[stage], stage_bytes<BN>());
          hop::tma_load_2d(st, &tma_a, &full[stage], ks * BK, m0);
#pragma unroll
          for (int c = 0; c < BN / W_BOX; ++c)
            hop::tma_load_2d(st + A_BYTES + c * W_BOX_BYTES, &tma_w, &full[stage],
                             n0 + c * W_BOX, ks * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    int stage = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      hop::fence_regs(acc);
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks) {
        hop::mbar_wait(&full[stage], phase);
        const uint32_t a_addr = hop::smem_u32(smem + stage * stage_bytes<BN>()) + wg * 64 * 128;
        const uint32_t w_addr = hop::smem_u32(smem + stage * stage_bytes<BN>() + A_BYTES);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // A: +32 B along its 128-byte rows; W: +16 rows
          hop::Mma<BN, 1>::ss(acc, hop::desc(a_addr + kk * 32, 16, 1024, hop::SW128),
                              hop::desc(w_addr + kk * 16 * W_BOX * 2, W_BOX_BYTES, 8 * W_BOX * 2,
                                        hop::SW64),
                              1);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (ks > 0) hop::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[prev]);

      epilogue<BN, EPI>(g, acc, m0 + wg * 64 + warp * 16 + lane / 4, n0 + 2 * (lane % 4));
    }
  }
}

__global__ void modln_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                             const float* __restrict__ scale, long long mod_stride,
                             __nv_bfloat16* __restrict__ out, int M, int H, int n_tok,
                             float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= M) return;  // whole warp
  const float* xr = x + (size_t)row * H;
  float s = 0.f;
  for (int c = lane; c < H; c += 32) s += xr[c];
  const float mean = warp_sum(s) / H;
  float v = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float dlt = xr[c] - mean;
    v += dlt * dlt;
  }
  const float rstd = rsqrtf(warp_sum(v) / H + eps);
  const int b = row / n_tok;
  const float* sh = shift + (size_t)b * mod_stride;
  const float* sc = scale + (size_t)b * mod_stride;
  for (int c = lane; c < H; c += 32)
    out[(size_t)row * H + c] = __float2bfloat16((xr[c] - mean) * rstd * (1.f + sc[c]) + sh[c]);
}

// the tile width for N output columns (a multiple of W's 32-column box): 160
// divides 480, 1440 and 1920; the narrow final (48, 90) and other products
// take the narrowest that covers them, wide ones 160 with a ragged last tile
inline int gemm_tile_n(int N) {
  return N % 160 == 0 || N > 96 ? 160 : N > 64 ? 96 : 64;
}

template <int BN, int EPI>
cudaError_t launch_tiles(const CUtensorMap& ta, const CUtensorMap& tw, const GemmArgs& g,
                         cudaStream_t s) {
  auto kernel = gemm_wgmma_kernel<BN, EPI>;
  static int ctas_per_sm = 0;  // per instantiation: its attribute set, its occupancy
  if (ctas_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)gemm_smem<BN>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel, GEMM_THREADS,
                                                        gemm_smem<BN>());
    if (e != cudaSuccess) return e;
    if (ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN);
  const int grid = (int)(tiles < (long long)sms * ctas_per_sm ? tiles : (long long)sms * ctas_per_sm);
  kernel<<<grid, GEMM_THREADS, gemm_smem<BN>(), s>>>(ta, tw, g);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_gemm(const void* A, const void* W, const GemmArgs& g, int epi,
                        cudaStream_t s) {
  CUtensorMap ta, tw;
  const int n8 = (g.N + 7) / 8 * 8;
  if (hop::encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, g.M, g.K, g.K, BM, BK,
                     CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      hop::encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, W, g.K, n8, n8, BK, W_BOX,
                     CU_TENSOR_MAP_SWIZZLE_64B) != 0)
    return cudaErrorInvalidValue;
  switch (epi) {
    case EPI_BIAS: return launch_tiles<BN, EPI_BIAS>(ta, tw, g, s);
    case EPI_BIAS_POS: return launch_tiles<BN, EPI_BIAS_POS>(ta, tw, g, s);
    case EPI_BIAS_GELU: return launch_tiles<BN, EPI_BIAS_GELU>(ta, tw, g, s);
    case EPI_GATED_RESID: return launch_tiles<BN, EPI_GATED_RESID>(ta, tw, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// A (M, K) bf16 and W (K, N8) bf16, N8 = N rounded up to a multiple of 8,
// both with zeros past their real columns (the wrapper pads them; K a
// multiple of 8 so that A's rows are 16-byte strides) and 16-byte aligned;
// a_is_bf16 must be 1 (the wrapper casts an f32 A once). The tile width
// follows N: 160 where it divides N or N is wide, else 96 or 64.
extern "C" int vit_gemm(const void* A, int a_is_bf16, const void* W, const float* bias, void* out,
                        const float* aux, long long aux_stride, const float* resid, void* save,
                        int M, int N, int K, int n_tok, int epi, void* stream) {
  if (!a_is_bf16 || M < 1 || N < 1 || K < 1 || K % 8 != 0 || n_tok < 1)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(W)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (epi == EPI_GATED_RESID && resid == nullptr) return (int)cudaErrorInvalidValue;
  const uintptr_t any8 = reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(aux) | reinterpret_cast<uintptr_t>(resid);
  const bool vec = N % 2 == 0 && aux_stride % 2 == 0 && (any8 & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(save) & 3) == 0;
  GemmArgs g{bias, out, aux, aux_stride, resid, static_cast<__nv_bfloat16*>(save), M, N, K, n_tok,
             vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = gemm_tile_n(N);
  return (int)(bn == 160 ? launch_gemm<160>(A, W, g, epi, s)
                         : bn == 96 ? launch_gemm<96>(A, W, g, epi, s)
                                    : launch_gemm<64>(A, W, g, epi, s));
}

extern "C" int vit_modln(const float* x, const float* shift, const float* scale,
                         long long mod_stride, void* out, int M, int H, int n_tok, float eps,
                         void* stream) {
  const int warps = 8;
  modln_kernel<<<(M + warps - 1) / warps, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, shift, scale, mod_stride, static_cast<__nv_bfloat16*>(out), M, H, n_tok, eps);
  return (int)cudaGetLastError();
}

namespace {

// The attention's CTA: three warpgroups (192 query rows) up to head dim 96,
// two (128 rows) above, where three would spill (each at its register cap
// of 168; two take 213-223 registers at d = 112-128). On the H100 three
// warpgroups read fastest at every serving shape measured, ds3's 450 tokens
// (three CTAs of 192 rows a head) included: every CTA of an (element, head)
// reads and converts that head's whole K and V, and taller CTAs do that
// fewer times.
template <int DP>
cudaError_t launch_attention(const float* qkv, const unsigned char* mask, __nv_bfloat16* ctx,
                             int B, int n, int H, int d, float scale, cudaStream_t st) {
  return vattn::launch_as<DP, (DP <= 96 ? 3 : 2)>(qkv, mask, ctx, B, n, H, d, scale, st);
}

}  // namespace

extern "C" int vit_attention(const float* qkv, const unsigned char* mask, void* ctx, int B,
                             int n_tok, int num_heads, int head_dim, float scale, void* stream) {
  if (B < 1 || n_tok < 1 || num_heads < 1 || head_dim < 1 || head_dim > 128 || B > 65535 ||
      num_heads > 65535)
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(ctx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
#define VIT_ATTN_CASE(k)                                                                    \
  case k:                                                                                   \
    return (int)launch_attention<16 * k>(qkv, mask, out, B, n_tok, num_heads, head_dim,     \
                                         scale, st);
    VIT_ATTN_CASE(1) VIT_ATTN_CASE(2) VIT_ATTN_CASE(3) VIT_ATTN_CASE(4)
    VIT_ATTN_CASE(5) VIT_ATTN_CASE(6) VIT_ATTN_CASE(7) VIT_ATTN_CASE(8)
#undef VIT_ATTN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
