// The slab descriptors and kernel arguments of the port's bf16 attention
// kernels (K6, flash_qkv_attention.cu; K8, vmem_attention.cu), and K6's
// backward kernels.
//
// The TPU kernel takes bf16 multiplicands with f32 accumulation
// (vit4hep_tpu/ops/flash_qkv_attention.py:225). Here every product of the
// backward runs on the bf16 tensor cores through WMMA 16x16x16 fragments
// with f32 accumulators; the probabilities before they enter a product and
// every row term stay in f32.
//
// Work split: a CTA is 4 warps; each warp owns 16 rows (queries, or keys in
// the dK/dV kernel) of one (batch, head), so every per-row statistic is
// warp-local. The other side streams through shared memory in 64-row tiles
// converted to bf16 on load (zero-filled past n and past the head dim). A
// warp's 16 x 64 score tile is stored to shared memory in f32 (WMMA's
// accumulator layout is opaque), transformed there lane by lane, and written
// back as a bf16 operand for the next product. Scores never reach device
// memory, and no (N, N) block is resident anywhere: shared memory is ~80-100
// KB per CTA at any N.
//
// Tensors are addressed as (batch, head, row, column) slabs with the column
// stride 1: separated (B, H, N, D) tensors, strided views of them, and the
// native (B, N, 3*H*D) qkv panel (a head's columns inside a 3*H*D-wide row)
// all fit one descriptor, so neither caller copies its layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace amma {

using namespace nvcuda;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WR = 16;             // rows of one warp
constexpr int ROWS = WR * WARPS;   // rows of one CTA
constexpr int KT = 64;             // rows of one streamed tile
constexpr int LDS = KT + 4;        // leading dim (floats) of a warp's f32 score tile
constexpr int LDP = KT + 8;        // leading dim (bf16) of a warp's bf16 operand tile
constexpr int MAX_HEAD_DIM = 128;
constexpr float MASKED = -1e30f;   // the TPU kernels' fill for a masked score

// element (b, h, row, col) at p[b * sb + h * sh + row * sn + col]
struct Slab {
  const float* p;
  long long sb, sh, sn;
};
struct OutSlab {
  float* p;
  long long sb, sh, sn;
};

struct Args {
  Slab q, k, v, g;       // inputs (g: the output's gradient)
  OutSlab o, dq, dk, dv;  // outputs
  Slab lse;              // the forward's log-sum-exp (column 0 of each row)
  OutSlab lse_out;
  Slab rt;               // the backward's row term (K6: delta; K8: from its dQ pass)
  OutSlab rt_out;
  const unsigned char* mask;  // shared (n, n) uint8, row-major, 1 = attend; or nullptr
  int n, d;
  float scale;
};

__device__ __forceinline__ const float* base(const Slab& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}
__device__ __forceinline__ float* base(const OutSlab& s, int b, int h) {
  return s.p + b * s.sb + h * s.sh;
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// may (query, key) attend: always without a mask; a query past n reads no byte
template <bool HAS_MASK>
__device__ __forceinline__ bool attends(int query, int key, int n, const unsigned char* mask) {
  return !HAS_MASK || query >= n || mask[(size_t)query * n + key] != 0;
}

// rows [row0, row0 + rows) of a head's slab (row stride ld) into a
// rows x (DP + 8) bf16 shared tile; zero past n and past d. All threads.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, const float* g, long long ld, int row0,
                                          int rows, int n, int d) {
  constexpr int LD = DP + 8;
  for (int idx = threadIdx.x; idx < rows * DP; idx += THREADS) {
    const int r = idx / DP, c = idx - r * DP, row = row0 + r;
    s[r * LD + c] = __float2bfloat16(row < n && c < d ? g[(long long)row * ld + c] : 0.f);
  }
}

// C (16 x KT f32, ld LDS) = A . B^T: A a warp's 16 x DP bf16 rows, B a
// KT x DP bf16 tile (both ld DP + 8)
template <int DP>
__device__ __forceinline__ void warp_abt(float* C, const __nv_bfloat16* A, const __nv_bfloat16* B) {
  constexpr int LD = DP + 8;
  Acc acc[KT / 16];
#pragma unroll
  for (int j = 0; j < KT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + kk, LD);
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, B + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < KT / 16; ++j)
    wmma::store_matrix_sync(C + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// acc (16 x DP) += P . V: P a warp's 16 x KT bf16 operand tile (ld LDP), V a
// KT x DP bf16 tile (ld DP + 8)
template <int DP>
__device__ __forceinline__ void warp_pv(Acc (&acc)[DP / 16], const __nv_bfloat16* P,
                                        const __nv_bfloat16* V) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < KT; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, P + kk, LDP);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, V + kk * LD + j * 16, LD);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(Acc (&acc)[DP / 16]) {
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
}

// a warp's 16 x DP accumulator through its f32 staging rows O (ld DP + 4)
// into rows [r0, r0 + 16) of an output slab (row stride ld): out = acc / div
// per row (div[r] = 1 for a plain store); rows past n are dropped
template <int DP>
__device__ __forceinline__ void warp_write(float* O, Acc (&acc)[DP / 16], float* out, long long ld,
                                           int r0, int n, int d, const float (&div)[WR]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(O + j * 16, acc[j], DP + 4, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    if (r0 + r >= n) break;
    float* orow = out + (long long)(r0 + r) * ld;
    for (int c = lane; c < d; c += 32) orow[c] = O[r * (DP + 4) + c] / div[r];
  }
  __syncwarp();
}

// shared memory of the backward kernels (the dK/dV kernel's layout; the dQ
// kernel uses one bf16 operand tile per warp and no statistics of it): the
// warps' own rows (two operands), the streamed tile (two operands), two f32
// score tiles and two bf16 operand tiles per warp, the streamed rows' two
// statistics
template <int DP>
constexpr size_t bwd_smem() {
  return (size_t)4 * ROWS * (DP + 8) * 2 + (size_t)2 * ROWS * LDS * 4 +
         (size_t)2 * ROWS * LDP * 2 + (size_t)2 * KT * 4;
}

// dQ over key tiles for 16 query rows per warp (`_bwd_dq_kernel`,
// vit4hep_tpu/ops/flash_qkv_attention.py:119): p = exp(s - lse) on the mask
// and 0 off it, dp = dO . V^T, ds = p (dp - delta) * scale with delta =
// rowsum(dO * O) (:150), dQ = ds . K on bf16 ds.
template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DP + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Qs + ROWS * LD;
  __nv_bfloat16* Ks = Gs + ROWS * LD;
  __nv_bfloat16* Vs = Ks + KT * LD;
  float* S = reinterpret_cast<float*>(Vs + KT * LD);
  float* D = S + ROWS * LDS;
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(D + ROWS * LDS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * ROWS, r0 = q0 + warp * WR;
  const int n = a.n, d = a.d;
  float* Sw = S + warp * WR * LDS;
  float* Dw = D + warp * WR * LDS;
  __nv_bfloat16* Pw = Ps + warp * WR * LDP;
  const __nv_bfloat16* Qw = Qs + warp * WR * LD;
  const __nv_bfloat16* Gw = Gs + warp * WR * LD;
  const float* kb = base(a.k, b, h);
  const float* vb = base(a.v, b, h);

  load_rows<DP>(Qs, base(a.q, b, h), a.q.sn, q0, ROWS, n, d);
  load_rows<DP>(Gs, base(a.g, b, h), a.g.sn, q0, ROWS, n, d);
  float lse[WR], rt[WR];
  const float* lb = base(a.lse, b, h);
  const float* rb = base(a.rt, b, h);
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    lse[r] = r0 + r < n ? lb[(long long)(r0 + r) * a.lse.sn] : 0.f;
    rt[r] = r0 + r < n ? rb[(long long)(r0 + r) * a.rt.sn] : 0.f;
  }

  Acc dq[DP / 16];
  zero<DP>(dq);
  for (int k0 = 0; k0 < n; k0 += KT) {
    __syncthreads();
    load_rows<DP>(Ks, kb, a.k.sn, k0, KT, n, d);
    load_rows<DP>(Vs, vb, a.v.sn, k0, KT, n, d);
    __syncthreads();
    warp_abt<DP>(Sw, Qw, Ks);
    warp_abt<DP>(Dw, Gw, Vs);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < WR; ++r) {
#pragma unroll
      for (int c = lane; c < KT; c += 32) {
        const int key = k0 + c, query = r0 + r;
        float ds = 0.f;
        if (key < n && query < n) {
          const bool on = attends<HAS_MASK>(query, key, n, a.mask);
          const float s = Sw[r * LDS + c] * a.scale;
          const float p = on ? expf(s - lse[r]) : 0.f;
          ds = p * (Dw[r * LDS + c] - rt[r]) * a.scale;
        }
        Pw[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_pv<DP>(dq, Pw, Ks);
  }

  __syncthreads();  // every warp is done with the tiles: its output staging reuses them
  float* Ow = reinterpret_cast<float*>(Ks) + warp * WR * (DP + 4);
  float one[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) one[r] = 1.f;
  warp_write<DP>(Ow, dq, base(a.dq, b, h), a.dq.sn, r0, n, d, one);
}

// dK and dV over query tiles for 16 key rows per warp (`_bwd_dkv_kernel`,
// vit4hep_tpu/ops/flash_qkv_attention.py:164): the transposed scores s^T =
// K . Q^T and dp^T = V . dO^T, p and ds as in bwd_dq_kernel from the query
// tile's lse and delta, dV += p^T . dO and dK += ds^T . Q on bf16 p and ds.
// Every key row is written once: no atomics.
template <int DP, bool HAS_MASK>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DP + 8;
  __nv_bfloat16* Kc = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vc = Kc + ROWS * LD;
  __nv_bfloat16* Qt = Vc + ROWS * LD;
  __nv_bfloat16* Gt = Qt + KT * LD;
  float* S = reinterpret_cast<float*>(Gt + KT * LD);
  float* D = S + ROWS * LDS;
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(D + ROWS * LDS);
  __nv_bfloat16* DSs = Ps + ROWS * LDP;
  float* lse_t = reinterpret_cast<float*>(DSs + ROWS * LDP);
  float* rt_t = lse_t + KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * ROWS, r0 = k0 + warp * WR;
  const int n = a.n, d = a.d;
  float* Sw = S + warp * WR * LDS;
  float* Dw = D + warp * WR * LDS;
  __nv_bfloat16* Pw = Ps + warp * WR * LDP;
  __nv_bfloat16* DSw = DSs + warp * WR * LDP;
  const __nv_bfloat16* Kw = Kc + warp * WR * LD;
  const __nv_bfloat16* Vw = Vc + warp * WR * LD;
  const float* qb = base(a.q, b, h);
  const float* gb = base(a.g, b, h);
  const float* lb = base(a.lse, b, h);
  const float* rb = base(a.rt, b, h);

  load_rows<DP>(Kc, base(a.k, b, h), a.k.sn, k0, ROWS, n, d);
  load_rows<DP>(Vc, base(a.v, b, h), a.v.sn, k0, ROWS, n, d);
  Acc dk[DP / 16], dv[DP / 16];
  zero<DP>(dk);
  zero<DP>(dv);
  for (int q0 = 0; q0 < n; q0 += KT) {
    __syncthreads();
    load_rows<DP>(Qt, qb, a.q.sn, q0, KT, n, d);
    load_rows<DP>(Gt, gb, a.g.sn, q0, KT, n, d);
    if (threadIdx.x < KT) {
      const int q = q0 + threadIdx.x;
      lse_t[threadIdx.x] = q < n ? lb[(long long)q * a.lse.sn] : 0.f;
      rt_t[threadIdx.x] = q < n ? rb[(long long)q * a.rt.sn] : 0.f;
    }
    __syncthreads();
    warp_abt<DP>(Sw, Kw, Qt);  // s^T: [key][query]
    warp_abt<DP>(Dw, Vw, Gt);  // dp^T
    __syncwarp();
#pragma unroll
    for (int r = 0; r < WR; ++r) {
#pragma unroll
      for (int c = lane; c < KT; c += 32) {
        const int key = r0 + r, query = q0 + c;
        float p = 0.f, ds = 0.f;
        if (key < n && query < n) {
          const bool on = attends<HAS_MASK>(query, key, n, a.mask);
          const float s = Sw[r * LDS + c] * a.scale;
          p = on ? expf(s - lse_t[c]) : 0.f;
          ds = p * (Dw[r * LDS + c] - rt_t[c]) * a.scale;
        }
        Pw[r * LDP + c] = __float2bfloat16(p);
        DSw[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_pv<DP>(dv, Pw, Gt);
    warp_pv<DP>(dk, DSw, Qt);
  }

  __syncthreads();  // every warp is done with the query tiles: the staging reuses them
  float* Ow = reinterpret_cast<float*>(Qt) + warp * WR * (DP + 4);
  float one[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) one[r] = 1.f;
  warp_write<DP>(Ow, dk, base(a.dk, b, h), a.dk.sn, r0, n, d, one);
  warp_write<DP>(Ow, dv, base(a.dv, b, h), a.dv.sn, r0, n, d, one);
}

inline bool bad_dims(int B, int n, int H, int d) {
  return B < 1 || n < 1 || H < 1 || d < 1 || d > MAX_HEAD_DIM || B > 65535 || H > 65535;
}

// launch one kernel over (query or key tiles, heads, batch) with its dynamic
// shared memory
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Args& a, int B, int H, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.n + ROWS - 1) / ROWS, H, B), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr ? launch(bwd_dq_kernel<DP, true>, bwd_smem<DP>(), a, B, H, st)
                           : launch(bwd_dq_kernel<DP, false>, bwd_smem<DP>(), a, B, H, st);
}

template <int DP>
cudaError_t launch_dkv(const Args& a, int B, int H, cudaStream_t st) {
  return a.mask != nullptr ? launch(bwd_dkv_kernel<DP, true>, bwd_smem<DP>(), a, B, H, st)
                           : launch(bwd_dkv_kernel<DP, false>, bwd_smem<DP>(), a, B, H, st);
}

}  // namespace amma

// Returns, as an int, the value of the expression for the padded head dim
// DP = 16 * ceil(d / 16) (a constexpr named DP inside the expression), or
// cudaErrorInvalidValue past MAX_HEAD_DIM.
#define AMMA_DISPATCH(d, ...)                                         \
  switch (((d) + 15) / 16) {                                          \
    case 1: { constexpr int DP = 16; return (int)(__VA_ARGS__); }     \
    case 2: { constexpr int DP = 32; return (int)(__VA_ARGS__); }     \
    case 3: { constexpr int DP = 48; return (int)(__VA_ARGS__); }     \
    case 4: { constexpr int DP = 64; return (int)(__VA_ARGS__); }     \
    case 5: { constexpr int DP = 80; return (int)(__VA_ARGS__); }     \
    case 6: { constexpr int DP = 96; return (int)(__VA_ARGS__); }     \
    case 7: { constexpr int DP = 112; return (int)(__VA_ARGS__); }    \
    case 8: { constexpr int DP = 128; return (int)(__VA_ARGS__); }    \
    default: return (int)cudaErrorInvalidValue;                       \
  }
