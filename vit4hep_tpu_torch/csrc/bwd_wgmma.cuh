// K5b's two products on wgmma and TMA, for Hopper (sm_90a): the activation
// gradients (NT) and the split-K weight gradients (TN) of one DiT block's
// backward (vit_backward.cu binds them).
//
// Replaces the products of the TPU kernel `fused_dit_block_bwd_res`
// (vit4hep_tpu/ops/fused_dit_block.py:745; body `_bwd_res_kernel` :623,
// pallas_call :808), and through it K5c's `fused_dit_block_bwd` (:1204,
// pallas_call :1261): bf16 multiplicands, f32 accumulation.
//
//  - nt_wgmma_kernel<MODE>: out (M, N) f32 = A (M, K) W^T, with W the
//    (N, K) Dense weight as stored (in = N, out = K), optionally times
//    gelu'(a1) (a1 (M, N) bf16, or f32 when recomputed). W as stored is the
//    K-major B operand, wgmma's own layout. Optional bf16 side outputs from
//    the accumulator registers: `save` = bf16(out) (da1, the next NT's A and
//    dW1's B) and `gelu_save` = bf16(gelu(a1)) (dW2's A: formed once here,
//    not per column tile of the weight gradient).
//  - tn_wgmma_kernel: dW (K, N) = A^T dY over the rows of one of S chunks
//    of the M rows (split-K), into a (S, K, N) f32 workspace that
//    wgrad_reduce sums in order (no atomics: deterministic). Both operands
//    are MN-major: A^T is A (M, K) as stored, read with the transpose bit of
//    A, and dY (M, N) as stored with the transpose bit of B, each in boxes of
//    64 rows x 32 columns with the 64-byte swizzle (the layout the forward
//    GEMM proved for its W). The bias gradient is the column sums of the f32
//    dY (never of its bf16 copy): the producer warpgroup's three idle warps
//    sum them while the consumers run the products, each unit (split s, row
//    tile r, column tile c) the r-th of R = row tiles parts of chunk s's rows
//    for tile c's columns, into a (S * R, N) workspace.
//
// Shape of both (as the forward GEMM, vit_forward.cu): one producer thread
// keeps STAGES stages of A and B boxes in flight by TMA, signalled by
// mbarriers (full: bytes landed; empty: every consumer done); CONS consumer
// warpgroups of 64 rows each run wgmma.mma_async m64nBNk16 with f32
// accumulators in registers; a persistent grid walks the units, so the
// producer fills the next unit's stages during this unit's epilogue. TMA
// reads zeros past the tensors' edges (rows past M, the K tail); every
// operand row must be a multiple of 16 bytes (the wrappers pad K and N to 8).
//
// What bounds them on this card: at ds2 (M = 8,640 rows, K and N in 480,
// 1440, 1920) a block's four NT products are 47.8 GFLOP (0.048 ms at the
// bf16 peak) against 0.29 GB of bf16 operands, f32 outputs and the GELU
// product's a1 and saves (0.089 ms): bytes; the four TN products the same
// operations against 0.24 GB (A in bf16, dY once in f32, the partials;
// 0.072 ms; dY's bf16 copy is this design's, not the function's). Their
// tiles are chosen for the 132 SMs: NT 192 x 96 (at ds2, 225 and 900 tiles
// fill the SMs' turns better than 192 x 160's 135 and 540, and ran faster
// on the H100), TN 128 x 160 tiles times S row chunks, S = 132 // tiles.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace kbw {

constexpr int BK = 64, STAGES = 4;
constexpr int BOX = 32;                     // MN-major boxes: BK rows x 32 columns (64 B)
constexpr int BOX_BYTES = BK * BOX * 2;
constexpr int NT_CONS = 3, TN_CONS = 2;     // consumer warpgroups: NT 192 rows, TN 128
constexpr int NT_BN = 96, TN_BN = 160;       // tile widths
constexpr int SUM_THREADS = 96;             // the producer warpgroup's warps 1-3

enum Mode { NT_PLAIN = 0, NT_DGELU_BF16 = 1, NT_DGELU_F32 = 2, TN = 3 };

template <int CONS>
__host__ __device__ constexpr int a_bytes() {
  return 64 * CONS * BK * 2;
}
template <int CONS, int BN>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<CONS>() + BN * BK * 2;
}
// the ring, its barriers, the column sums' staging, alignment slack
template <int CONS, int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)STAGES * stage_bytes<CONS, BN>() + 2 * STAGES * sizeof(uint64_t) +
         4 * BN * sizeof(float) + 1024;
}
static_assert(smem_bytes<NT_CONS, NT_BN>() <= 232448 && smem_bytes<TN_CONS, TN_BN>() <= 232448,
              "the rings fit a CTA's shared memory");

struct Args {
  float* out;                // NT: (M, N); TN: the (S, K, N) partials
  const void* aux;           // NT DGELU: a1 (M, N), bf16 or f32
  __nv_bfloat16* save;       // NT: bf16(out), or nullptr
  __nv_bfloat16* gelu_save;  // NT DGELU: bf16(gelu(a1)), or nullptr
  const float* dy;           // TN: the f32 dY (M, N) whose column sums are the bias gradient
  float* cs;                 // TN: (S * R, N) column-sum partials
  int M, N, K;               // NT: out (M, N) = A (M, K) W^T; TN: (K, N) = A^T dY over M rows
  int S, chunk;              // TN: S chunks of `chunk` rows (a multiple of BK)
  bool vec;                  // pairs of columns as 8-byte (f32) / 4-byte (bf16) accesses
  bool vec4;                 // TN: dY's columns as float4
};

// ------------------------------------------------------------- wgmma (ss)
// m64nNk16, bf16 x bf16 -> f32, both operands from shared memory, TA / TB
// the transpose bits (1 = MN-major)
#define KBW_F8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define KBW_D48 KBW_F8(0), KBW_F8(8), KBW_F8(16), KBW_F8(24), KBW_F8(32), KBW_F8(40)
#define KBW_D80 KBW_D48, KBW_F8(48), KBW_F8(56), KBW_F8(64), KBW_F8(72)

template <int N, int TA, int TB>
struct MmaSS;

template <int TA, int TB>
struct MmaSS<96, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : KBW_D48
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct MmaSS<160, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, %83, %84;\n}\n"
        : KBW_D80
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

#undef KBW_F8
#undef KBW_D48
#undef KBW_D80

// ------------------------------------------------------------- epilogues
// the tanh GELU (the forward's, vit_forward.cu) and its derivative, from
// one tanh
__device__ __forceinline__ float2 gelu_and_grad(float v) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (v + 0.044715f * v * v * v));
  const float d =
      0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * v * v);
  return make_float2(0.5f * v * (1.f + t), d);
}

// columns (col, col + 1) of a row of p; the second is read only below n
__device__ __forceinline__ float2 load_pair(const float* p, int col, int n, bool vec) {
  if (vec) return *reinterpret_cast<const float2*>(p + col);
  return make_float2(p[col], col + 1 < n ? p[col + 1] : 0.f);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p, int col, int n, bool vec) {
  if (vec) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + col));
  return make_float2(__bfloat162float(p[col]), col + 1 < n ? __bfloat162float(p[col + 1]) : 0.f);
}

__device__ __forceinline__ void store_pair(float* p, int col, int n, bool vec, float v0,
                                           float v1) {
  if (vec) {
    *reinterpret_cast<float2*>(p + col) = make_float2(v0, v1);
  } else {
    p[col] = v0;
    if (col + 1 < n) p[col + 1] = v1;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int col, int n, bool vec, float v0,
                                           float v1) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[col] = __float2bfloat16(v0);
    if (col + 1 < n) p[col + 1] = __float2bfloat16(v1);
  }
}

// a consumer's 64 x BN accumulators: thread (warp w, lane l) holds rows row0
// and row0 + 8 (row0 = tile row + 16 w + l / 4), columns col0 + 8 j + {0, 1}
// (col0 = tile column + 2 (l % 4)); rows below `rows` (NT: M; TN: K) and
// columns below N are stored into `out` (row stride N). The GELU
// derivative's a1 loads of EPI_GROUP column pairs are issued before their
// stores, so that their latencies overlap.
constexpr int EPI_GROUP = 4;

template <int BN, int MODE>
__device__ __forceinline__ void epilogue(const Args& g, float* out, int rows,
                                         const float (&acc)[BN / 2], int row0, int col0) {
  using Aux = typename std::conditional<MODE == NT_DGELU_F32, float, __nv_bfloat16>::type;
  constexpr bool DGELU = MODE == NT_DGELU_BF16 || MODE == NT_DGELU_F32;
  static_assert((BN / 8) % EPI_GROUP == 0, "whole groups of column pairs");
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_GROUP) {
    float2 a[EPI_GROUP][2];
    if (DGELU) {
#pragma unroll
      for (int c = 0; c < EPI_GROUP; ++c) {
        const int col = col0 + 8 * (j0 + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          a[c][h] = row < rows && col < g.N
                        ? load_pair(static_cast<const Aux*>(g.aux) + (size_t)row * g.N, col,
                                    g.N, g.vec)
                        : make_float2(0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < EPI_GROUP; ++c) {
      const int j = j0 + c, col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= rows || col >= g.N) continue;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const size_t r = (size_t)row * g.N;
        if (DGELU) {
          const float2 e0 = gelu_and_grad(a[c][h].x), e1 = gelu_and_grad(a[c][h].y);
          v0 *= e0.y;
          v1 *= e1.y;
          if (g.gelu_save != nullptr) store_pair(g.gelu_save + r, col, g.N, g.vec, e0.x, e1.x);
        }
        store_pair(out + r, col, g.N, g.vec, v0, v1);
        if (MODE != TN && g.save != nullptr) store_pair(g.save + r, col, g.N, g.vec, v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------- the units
// unit u of the persistent walk: row tile tr and column tile tc (columns
// fastest), TN's split s slowest; its reduction rows [red0, red1)
struct Unit {
  int s, tr, tc, red0, red1;
};

template <int CONS, int BN, bool IS_TN>
__device__ __forceinline__ Unit unit_of(const Args& g, int u, int col_tiles, int tiles) {
  Unit w;
  w.s = IS_TN ? u / tiles : 0;
  const int t = u % tiles;
  w.tr = t / col_tiles;
  w.tc = t % col_tiles;
  w.red0 = IS_TN ? w.s * g.chunk : 0;
  w.red1 = IS_TN ? min(g.M, w.red0 + g.chunk) : g.K;
  return w;
}

__device__ __forceinline__ void sum_bar() {
  asm volatile("bar.sync 1, %0;" ::"n"(SUM_THREADS) : "memory");
}

// TN's bias gradient: the f32 column sums of dY over unit w's rows (part
// w.tr of R of chunk w.s) for tile w.tc's columns, by the SUM_THREADS
// threads (t = 0 .. 95): BN / 4 column quads x G row groups, the groups'
// partials added in order through shared memory (deterministic)
template <int BN>
__device__ __forceinline__ void column_sums(const Args& g, const Unit& w, int R, float* stage,
                                            int t) {
  constexpr int Q = BN / 4, G = SUM_THREADS / Q;
  static_assert(BN % 4 == 0 && G >= 1, "column quads");
  const int len = w.red1 - w.red0, sub = (len + R - 1) / R;
  const int ra = w.red0 + w.tr * sub, rb = min(w.red1, ra + sub);
  const int grp = t / Q, q = t % Q, col = w.tc * BN + 4 * q;
  if (grp < G) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g.vec4 && col + 3 < g.N) {
      // LOADS rows in flight a thread: the sums are bound by the latency of
      // these reads, not by their bytes
      constexpr int LOADS = 16;
      const float* p = g.dy + (size_t)(ra + grp) * g.N + col;
      const size_t step = (size_t)G * g.N;
      int r = ra + grp;
      for (; r + (LOADS - 1) * G < rb; r += LOADS * G, p += LOADS * step) {
        float4 x[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i)
          x[i] = __ldcs(reinterpret_cast<const float4*>(p + i * step));
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          v.x += x[i].x;
          v.y += x[i].y;
          v.z += x[i].z;
          v.w += x[i].w;
        }
      }
      for (; r < rb; r += G, p += step) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
    } else {
      for (int r = ra + grp; r < rb; r += G) {
        const float* p = g.dy + (size_t)r * g.N;
        if (col < g.N) v.x += p[col];
        if (col + 1 < g.N) v.y += p[col + 1];
        if (col + 2 < g.N) v.z += p[col + 2];
        if (col + 3 < g.N) v.w += p[col + 3];
      }
    }
    *reinterpret_cast<float4*>(stage + grp * BN + 4 * q) = v;
  }
  sum_bar();
  for (int c = t; c < BN; c += SUM_THREADS) {
    if (w.tc * BN + c >= g.N) continue;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) v += stage[k * BN + c];
    g.cs[((size_t)w.s * R + w.tr) * g.N + w.tc * BN + c] = v;
  }
  sum_bar();  // the staging is free for the next unit
}

// the body of both kernels; tma_a / tma_b: NT A (M, K8) K-major in BK x 64
// * CONS boxes and W (N, K8) in BK x BN boxes, 128-byte swizzle; TN A (M,
// K8) and dY (M, N8) in BK-row x 32-column boxes, 64-byte swizzle
template <int CONS, int BN, int MODE>
__device__ __forceinline__ void body(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                     const Args& g) {
  constexpr bool IS_TN = MODE == TN;
  constexpr int BM = 64 * CONS, A_BYTES = a_bytes<CONS>(), STAGE = stage_bytes<CONS, BN>();
  static_assert(BN % BOX == 0 && BN % 16 == 0 && BN <= 256, "B in whole 32-column boxes");
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "stages keep the swizzle period");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  float* sums = reinterpret_cast<float*>(empty + STAGES);
  const int wg = threadIdx.x / 128;
  const int rows = IS_TN ? g.K : g.M;  // the output's rows
  const int col_tiles = (g.N + BN - 1) / BN, row_tiles = (rows + BM - 1) / BM;
  const int tiles = row_tiles * col_tiles, units = tiles * (IS_TN ? g.S : 1);
  const int k8 = (g.K + 7) / 8 * 8, n8 = (g.N + 7) / 8 * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], CONS * 128);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONS) {
    if (threadIdx.x == CONS * 128) {  // the producer: one thread keeps the ring full
      int stage = 0;
      unsigned phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<CONS, BN, IS_TN>(g, u, col_tiles, tiles);
        const int r0 = w.tr * BM, n0 = w.tc * BN;
        // TN: boxes wholly past the padded edge are not loaded (their rows of
        // A^T and columns of dY feed only outputs that are never stored)
        const int na = IS_TN ? min(BM / BOX, (k8 - r0 + BOX - 1) / BOX) : 1;
        const int nb = IS_TN ? min(BN / BOX, (n8 - n0 + BOX - 1) / BOX) : 1;
        const unsigned bytes = IS_TN ? (unsigned)(na + nb) * BOX_BYTES : (unsigned)STAGE;
        for (int k = w.red0; k < w.red1; k += BK) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE;
          hop::mbar_expect_tx(&full[stage], bytes);
          if (IS_TN) {
            for (int i = 0; i < na; ++i)
              hop::tma_load_2d(st + i * BOX_BYTES, tma_a, &full[stage], r0 + i * BOX, k);
            for (int j = 0; j < nb; ++j)
              hop::tma_load_2d(st + A_BYTES + j * BOX_BYTES, tma_b, &full[stage], n0 + j * BOX,
                               k);
          } else {
            hop::tma_load_2d(st, tma_a, &full[stage], k, r0);
            hop::tma_load_2d(st + A_BYTES, tma_b, &full[stage], k, n0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (IS_TN && threadIdx.x >= CONS * 128 + 32) {  // warps 1-3: the bias gradient
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        column_sums<BN>(g, unit_of<CONS, BN, IS_TN>(g, u, col_tiles, tiles), row_tiles, sums,
                        threadIdx.x - CONS * 128 - 32);
    }
  } else {
    // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each output tile
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of<CONS, BN, IS_TN>(g, u, col_tiles, tiles);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      hop::fence_regs(acc);
      int prev = 0;
      for (int k = w.red0; k < w.red1; k += BK) {
        hop::mbar_wait(&full[stage], phase);
        const uint32_t st = hop::smem_u32(smem + stage * STAGE);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (IS_TN)  // both MN-major: +16 rows of 64 B a k16 step; the next 32 columns a box on
            MmaSS<BN, 1, 1>::run(
                acc, hop::desc(st + wg * 2 * BOX_BYTES + kk * 1024, BOX_BYTES, 512, hop::SW64),
                hop::desc(st + A_BYTES + kk * 1024, BOX_BYTES, 512, hop::SW64), 1);
          else  // both K-major, 128-byte rows: +32 B a k16 step
            MmaSS<BN, 0, 0>::run(
                acc, hop::desc(st + wg * 64 * 128 + kk * 32, 16, 1024, hop::SW128),
                hop::desc(st + A_BYTES + kk * 32, 16, 1024, hop::SW128), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (k > w.red0) hop::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[prev]);
      float* out = IS_TN ? g.out + (size_t)w.s * g.K * g.N : g.out;
      epilogue<BN, MODE>(g, out, rows, acc, w.tr * BM + wg * 64 + warp * 16 + lane / 4,
                         w.tc * BN + 2 * (lane % 4));
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(128 * (NT_CONS + 1), 1)
    nt_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b, Args g) {
  body<NT_CONS, NT_BN, MODE>(&tma_a, &tma_b, g);
}

__global__ void __launch_bounds__(128 * (TN_CONS + 1), 1)
    tn_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b, Args g) {
  body<TN_CONS, TN_BN, TN>(&tma_a, &tma_b, g);
}

// one persistent CTA an SM (at most one per unit)
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, long long units,
                   const CUtensorMap& ta, const CUtensorMap& tb, const Args& g, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, threads, smem, st>>>(ta, tb, g);
  return cudaGetLastError();
}

}  // namespace kbw
