// Binned rational-quadratic spline inverse + log-determinant for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_spline_inv_kernel` of
// `fused_binned_rqs_inverse` (vit4hep_tpu/ops/fused_spline.py:55,
// pallas_call at :204): for y (B, D) and raw subnet outputs theta (B, D, P),
// P = 3 * bins + (identity_tails ? 0 : 1), the shifted-softplus (or
// softmax) constrain, the optional tanh domain clamping, the knot
// accumulation, the searchsorted over the bins + 1 y-knots and the bin solve
// (Citardauq root, two Newton steps), with affine tails outside the domain.
// Writes x (B, D) and logdet (B,) = -sum_D log dy/dx.
//
// What bounds it on this card: theta is read once (P floats per scalar, 103
// MB at the ds2 cINN shape (256, 3240, 31)), y read and x written once: the
// bytes take 0.0327 ms at the HBM rate (0.2043 at ds3, (256, 20250, 31)).
// The arithmetic came close to that: the earlier kernel's accurate expf /
// log1pf (29 softplus a scalar) and IEEE divides compiled to 2,824 SASS
// instructions, 822 of them FFMA, and each CTA loaded its tile, then
// computed with no bytes in flight, so its time was near the sum of the
// two (0.075 / 0.47 ms). The unit loop below issues 884 instructions (72 on
// the SFU) a consumer warp: 0.022 ms of issue slots at ds2 at 1980 MHz,
// under the loads but for a CTA's first and last unit.
//
// Design:
//  - a flat work list: the B * D scalars in units of T = 128 consecutive
//    scalars of the flattened index (a unit may span rows). T is a multiple
//    of 4, so every unit's theta slice (T * P floats) and y slice start on
//    16 bytes relative to their tensor's base at any D (on 512 bytes for
//    theta at P = 31); a base that is not on 16 bytes (a contiguous view at
//    a 4-byte offset) is read from the 16-byte boundary below it and the
//    stage is entered at that offset. 64-bit indices, no grid dimension per
//    row: any batch.
//  - persistent CTAs, as many as fit on the card, each taking a contiguous
//    chunk of whole units (chunks cut at any multiple of 4 scalars balance
//    the CTAs better but start the copies off 512 bytes: 10-16% slower);
//    one producer thread keeps a ring of STAGES stages full with two
//    `cp.async.bulk` copies a unit (theta's and y's slices, rounded out to
//    16 bytes: a 16-byte granule never crosses a page), completing on the
//    stage's full mbarrier; 128 consumer threads compute one scalar each
//    and free the stage on its empty mbarrier as soon as they have read it.
//    Loads run under the arithmetic of the stages before them. The number
//    of stages and of CTAs an SM barely matters (2-8 stages, 2-6 CTAs:
//    within 2%): what counts is that every CTA keeps its copies going while
//    it computes.
//  - fewer instructions per scalar: the softplus as ln 2 * log2(1 + 2^(-|v|
//    log2 e)) + max(v, 0) on the SFU (ex2.approx, lg2.approx), the log as
//    lg2.approx, and every divide whose denominator is positive by
//    construction (bin width, the Newton denominators, the tails' slope,
//    the softmax sums) as a multiply by rcp.approx; chip_smoke.py's TOL
//    comment bounds their error. Knots and derivatives stay in registers,
//    relative to the domain's corner (the bin count, the branch and the
//    clamping are template parameters; the active bin is selected with
//    predicated moves); each thread reads its P parameters from shared
//    memory at stride P (odd for the shipped affine tails: the 32 lanes of
//    a warp hit 32 banks). At D >= T a unit meets at most two rows, and the
//    row arithmetic takes compares instead of divisions.
//  - one launch, deterministic: the log-derivatives of a unit are summed by
//    row segment (a segmented suffix scan in each warp, then the warps in
//    order), and a row's segments in unit order through a carry that
//    thread 0 keeps across its chunk. A row inside one chunk writes its
//    logdet at once. A row that spans chunks (at most 2 per CTA: the
//    chunk's head and tail rows) gets one partial per CTA, partial[CTA +
//    row], stored with the launch's epoch in one 64-bit word, no fence.
//    Each CTA counts its head and tail rows with an atomic when it starts;
//    the CTA that completes a row's count has a warp wait at its end for
//    the row's partials (each from a CTA that has started, so its store
//    comes), add them in CTA order and reset the count. A count per unit
//    instead (an atomic a unit, up to 159 CTAs on one row's counter at
//    ds3) took 0.44 ms at ds3 against 0.27 without it; a second launch
//    that adds per-unit partials, ~3 us. The order depends on the grid (the
//    card's SM count and the occupancy), never on which CTA ran first: two
//    launches give the same bits. The counts (`rows_done`) are zero on
//    entry and left zero.
//
// Registers and shared memory: 79 registers for the shipped
// binned_rqs_inverse_kernel<10, false, false>, no spills at any
// instantiation (the -Xptxas -v report in _build/binned_rqs.log); 1,152
// bytes of static shared memory and STAGES x 16,416 bytes of ring at P =
// 31, 3 CTAs an SM.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace k4 {

constexpr int T = 128;                // scalars per unit, one per consumer thread
constexpr int LOG_T = 7;
constexpr int THREADS = T + 32;       // the consumers and the producer warp
constexpr int STAGES = 4;
constexpr int Y_REGION = T * 4 + 16;  // a stage's y slice, with room for a 16-byte lead
constexpr float LOG_E_MINUS_1 = 0.5413248546129181f;  // log(e - 1): softplus(0 + it) = 1
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct SplineArgs {
  const float* y;
  const float* theta;
  float* x;
  float* logdet;
  unsigned long long* partial;  // (>= G + B): CTA b's sum for a row r that spans
                                //   CTAs, at b + r, tagged with `epoch`
  int* rows_done;               // (B): the CTAs of a row counted so far; zero
                                //   on entry and on exit
  long long n;                  // B * D scalars
  long long units;              // ceil(n / T)
  int D, P, stage_bytes;
  int epoch;                    // this launch's tag, != every earlier tag in `partial`
  float min_w, min_h, left0, bottom0, default_width, xshift, yshift, clamp;
};

// ------------------------------------------------------------- the SFU forms
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// jax.nn.softplus, logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaf(LN2, lg2(1.f + ex2(-fabsf(v) * LOG2E)), fmaxf(v, 0.f));
}

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// ------------------------------------------------------------ one scalar
template <int BINS, bool IDENTITY, bool CLAMP>
__device__ __forceinline__ void spline_inverse(const float* th, float yv, const SplineArgs& a,
                                               float& xo, float& logj) {
  // the knots relative to the domain's lower-left corner (left, bottom):
  // the spline's inverse is the same in any frame, and y is moved into this one
  float kx[BINS + 1], ky[BINS + 1], dv[BINS + 1];
  float left, bottom;
  constexpr int DSTART = IDENTITY ? 2 * BINS + 1 : 2 * BINS + 2;
  kx[0] = 0.f;
  ky[0] = 0.f;
  if (IDENTITY) {
    float tw = a.default_width * softplus(th[2 * BINS] + LOG_E_MINUS_1);
    if (CLAMP) tw = a.clamp * tanhf(tw / a.clamp);
    left = -0.5f * tw;
    bottom = -0.5f * tw;
    float wmax = th[0], hmax = th[BINS];
#pragma unroll
    for (int k = 1; k < BINS; ++k) {
      wmax = fmaxf(wmax, th[k]);
      hmax = fmaxf(hmax, th[BINS + k]);
    }
    float we[BINS], he[BINS];
    float ws = 0.f, hs = 0.f;
#pragma unroll
    for (int k = 0; k < BINS; ++k) {
      we[k] = ex2((th[k] - wmax) * LOG2E);
      he[k] = ex2((th[BINS + k] - hmax) * LOG2E);
      ws += we[k];
      hs += he[k];
    }
    const float wn = tw * rcp(ws), hn = tw * rcp(hs);
    kx[1] = we[0] * wn;
    ky[1] = he[0] * hn;
#pragma unroll
    for (int k = 1; k < BINS; ++k) {
      kx[k + 1] = kx[k] + we[k] * wn;
      ky[k + 1] = ky[k] + he[k] * hn;
    }
  } else {
    bottom = th[2 * BINS] + a.bottom0;
    left = th[2 * BINS + 1] + a.left0;
    kx[1] = a.min_w + softplus(th[0] + a.xshift);
    ky[1] = a.min_h + softplus(th[BINS] + a.yshift);
#pragma unroll
    for (int k = 1; k < BINS; ++k) {
      kx[k + 1] = kx[k] + (a.min_w + softplus(th[k] + a.xshift));
      ky[k + 1] = ky[k] + (a.min_h + softplus(th[BINS + k] + a.yshift));
    }
    if (CLAMP) {  // rescale the domain to clamp * tanh(extent / clamp)
      const float wr = a.clamp * tanhf(kx[BINS] / a.clamp) / kx[BINS];
      const float hr = a.clamp * tanhf(ky[BINS] / a.clamp) / ky[BINS];
#pragma unroll
      for (int k = 1; k <= BINS; ++k) {
        kx[k] *= wr;
        ky[k] *= hr;
      }
      left *= wr;
      bottom *= hr;
    }
  }
  // the tails' slope = heights / widths; the boundary derivatives equal it
  const float scale = ky[BINS] * rcp(kx[BINS]);
  const float shift = bottom - scale * left;
  dv[0] = scale;
  dv[BINS] = scale;
#pragma unroll
  for (int k = 1; k < BINS; ++k) dv[k] = softplus(th[DSTART + k - 1] + LOG_E_MINUS_1);

  const float yr = yv - bottom;
  const bool inside = (yr > 0.f) && (yr <= ky[BINS]);
  const float ys = fminf(fmaxf(yr, 0.f), ky[BINS]);
  float xk = kx[0], xkp = kx[1], yk = ky[0], ykp = ky[1], dk = dv[0], dkp = dv[1];
#pragma unroll
  for (int k = 1; k < BINS; ++k) {
    if (ys >= ky[k]) {  // the largest k with ky[k] <= ys, clipped to the bins
      xk = kx[k];
      xkp = kx[k + 1];
      yk = ky[k];
      ykp = ky[k + 1];
      dk = dv[k];
      dkp = dv[k + 1];
    }
  }

  // the bin's inverse: Citardauq root, then two Newton steps
  const float dx = xkp - xk, dy = ykp - yk, sk = dy * rcp(dx);
  const float c2 = dkp + dk - 2.f * sk;
  const float t = ys - yk;
  const float qa = dy * (sk - dk) + t * c2;
  const float qb = dy * dk - t * c2;
  const float qc = -sk * t;
  const float disc = fmaxf(qb * qb - 4.f * qa * qc, 0.f);
  float denom = -qb - sqrtf(disc);
  if (fabsf(denom) < 1e-30f) denom = 1e-30f;
  float xi = clip01(2.f * qc * rcp(denom));
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float omx = 1.f - xi;
    const float rden = rcp(sk + c2 * xi * omx);  // >= sk / 2 > 0
    const float y_hat = yk + dy * (sk * xi * xi + dk * xi * omx) * rden;
    const float dy_dxi =
        sk * sk * (dkp * xi * xi + 2.f * sk * xi * omx + dk * omx * omx) * (rden * rden) * dx;
    xi = clip01(xi - (y_hat - ys) * rcp(fmaxf(dy_dxi, 1e-12f)));
  }
  const float omx = 1.f - xi;
  const float dnum = sk * sk * (dkp * xi * xi + 2.f * sk * xi * omx + dk * omx * omx);
  const float dden = sk + c2 * xi * omx;
  xo = inside ? xi * dx + xk + left : (yv - shift) * rcp(scale);
  const float rd = rcp(dden);
  logj = LN2 * lg2(inside ? dnum * rd * rd : scale);
}

// ------------------------------------------------------------ the work list
// CTA b of G takes the contiguous units [chunk_start(b), chunk_start(b + 1)):
// the first units % G CTAs one unit more than the others
__host__ __device__ __forceinline__ long long chunk_start(long long b, long long units,
                                                          long long G) {
  const long long base = units / G, extra = units % G;
  return b * base + (b < extra ? b : extra);
}

// the CTA whose chunk holds unit u
__host__ __device__ __forceinline__ long long cta_of(long long u, long long units, long long G) {
  const long long base = units / G, extra = units % G, cut = extra * (base + 1);
  return u < cut ? u / (base + 1) : extra + (u - cut) / base;
}

// the first and the number of CTAs whose chunks hold a scalar of row `row`;
// its partials are at first + row onwards
__host__ __device__ __forceinline__ long long first_cta(long long row, int D, long long units,
                                                        long long G) {
  return cta_of((row * D) >> LOG_T, units, G);
}

__host__ __device__ __forceinline__ int ctas_of_row(long long row, int D, long long units,
                                                    long long G) {
  return (int)(cta_of((row * D + D - 1) >> LOG_T, units, G) - first_cta(row, D, units, G) + 1);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(hop::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hop::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(T) : "memory");
}

__device__ __forceinline__ uint32_t lead(const void* p) {
  return (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ uint32_t round16(uint32_t bytes) { return (bytes + 15) & ~15u; }

// a CTA's sum for a row that spans CTAs, tagged with the launch's epoch in one
// 64-bit word: a reader that finds the epoch has the sum
__device__ __forceinline__ void store_partial(unsigned long long* p, float v, int epoch) {
  const unsigned long long w = (unsigned long long)(unsigned)epoch << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ float load_partial(const unsigned long long* p, int epoch) {
  unsigned long long w;
  while (true) {  // its store is issued (its row was counted): wait until it lands
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    if ((unsigned)(w >> 32) == (unsigned)epoch) return __uint_as_float((unsigned)w);
    __nanosleep(64);
  }
}

// a row whose count lane `lane` brought to its number of CTAs: the warp adds
// the row's partials in CTA order (lane strides, then a fixed tree) and
// resets its count
__device__ __forceinline__ void finish_row(bool done, long long row, const SplineArgs& a,
                                           int lane) {
  if (!__any_sync(FULL, done)) return;
  const long long r = __shfl_sync(FULL, row, __ffs(__ballot_sync(FULL, done)) - 1);
  const unsigned long long* p = a.partial + first_cta(r, a.D, a.units, gridDim.x) + r;
  const int count = ctas_of_row(r, a.D, a.units, gridDim.x);
  float s = 0.f;
  for (int i = lane; i < count; i += 32) s += load_partial(p + i, a.epoch);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) {
    a.logdet[r] = -s;
    a.rows_done[r] = 0;
  }
}

template <int BINS, bool IDENTITY, bool CLAMP>
__global__ void __launch_bounds__(THREADS, 3) binned_rqs_inverse_kernel(SplineArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ float sums[2][T];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], T / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int y_at = a.stage_bytes - Y_REGION;
  const long long u_begin = chunk_start(blockIdx.x, a.units, gridDim.x),
                  u_end = chunk_start(blockIdx.x + 1LL, a.units, gridDim.x);

  if (tid >= T) {  // the producer warp: one thread keeps the ring full
    if (tid == T) {
      int s = 0;
      unsigned phase = 0;  // flips each time the ring wraps
      for (long long u = u_begin; u < u_end; ++u) {
        if (u >= u_begin + STAGES) hop::mbar_wait(&empty[s], phase ^ 1);  // the stage was used
        const long long s0 = u * T;
        const uint32_t n = (uint32_t)min((long long)T, a.n - s0);
        const float* th = a.theta + s0 * a.P;
        const float* yy = a.y + s0;
        const uint32_t tb = round16(lead(th) + n * a.P * 4), yb = round16(lead(yy) + n * 4);
        unsigned char* st = ring + (size_t)s * a.stage_bytes;
        hop::mbar_expect_tx(&full[s], tb + yb);
        bulk_load(st, reinterpret_cast<const unsigned char*>(th) - lead(th), tb, &full[s]);
        bulk_load(st + y_at, reinterpret_cast<const unsigned char*>(yy) - lead(yy), yb,
                  &full[s]);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: thread `tid` takes scalar tid of each unit. Thread 0 also
  // carries the sum of the row still open at the end of the last unit
  int s = 0, buf = 0;
  unsigned phase = 0;
  const unsigned D = a.D;
  const bool wide = D >= T;
  const long long chunk_s0 = u_begin * T, chunk_end = min(u_end * T, a.n);
  long long r0 = chunk_s0 / D;           // the unit's first row
  unsigned c0 = chunk_s0 - r0 * D;       // and its first scalar within that row
  float carry = 0.f;
  long long carry_row = -1;
  // the chunk's head row (begun in an earlier chunk) and tail row (going on
  // into a later one) get a partial from this CTA each (one if they are the
  // same row): count them now, so that the atomics' round trips are over by
  // the end. A CTA that completes a count waits for the other partials only
  // of CTAs that have counted, so have started, and store without waiting
  const long long head = c0 ? r0 : -1, last = (chunk_end - 1) / D;
  const long long tail = (last + 1) * D > chunk_end ? last : -1;
  int head_old = 0, tail_old = 0;
  if (tid == 0) {
    if (head >= 0) head_old = atomicAdd(a.rows_done + head, 1);
    if (tail >= 0 && tail != head) tail_old = atomicAdd(a.rows_done + tail, 1);
  }
  for (long long u = u_begin; u < u_end; ++u) {
    const long long s0 = u * T;
    const int n = (int)min((long long)T, a.n - s0);
    const float* th = a.theta + s0 * a.P;
    const float* yy = a.y + s0;
    const unsigned char* st = ring + (size_t)s * a.stage_bytes;
    hop::mbar_wait(&full[s], phase);
    float xv = 0.f, logj = 0.f;
    if (tid < n)
      spline_inverse<BINS, IDENTITY, CLAMP>(
          reinterpret_cast<const float*>(st + lead(th)) + tid * a.P,
          reinterpret_cast<const float*>(st + y_at + lead(yy))[tid], a, xv, logj);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (tid < n) a.x[s0 + tid] = xv;

    // the unit's log-derivatives by row: suffix sums within each warp's
    // run of a row, then each row segment adds its warps' runs in order
    // the row offset of the thread's scalar: at D >= T a unit meets two rows
    // at most, and the divisions below are compares
    const unsigned roff = tid >= n ? FULL : wide ? (c0 + tid >= D) : (c0 + tid) / D;
    float v = logj;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vv = __shfl_down_sync(FULL, v, off);
      const unsigned rr = __shfl_down_sync(FULL, roff, off);
      if (lane + off < 32 && rr == roff) v += vv;
    }
    float* sm = sums[buf];
    sm[tid] = v;
    consumers_sync();
    const int nseg = (int)(wide ? (c0 + n - 1 >= D) : (c0 + n - 1) / D) + 1;
    // the sum of the unit's scalars [lo, hi), all of one row: its warps'
    // runs in warp order
    auto segment = [&](unsigned lo, unsigned hi) {
      float seg = 0.f;
#pragma unroll
      for (int w = 0; w < T / 32; ++w)
        if (32u * w < hi && 32u * w + 32 > lo) seg += sm[max(lo, 32u * w)];
      return seg;
    };
    // segment j of the unit is row r0 + j, at [j D - c0, (j + 1) D - c0)
    // clipped to the unit (j D stays below 2^32: j <= 1 unless D < T)
    if (tid > 0 && tid < nseg - 1)  // rows inside the unit
      a.logdet[r0 + tid] = -segment(tid * D - c0, (tid + 1) * D - c0);
    if (tid == 0) {  // the first and the last row, which may reach past the unit
      for (int j = 0; j < (nseg > 1 ? 2 : 1); ++j) {
        const unsigned k = j ? nseg - 1 : 0, end = (k + 1) * D - c0;
        const long long r = r0 + k;
        float total = segment(k ? k * D - c0 : 0u, min(end, (unsigned)n));
        if (!j && carry_row == r) total = carry + total;
        if (end > (unsigned)n) {  // the row goes on into the next unit
          carry = total;
          carry_row = r;
        } else if (r != head) {  // begun and ended in this chunk
          a.logdet[r] = -total;
          carry_row = -1;
        } else {  // the chunk's head row, begun in an earlier chunk
          store_partial(a.partial + blockIdx.x + r, total, a.epoch);
          carry_row = -1;
        }
      }
    }
    buf ^= 1;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
    const unsigned c = c0 + T, dr = wide ? (c >= D) : c / D;  // the next unit's row and offset
    r0 += dr;
    c0 = c - dr * D;
  }
  // the row still open goes on into the next chunk: this CTA's partial of
  // it; a warp finishes each row whose count this CTA completed
  if (tid < 32) {
    if (tid == 0 && carry_row >= 0)
      store_partial(a.partial + blockIdx.x + carry_row, carry, a.epoch);
    finish_row(
        tid == 0 && head >= 0 && head_old == ctas_of_row(head, a.D, a.units, gridDim.x) - 1,
        head, a, lane);
    finish_row(tid == 0 && tail >= 0 && tail != head &&
                   tail_old == ctas_of_row(tail, a.D, a.units, gridDim.x) - 1,
               tail, a, lane);
  }
}

template <int BINS, bool IDENTITY, bool CLAMP>
cudaError_t launch(const SplineArgs& a, cudaStream_t stream) {
  auto kernel = binned_rqs_inverse_kernel<BINS, IDENTITY, CLAMP>;
  const int smem = STAGES * a.stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms, grid = a.units < fit ? a.units : fit;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool IDENTITY, bool CLAMP>
cudaError_t launch_bins(const SplineArgs& a, int bins, cudaStream_t s) {
  switch (bins) {
#define BINS_CASE(n) \
  case n:            \
    return launch<n, IDENTITY, CLAMP>(a, s);
    BINS_CASE(1) BINS_CASE(2) BINS_CASE(3) BINS_CASE(4) BINS_CASE(5) BINS_CASE(6)
    BINS_CASE(7) BINS_CASE(8) BINS_CASE(9) BINS_CASE(10) BINS_CASE(11) BINS_CASE(12)
    BINS_CASE(13) BINS_CASE(14) BINS_CASE(15) BINS_CASE(16)
#undef BINS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace k4

// `a` as ops/fused_spline.py plans it: the work list, the stage size and
// count; refused unless they match this file's unit and layout
extern "C" int binned_rqs_inverse(const k4::SplineArgs* a, int bins, int identity_tails,
                                  void* stream) {
  using namespace k4;
  if (a->D < 1 || a->n < 1 || a->units != (a->n + T - 1) / T ||
      a->P != 3 * bins + (identity_tails ? 0 : 1) ||
      a->stage_bytes != T * a->P * 4 + 16 + Y_REGION)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool clamp = a->clamp > 0.f;
  return (int)(identity_tails ? (clamp ? launch_bins<true, true>(*a, bins, s)
                                       : launch_bins<true, false>(*a, bins, s))
                              : (clamp ? launch_bins<false, true>(*a, bins, s)
                                       : launch_bins<false, false>(*a, bins, s)));
}
