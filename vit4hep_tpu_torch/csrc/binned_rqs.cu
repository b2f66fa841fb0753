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
// MB at the ds2 cINN shape (256, 3240, 31)) and y read and x written once;
// the arithmetic is ~1.2 k f32 operations per scalar, about half the time
// the bytes take at the HBM rate. So the kernel is bound by bytes.
//
// Design: one thread per scalar, a CTA of `threads` consecutive scalars of
// one row. The TPU kernel transposes theta to (B, P, D) so that elements sit
// on lanes; here theta is read in its native (B, D, P) layout: the CTA's
// tile of threads * P contiguous floats is staged into shared memory with
// coalesced 16-byte loads, and each thread reads its own P parameters from
// shared memory at stride P (odd for the affine-tail form, so the 32 lanes
// of a warp hit 32 distinct banks). Knots and derivatives (3 x (bins + 1)
// floats) stay in registers: the bin count is a template parameter, every
// loop over bins unrolls, and the active bin is selected with predicated
// moves. The log-derivatives of a row are summed per CTA (warp shuffles,
// then the warps in order) into a (B, chunks) buffer, and a second small
// kernel adds a row's chunks in order: no atomics, the same result on
// every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr float LOG_E_MINUS_1 = 0.5413248546129181f;  // log(e - 1): softplus(0 + it) = 1

struct SplineArgs {
  const float* y;
  const float* theta;
  float* x;
  float* partial;  // (B, chunks) per-CTA sums of the forward log-derivative
  int D, P, identity_tails, chunks;
  float min_w, min_h, left0, bottom0, default_width, xshift, yshift, clamp;
};

// jax.nn.softplus: logaddexp(v, 0)
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

template <int BINS>
__global__ void __launch_bounds__(MAX_THREADS) binned_rqs_inverse_kernel(SplineArgs a) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  __shared__ float warp_sums[MAX_THREADS / 32];

  const int row = blockIdx.y;
  const int c0 = blockIdx.x * blockDim.x;
  const int n = min((int)blockDim.x, a.D - c0);
  const long long first = (long long)row * a.D + c0;
  const float* src = a.theta + first * a.P;
  const int count = n * a.P;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int j = threadIdx.x; j < n4; j += blockDim.x) smem4[j] = src4[j];
    for (int j = 4 * n4 + threadIdx.x; j < count; j += blockDim.x) tile[j] = src[j];
  } else {
    for (int j = threadIdx.x; j < count; j += blockDim.x) tile[j] = src[j];
  }
  __syncthreads();

  float logj = 0.f;
  if ((int)threadIdx.x < n) {
    const float* th = tile + threadIdx.x * a.P;
    float kx[BINS + 1], ky[BINS + 1], dv[BINS + 1];
    float left, bottom;
    int dstart;
    if (a.identity_tails) {
      float tw = a.default_width * softplus(th[2 * BINS] + LOG_E_MINUS_1);
      if (a.clamp > 0.f) tw = a.clamp * tanhf(tw / a.clamp);
      left = -tw / 2.f;
      bottom = -tw / 2.f;
      float wmax = th[0], hmax = th[BINS];
#pragma unroll
      for (int k = 1; k < BINS; ++k) {
        wmax = fmaxf(wmax, th[k]);
        hmax = fmaxf(hmax, th[BINS + k]);
      }
      float we[BINS], he[BINS];
      float wsum = 0.f, hsum = 0.f;
#pragma unroll
      for (int k = 0; k < BINS; ++k) {
        we[k] = expf(th[k] - wmax);
        he[k] = expf(th[BINS + k] - hmax);
        wsum += we[k];
        hsum += he[k];
      }
      kx[0] = left;
      ky[0] = bottom;
#pragma unroll
      for (int k = 0; k < BINS; ++k) {
        kx[k + 1] = kx[k] + tw * we[k] / wsum;
        ky[k + 1] = ky[k] + tw * he[k] / hsum;
      }
      dstart = 2 * BINS + 1;
    } else {
      bottom = th[2 * BINS] + a.bottom0;
      left = th[2 * BINS + 1] + a.left0;
      float w[BINS], h[BINS];
#pragma unroll
      for (int k = 0; k < BINS; ++k) {
        w[k] = a.min_w + softplus(th[k] + a.xshift);
        h[k] = a.min_h + softplus(th[BINS + k] + a.yshift);
      }
      if (a.clamp > 0.f) {  // rescale the domain to clamp * tanh(extent / clamp)
        float dw = w[0], dh = h[0];
#pragma unroll
        for (int k = 1; k < BINS; ++k) {
          dw += w[k];
          dh += h[k];
        }
        const float wr = a.clamp * tanhf(dw / a.clamp) / dw;
        const float hr = a.clamp * tanhf(dh / a.clamp) / dh;
#pragma unroll
        for (int k = 0; k < BINS; ++k) {
          w[k] *= wr;
          h[k] *= hr;
        }
        left *= wr;
        bottom *= hr;
      }
      kx[0] = left;
      ky[0] = bottom;
#pragma unroll
      for (int k = 0; k < BINS; ++k) {
        kx[k + 1] = kx[k] + w[k];
        ky[k + 1] = ky[k] + h[k];
      }
      dstart = 2 * BINS + 2;
    }
    // the boundary derivatives equal the tails' slope
    const float scale = (ky[BINS] - bottom) / (kx[BINS] - left);
    const float shift = bottom - scale * left;
    dv[0] = scale;
    dv[BINS] = scale;
#pragma unroll
    for (int k = 1; k < BINS; ++k) dv[k] = softplus(th[dstart + k - 1] + LOG_E_MINUS_1);

    const float yv = a.y[first + threadIdx.x];
    const bool inside = (yv > ky[0]) && (yv <= ky[BINS]);
    const float tail = (yv - shift) / scale;
    const float ys = fminf(fmaxf(yv, ky[0]), ky[BINS]);
    int cnt = 0;
#pragma unroll
    for (int k = 0; k <= BINS; ++k) cnt += (ys >= ky[k]) ? 1 : 0;
    const int idx = min(max(cnt - 1, 0), BINS - 1);
    float xk = kx[0], xkp = kx[1], yk = ky[0], ykp = ky[1], dk = dv[0], dkp = dv[1];
#pragma unroll
    for (int k = 1; k < BINS; ++k) {
      if (idx == k) {
        xk = kx[k];
        xkp = kx[k + 1];
        yk = ky[k];
        ykp = ky[k + 1];
        dk = dv[k];
        dkp = dv[k + 1];
      }
    }

    // the bin's inverse: Citardauq root, then two Newton steps
    const float dx = xkp - xk, dy = ykp - yk, sk = dy / dx;
    const float c2 = dkp + dk - 2.f * sk;
    const float t = ys - yk;
    const float qa = dy * (sk - dk) + t * c2;
    const float qb = dy * dk - t * c2;
    const float qc = -sk * t;
    const float disc = fmaxf(qb * qb - 4.f * qa * qc, 0.f);
    float denom = -qb - sqrtf(disc);
    if (fabsf(denom) < 1e-30f) denom = 1e-30f;
    float xi = clip01(2.f * qc / denom);
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const float omx = 1.f - xi;
      const float den = sk + c2 * xi * omx;
      const float y_hat = yk + dy * (sk * xi * xi + dk * xi * omx) / den;
      const float dy_dxi =
          sk * sk * (dkp * xi * xi + 2.f * sk * xi * omx + dk * omx * omx) / (den * den) * dx;
      xi = clip01(xi - (y_hat - ys) / fmaxf(dy_dxi, 1e-12f));
    }
    const float omx = 1.f - xi;
    const float dnum = sk * sk * (dkp * xi * xi + 2.f * sk * xi * omx + dk * omx * omx);
    const float dden = sk + c2 * xi * omx;
    const float log_deriv = logf(dnum) - logf(dden * dden);

    a.x[first + threadIdx.x] = inside ? xi * dx + xk : tail;
    logj = inside ? log_deriv : logf(scale);
  }

  // this CTA's share of the row's log-derivative sum, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) logj += __shfl_down_sync(0xffffffffu, logj, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = logj;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
    a.partial[(long long)row * a.chunks + blockIdx.x] = s;
  }
}

// logdet[row] = -(sum of the row's chunks, in chunk order)
__global__ void logdet_reduce_kernel(const float* partial, float* logdet, int B, int chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)row * chunks + c];
  logdet[row] = -s;
}

template <int BINS>
cudaError_t launch(const SplineArgs& a, int B, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)threads * a.P * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(binned_rqs_inverse_kernel<BINS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  binned_rqs_inverse_kernel<BINS><<<dim3(a.chunks, B), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int binned_rqs_inverse(const float* y, const float* theta, float* x, float* partial,
                                  float* logdet, int B, int D, int bins, int identity_tails,
                                  int threads, float min_w, float min_h, float left0,
                                  float bottom0, float default_width, float xshift, float yshift,
                                  float clamp, void* stream) {
  if (B < 1 || B > 65535 || D < 1 || threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  SplineArgs a{y, theta, x, partial, D, 3 * bins + (identity_tails ? 0 : 1), identity_tails,
               (D + threads - 1) / threads, min_w, min_h, left0, bottom0, default_width,
               xshift, yshift, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bins) {
#define BINS_CASE(n)              \
  case n:                         \
    e = launch<n>(a, B, threads, s); \
    break;
    BINS_CASE(1) BINS_CASE(2) BINS_CASE(3) BINS_CASE(4) BINS_CASE(5) BINS_CASE(6)
    BINS_CASE(7) BINS_CASE(8) BINS_CASE(9) BINS_CASE(10) BINS_CASE(11) BINS_CASE(12)
    BINS_CASE(13) BINS_CASE(14) BINS_CASE(15) BINS_CASE(16)
#undef BINS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  logdet_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(partial, logdet, B, a.chunks);
  return (int)cudaGetLastError();
}
