// Fused LayerNorm over the last axis for Hopper (sm_90a), forward and
// backward, with the statistics and all arithmetic in f32.
//
// Replaces the TPU kernels (deeplearning4j_tpu/ops/fused_layernorm.py)
//   `_ln_fwd` -> `_fwd_kernel` (K10): per row mu = mean(x), the variance
//     of the centred values, rstd = rsqrt(var + eps), y = xc * rstd * gamma
//     + beta in x's type; mu and rstd saved in f32 [N];
//   `_ln_bwd` -> `_bwd_kernel` (K11): xn = (x - mu) * rstd, wdy = dy *
//     gamma, dx = rstd * (wdy - mean(wdy) - xn * mean(wdy * xn)) in x's
//     type, and f32 partial column sums of dy * xn (dgamma) and dy (dbeta)
//     per block of rows, which the caller sums (as the TPU wrapper sums its
//     per-block partials outside the kernel).
//
// Shapes: x, dy, y, dx [N, C]; gamma, beta [C]; all one type (f32 or
// bf16), row-major contiguous; mu, rstd [N] f32; the partials
// [ceil(N / chunk), C] f32. Any N >= 1 and C >= 1: the TPU's envelope
// (C % 128 == 0, N % 8 == 0, a lane-legal row block) has no counterpart.
//
// Design. Forward and dx: one warp per row, eight rows per block; each
// lane strides over the row (neighbouring lanes on neighbouring columns)
// and warp shuffles sum the row's moments. The forward makes three passes
// over the row (mean, centred variance as the TPU kernel computes it, the
// output), the dx kernel two; the repeats hit L1. dgamma/dbeta: one thread
// per column, a block of 128 columns walking `chunk` rows, so each row of
// x and dy is read with coalesced loads and each partial is summed in a
// fixed order.
//
// What bounds it. A few FLOPs per element against the x (and dy) reads:
// memory-bound by a wide margin, so the least time is the bytes over the
// memory rate. The row kernels read each element two or three times
// (L1-served) and the backward reads x and dy once more for the column
// partials; one pass with the row kept in registers, and the column sums
// folded into the dx kernel, are the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 8;  // rows per block (forward, dx)
constexpr int NTHREADS = WARPS * 32;
constexpr int COLS = 128;  // columns per block (dgamma/dbeta)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mu_out, float* __restrict__ rstd_out,
                  int N, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const T* xr = x + (size_t)n * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_float(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_float(xr[c]) - mu;
    v = fmaf(d, d, v);
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  T* yr = y + (size_t)n * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = from_float<T>((to_float(xr[c]) - mu) * rstd *
                              to_float(gamma[c]) +
                          to_float(beta[c]));
  if (lane == 0) {
    mu_out[n] = mu;
    rstd_out[n] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    ln_dx_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                 const float* __restrict__ mu, const float* __restrict__ rstd,
                 const T* __restrict__ dy, T* __restrict__ dx, int N, int C) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const T* xr = x + (size_t)n * C;
  const T* dyr = dy + (size_t)n * C;
  const float m = mu[n], r = rstd[n];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xn = (to_float(xr[c]) - m) * r;
    const float wdy = to_float(dyr[c]) * to_float(gamma[c]);
    s1 += wdy;
    s2 = fmaf(wdy, xn, s2);
  }
  const float m1 = warp_sum(s1) / C;
  const float m2 = warp_sum(s2) / C;
  T* dxr = dx + (size_t)n * C;
  for (int c = lane; c < C; c += 32) {
    const float xn = (to_float(xr[c]) - m) * r;
    const float wdy = to_float(dyr[c]) * to_float(gamma[c]);
    dxr[c] = from_float<T>(r * (wdy - m1 - xn * m2));
  }
}

template <typename T>
__global__ void __launch_bounds__(COLS)
    ln_dgdb_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   float* __restrict__ dg_part, float* __restrict__ db_part,
                   int N, int C, int chunk) {
  const int c = blockIdx.x * COLS + threadIdx.x;
  if (c >= C) return;
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(N, n0 + chunk);
  float dg = 0.f, db = 0.f;
  for (int n = n0; n < n1; ++n) {
    const float g = to_float(dy[(size_t)n * C + c]);
    const float xn = (to_float(x[(size_t)n * C + c]) - mu[n]) * rstd[n];
    dg = fmaf(g, xn, dg);
    db += g;
  }
  dg_part[(size_t)blockIdx.y * C + c] = dg;
  db_part[(size_t)blockIdx.y * C + c] = db;
}

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        float* mu, float* rstd, int N, int C, float eps, cudaStream_t s) {
  ln_fwd_kernel<T><<<(N + WARPS - 1) / WARPS, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), mu, rstd, N, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* gamma, const float* mu, const float* rstd,
        const void* dy, void* dx, float* dg_part, float* db_part, int N,
        int C, int chunk, cudaStream_t s) {
  ln_dx_kernel<T><<<(N + WARPS - 1) / WARPS, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), N, C);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid((C + COLS - 1) / COLS, (N + chunk - 1) / chunk);
  ln_dgdb_kernel<T><<<grid, COLS, 0, s>>>(
      static_cast<const T*>(x), mu, rstd, static_cast<const T*>(dy), dg_part,
      db_part, N, C, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns 0 on success, a
// cudaError_t from a launch, or -1 for arguments the kernels do not take.

extern "C" int ln_fwd(const void* x, const void* gamma, const void* beta,
                      void* y, float* mu, float* rstd, int dtype, int N,
                      int C, float eps, void* stream) {
  if (N <= 0 || C <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, gamma, beta, y, mu, rstd, N, C, eps, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, gamma, beta, y, mu, rstd, N, C, eps, s);
  return -1;
}

// dx, then the [ceil(N / chunk), C] dgamma / dbeta partials
extern "C" int ln_bwd(const void* x, const void* gamma, const float* mu,
                      const float* rstd, const void* dy, void* dx,
                      float* dg_part, float* db_part, int dtype, int N, int C,
                      int chunk, void* stream) {
  if (N <= 0 || C <= 0 || chunk <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(x, gamma, mu, rstd, dy, dx, dg_part, db_part, N, C,
                      chunk, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, gamma, mu, rstd, dy, dx, dg_part, db_part,
                              N, C, chunk, s);
  return -1;
}
