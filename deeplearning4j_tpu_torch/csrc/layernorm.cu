// Fused LayerNorm over the last axis for Hopper (sm_90a), forward and
// backward, with the statistics and all arithmetic in f32.
//
// Replaces the TPU kernels (deeplearning4j_tpu/ops/fused_layernorm.py)
//   `_ln_fwd` -> `_fwd_kernel` (K10): per row mu = mean(x), the variance
//     of the centred values, rstd = rsqrt(var + eps), y = xc * rstd * gamma
//     + beta in x's type; mu and rstd saved in f32 [N];
//   `_ln_bwd` -> `_bwd_kernel` (K11): xn = (x - mu) * rstd, wdy = dy *
//     gamma, dx = rstd * (wdy - mean(wdy) - xn * mean(wdy * xn)) in x's
//     type, and the f32 column sums dgamma = sum_rows dy * xn and dbeta =
//     sum_rows dy, reduced here (the TPU wrapper sums its per-block
//     partials outside its kernel; this entry does it on the card).
//
// Shapes: x, dy, y, dx [N, C] of one type T (f32 or bf16); gamma, beta
// [C] of the parameter type P, which is T or, for bf16 x, f32 (the
// reference casts gamma and beta to f32 inside its kernels, so an f32
// gamma is read as it is, never rounded to bf16); all row-major
// contiguous; mu, rstd [N] f32; dgamma and dbeta [2, C] f32 followed by
// the backward's per-block partials [parts, 2, C]. Any
// N >= 1 and C >= 1: the TPU's envelope (C % 128 == 0, N % 8 == 0, a
// lane-legal row block) has no counterpart.
//
// Both directions have a vector instantiation, lnv::fwd_vec<T, P, NV> and
// lnv::bwd_vec<T, P, NV>, for C = 32 * NV * 16 / sizeof(T) (NV 16-byte
// vectors a lane: 256 bf16 or 128 f32 columns each) with every [N, C] and
// [C] operand 16-byte aligned, and a general path for every other shape
// (C = 200, C = 7, an unaligned view). The wrapper chooses before the
// launch (`_fwd_plan`, `_bwd_plan` in ops/fused_layernorm.py) and passes
// the choice here as `nv` (0 = general). An f32 gamma beside bf16 x
// (P = f32) is held as two 16-byte vectors for each of x's (PVec); the
// instantiations with P = T compute as before, with the same code.
//
// The forward (K10). lnv::fwd_vec (NV <= 4): one pass over the row from
// registers. One warp per row; lane l holds the row's 16-byte vectors l,
// l + 32, ..., read with one 16-byte load each and written back with
// 16-byte stores. The moments come from those registers (the mean, then
// the mean of the centred squares, as the TPU kernel computes them, each
// a warp butterfly). gamma and beta are loaded once a warp and kept in
// registers while the warp strides over rows, the grid being a few blocks
// an SM. ln_fwd_kernel (general): one warp per row, each lane striding
// over the row with scalar loads, three passes whose repeats hit L1.
//
// The backward (K11). lnv::bwd_vec (NV <= 2: C = 256 or 512 in bf16, 128
// or 256 in f32): one pass from registers, as the forward. One warp per
// row in a grid-stride loop; lane l holds x's and dy's vectors l, l + 32,
// ... of the row, each read once with a 16-byte load, and the next row's
// are loaded before this row is computed, so two rows a warp are in
// flight. gamma is loaded once a warp and kept packed in registers. The
// row's two sums (wdy, wdy * xn) travel in one butterfly; dx goes out in
// 16-byte stores. Each lane accumulates dgamma and dbeta for its own
// columns in f32 registers over all the rows its warp takes, so x and dy
// are read from memory once. At the end the block's warps add their
// columns through shared memory in warp order, and the block writes one
// [2, C] partial. The grid is fixed by the caller (`blocks`: 2 blocks of
// 8 warps on each of the H100's 132 SMs), so the partials are 264 x 2 x C
// x 4 bytes (0.54 MB at C = 256, against the 25.3 MB the call must move).
// Wider rows go to the general path: with x, dy, the next row's, gamma
// and the accumulators of 4 vectors a lane, ptxas spills at the 128
// registers that 2 blocks an SM leave (f32, C = 512).
// General path: ln_dx_kernel (one warp per row, two passes over the row,
// the second served by L1) and ln_dgdb_kernel (one thread per column, a
// block of 128 columns walking ceil(N / blocks) rows), writing partials
// in the same layout.
//
// The partials of either path are summed by lnv::colsum, a second small
// kernel on the same stream: 32 columns a block, each of its 32 warps
// adding every 32nd partial, then warp 0 adding the warps' sums in warp
// order. Chosen over letting the last block to finish do the sum (found
// by a global counter that it resets): that block reads all partials
// alone on one SM, with a chain of L2 loads a column. On an H100 (700 W)
// at 264 partials of 2 x 256, port_tools/ln_reduce_bench.py measures
// 0.0020 ms of device time added by the colsum launch and 0.0188 ms by
// the last block. A counter kept across calls would also be shared by
// calls on other streams.
// No kernel uses atomics and every sum has a fixed order given `blocks`:
// every launch repeats bit for bit. No kernel allocates or synchronizes.
//
// What bounds it. A few FLOPs per element against the x (and dy) reads:
// memory-bound by a wide margin, so the least time is the bytes over the
// memory rate: the forward reads x once and writes y once, the backward
// reads x and dy once and writes dx once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps (rows at a time) per block
constexpr int NTHREADS = WARPS * 32;
constexpr int COLS = 128;  // columns per block (general dgamma/dbeta)

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

// the block's dynamic shared memory (the column reductions)
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float smem[];
  return smem;
}

template <typename T, typename P>
__global__ void __launch_bounds__(NTHREADS)
    ln_fwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                  const P* __restrict__ beta, T* __restrict__ y,
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

namespace lnv {

constexpr int BLOCKS_PER_SM = 2048 / NTHREADS;  // resident blocks an SM
constexpr int MAX_NV = 4;  // 16-byte vectors a lane (C <= 1024 bf16)
constexpr int BWD_BLOCKS_PER_SM = 2;  // the backward's: <= 128 registers
constexpr int MAX_BWD_NV = 2;  // the backward's (C <= 512 bf16, 256 f32)
constexpr int RED_WARPS = 32;  // colsum's warps a block
constexpr int RED_THREADS = RED_WARPS * 32;

// one 16-byte vector of T as floats, and back
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const float* p = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = p[k];
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 u;
    float* p = reinterpret_cast<float*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = f[k];
    return u;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return u;
  }
};

// the parameters (P) of the columns of one 16-byte vector of T: W
// 16-byte vectors of P, one when P is T, two when P is f32 and T bf16
template <typename T, typename P> struct PVec {
  static constexpr int W = sizeof(P) / sizeof(T);
  static_assert(W == 1 || W == 2, "P is T, or f32 beside bf16 T");
  // vector v of the [C] parameters into u[0, W)
  __device__ __forceinline__ static void load(const P* p, int v, uint4* u) {
#pragma unroll
    for (int j = 0; j < W; ++j) u[j] = reinterpret_cast<const uint4*>(p)[v * W + j];
  }
  __device__ __forceinline__ static void unpack(const uint4* u, float* f) {
#pragma unroll
    for (int j = 0; j < W; ++j) Vec<P>::unpack(u[j], f + j * Vec<P>::N);
  }
};

// K10 for C = 32 * NV * Vec<T>::N: one warp a row, the row in registers
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(NTHREADS)
    fwd_vec(const T* __restrict__ x, const P* __restrict__ gamma,
            const P* __restrict__ beta, T* __restrict__ y,
            float* __restrict__ mu_out, float* __restrict__ rstd_out, int N,
            float eps) {
  constexpr int E = Vec<T>::N;
  constexpr int C = 32 * NV * E;
  constexpr int W = PVec<T, P>::W;
  const int lane = threadIdx.x & 31;
  uint4 g[NV * W], b[NV * W];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    PVec<T, P>::load(gamma, lane + 32 * i, g + i * W);
    PVec<T, P>::load(beta, lane + 32 * i, b + i * W);
  }
  const int stride = gridDim.x * WARPS;
  for (int n = blockIdx.x * WARPS + (threadIdx.x >> 5); n < N;
       n += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)n * C);
    float f[NV][E];
#pragma unroll
    for (int i = 0; i < NV; ++i) Vec<T>::unpack(xr[lane + 32 * i], f[i]);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < E; ++k) s += f[i][k];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float d = f[i][k] - mu;
        v = fmaf(d, d, v);
      }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)n * C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float gf[E], bf[E], o[E];
      PVec<T, P>::unpack(g + i * W, gf);
      PVec<T, P>::unpack(b + i * W, bf);
#pragma unroll
      for (int k = 0; k < E; ++k)
        o[k] = (f[i][k] - mu) * rstd * gf[k] + bf[k];
      yr[lane + 32 * i] = Vec<T>::pack(o);
    }
    if (lane == 0) {
      mu_out[n] = mu;
      rstd_out[n] = rstd;
    }
  }
}

int sm_count() {
  static int sms = 0;  // the card's, asked once
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms = n;
  }
  return sms;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename P, int NV>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           float* mu, float* rstd, int N, float eps, cudaStream_t s) {
  const int rows = (N + WARPS - 1) / WARPS, cap = sm_count() * BLOCKS_PER_SM;
  const int blocks = rows < cap ? rows : cap;
  fwd_vec<T, P, NV><<<blocks, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const P*>(gamma),
      static_cast<const P*>(beta), static_cast<T*>(y), mu, rstd, N, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        float* mu, float* rstd, int nv, int N, int C, float eps,
        cudaStream_t s) {
  if (C != 32 * nv * Vec<T>::N || !aligned16(x) || !aligned16(gamma) ||
      !aligned16(beta) || !aligned16(y))
    return -1;
  switch (nv) {
    case 1: return launch<T, P, 1>(x, gamma, beta, y, mu, rstd, N, eps, s);
    case 2: return launch<T, P, 2>(x, gamma, beta, y, mu, rstd, N, eps, s);
    case 3: return launch<T, P, 3>(x, gamma, beta, y, mu, rstd, N, eps, s);
    case 4: return launch<T, P, 4>(x, gamma, beta, y, mu, rstd, N, eps, s);
  }
  return -1;
}

// row n's vectors of x and dy held by this lane, and its mu and rstd
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ dy,
                                         const float* __restrict__ mu,
                                         const float* __restrict__ rstd,
                                         int n, int lane, uint4* xv,
                                         uint4* dv, float& m, float& r) {
  constexpr int C = 32 * NV * Vec<T>::N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)n * C);
  const uint4* dr = reinterpret_cast<const uint4*>(dy + (size_t)n * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    xv[i] = xr[lane + 32 * i];
    dv[i] = dr[lane + 32 * i];
  }
  m = mu[n];
  r = rstd[n];
}

// K11 for C = 32 * NV * Vec<T>::N: one warp a row, the row in registers;
// the block's dgamma / dbeta partial to part[blockIdx.x] ([2, C])
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(NTHREADS, BWD_BLOCKS_PER_SM)
    bwd_vec(const T* __restrict__ x, const P* __restrict__ gamma,
            const float* __restrict__ mu, const float* __restrict__ rstd,
            const T* __restrict__ dy, T* __restrict__ dx,
            float* __restrict__ part, int N) {
  constexpr int E = Vec<T>::N;
  constexpr int C = 32 * NV * E;
  constexpr int W = PVec<T, P>::W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4 g[NV * W];
#pragma unroll
  for (int i = 0; i < NV; ++i) PVec<T, P>::load(gamma, lane + 32 * i, g + i * W);
  float dg[NV][E], db[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < E; ++k) dg[i][k] = db[i][k] = 0.f;

  const int stride = gridDim.x * WARPS;
  int n = blockIdx.x * WARPS + warp;
  uint4 xv[NV], dv[NV];
  float m = 0.f, r = 0.f;
  if (n < N) load_row<T, NV>(x, dy, mu, rstd, n, lane, xv, dv, m, r);
  while (n < N) {
    const int next = n + stride;
    uint4 xq[NV], dq[NV];
    float mq = 0.f, rq = 0.f;
    if (next < N) load_row<T, NV>(x, dy, mu, rstd, next, lane, xq, dq, mq, rq);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float xf[E], df[E], gf[E];
      Vec<T>::unpack(xv[i], xf);
      Vec<T>::unpack(dv[i], df);
      PVec<T, P>::unpack(g + i * W, gf);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float xn = (xf[k] - m) * r;
        const float wdy = df[k] * gf[k];
        s1 += wdy;
        s2 = fmaf(wdy, xn, s2);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // both sums, one butterfly
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / C, m2 = s2 / C;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)n * C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float xf[E], df[E], gf[E], o[E];
      Vec<T>::unpack(xv[i], xf);
      Vec<T>::unpack(dv[i], df);
      PVec<T, P>::unpack(g + i * W, gf);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float xn = (xf[k] - m) * r;
        const float wdy = df[k] * gf[k];
        o[k] = r * (wdy - m1 - xn * m2);
        dg[i][k] = fmaf(df[k], xn, dg[i][k]);
        db[i][k] += df[k];
      }
      dxr[lane + 32 * i] = Vec<T>::pack(o);
    }
    n = next;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[i] = xq[i];
      dv[i] = dq[i];
    }
    m = mq;
    r = rq;
  }

  // the block's partial: each column summed over the warps in warp order
  float* red = dyn_smem();  // [WARPS][2][C]
  float* mine = red + warp * 2 * C;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < E; ++k) {
      mine[(lane + 32 * i) * E + k] = dg[i][k];
      mine[C + (lane + 32 * i) * E + k] = db[i][k];
    }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 2 * C;
  for (int j = threadIdx.x; j < 2 * C; j += NTHREADS) {
    float t = red[j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += red[w * 2 * C + j];
    out[j] = t;
  }
}

// out[j] = sum over p < parts of part[p][j], j < C2, in a fixed order:
// warp w adds partials w, w + RED_WARPS, ..., then warp 0 adds the warps'
// sums in warp order; 32 columns a block
__global__ void __launch_bounds__(RED_THREADS)
    colsum(const float* __restrict__ part, float* __restrict__ out,
           int parts, int C2) {
  float* red = dyn_smem();  // [RED_WARPS][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (j < C2) {
#pragma unroll 4
    for (int p = warp; p < parts; p += RED_WARPS)
      t += part[(size_t)p * C2 + j];
  }
  red[threadIdx.x] = t;
  __syncthreads();
  if (warp == 0 && j < C2) {
    float u = red[lane];
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) u += red[w * 32 + lane];
    out[j] = u;
  }
}

int launch_colsum(const float* part, float* out, int parts, int C,
                  cudaStream_t s) {
  const int C2 = 2 * C, smem = RED_THREADS * (int)sizeof(float);
  colsum<<<(C2 + 31) / 32, RED_THREADS, smem, s>>>(part, out, parts, C2);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int NV>
int launch_bwd(const void* x, const void* gamma, const float* mu,
               const float* rstd, const void* dy, void* dx, float* part,
               int blocks, int N, cudaStream_t s) {
  constexpr int C = 32 * NV * Vec<T>::N;
  const int smem = WARPS * 2 * C * (int)sizeof(float);
  bwd_vec<T, P, NV><<<blocks, NTHREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const P*>(gamma), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), part, N);
  return (int)cudaGetLastError();
}

// the vector backward's most vectors a lane for parameters of type P: an
// f32 gamma beside bf16 x doubles its registers, so one (C = 256) keeps
// the kernel inside the 128 registers of 2 blocks an SM
template <typename T, typename P>
constexpr int max_bwd_nv() {
  return PVec<T, P>::W == 1 ? MAX_BWD_NV : 1;
}

template <typename T, typename P>
int bwd(const void* x, const void* gamma, const float* mu, const float* rstd,
        const void* dy, void* dx, float* part, int nv, int blocks, int N,
        int C, cudaStream_t s) {
  if (C != 32 * nv * Vec<T>::N || nv > max_bwd_nv<T, P>() ||
      !aligned16(x) || !aligned16(gamma) || !aligned16(dy) || !aligned16(dx))
    return -1;
  switch (nv) {
    case 1: return launch_bwd<T, P, 1>(x, gamma, mu, rstd, dy, dx, part,
                                       blocks, N, s);
    case 2:
      if constexpr (max_bwd_nv<T, P>() >= 2)
        return launch_bwd<T, P, 2>(x, gamma, mu, rstd, dy, dx, part, blocks,
                                   N, s);
  }
  return -1;
}

}  // namespace lnv

template <typename T, typename P>
__global__ void __launch_bounds__(NTHREADS)
    ln_dx_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
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

// rows [chunk * blockIdx.y, + chunk) of each column: part[blockIdx.y] =
// (dgamma, dbeta) [2, C]
template <typename T>
__global__ void __launch_bounds__(COLS)
    ln_dgdb_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   float* __restrict__ part, int N, int C, int chunk) {
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
  float* out = part + (size_t)blockIdx.y * 2 * C;
  out[c] = dg;
  out[C + c] = db;
}

template <typename T, typename P>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        float* mu, float* rstd, int N, int C, float eps, cudaStream_t s) {
  ln_fwd_kernel<T, P><<<(N + WARPS - 1) / WARPS, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const P*>(gamma),
      static_cast<const P*>(beta), static_cast<T*>(y), mu, rstd, N, C, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int bwd(const void* x, const void* gamma, const float* mu, const float* rstd,
        const void* dy, void* dx, float* part, int N, int C, int chunk,
        cudaStream_t s) {
  ln_dx_kernel<T, P><<<(N + WARPS - 1) / WARPS, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const P*>(gamma), mu, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), N, C);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid((C + COLS - 1) / COLS, (N + chunk - 1) / chunk);
  ln_dgdb_kernel<T><<<grid, COLS, 0, s>>>(
      static_cast<const T*>(x), mu, rstd, static_cast<const T*>(dy), part, N,
      C, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (x's, dy's) and pdtype (gamma's, beta's): 0 = float32, 1 =
// bfloat16; pdtype is dtype, or 0 beside dtype 1. Each returns 0 on
// success, a cudaError_t from a launch, or -1 for arguments the kernels do
// not take.

namespace {

// the kernels' (T, P) for (dtype, pdtype): 0 f32 x and gamma, 1 bf16 x and
// gamma, 2 bf16 x with f32 gamma; -1 for another pair
int types_of(int dtype, int pdtype) {
  if (dtype == pdtype && (dtype == 0 || dtype == 1)) return dtype;
  return dtype == 1 && pdtype == 0 ? 2 : -1;
}

}  // namespace

// K10. `nv` (from the wrapper's `_fwd_plan`): 0 for the general kernel,
// else the vector kernel's 16-byte vectors a lane, which must fit C and
// the pointers' alignment. stats [2, N] f32: mu, then rstd.
extern "C" int ln_fwd(const void* x, const void* gamma, const void* beta,
                      void* y, float* stats, int dtype, int pdtype, int nv,
                      int N, int C, float eps, void* stream) {
  const int types = types_of(dtype, pdtype);
  if (N <= 0 || C <= 0 || nv < 0 || nv > lnv::MAX_NV || types < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mu = stats;
  float* rstd = stats + N;
  if (nv > 0) {
    if (types == 0)
      return lnv::fwd<float, float>(x, gamma, beta, y, mu, rstd, nv, N, C,
                                    eps, s);
    if (types == 1)
      return lnv::fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mu,
                                                    rstd, nv, N, C, eps, s);
    return lnv::fwd<__nv_bfloat16, float>(x, gamma, beta, y, mu, rstd, nv, N,
                                          C, eps, s);
  }
  if (types == 0)
    return fwd<float, float>(x, gamma, beta, y, mu, rstd, N, C, eps, s);
  if (types == 1)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mu, rstd, N,
                                             C, eps, s);
  return fwd<__nv_bfloat16, float>(x, gamma, beta, y, mu, rstd, N, C, eps, s);
}

// K11. `nv` and `blocks` (from the wrapper's `_bwd_plan`): nv = 0 for the
// general path, whose column pass then takes ceil(N / blocks) rows a
// partial; else the vector kernel's 16-byte vectors a lane, which must fit
// C, the pointers' alignment and (for f32 gamma beside bf16 x) one vector
// a lane, on a grid of `blocks` blocks, one partial each. dgdb [1 +
// blocks, 2, C] f32: dgamma and dbeta, then the partials, which a second
// launch sums into them.
extern "C" int ln_bwd(const void* x, const void* gamma, const float* mu,
                      const float* rstd, const void* dy, void* dx,
                      float* dgdb, int dtype, int pdtype, int nv, int blocks,
                      int N, int C, void* stream) {
  const int types = types_of(dtype, pdtype);
  if (N <= 0 || C <= 0 || blocks <= 0 || nv < 0 || nv > lnv::MAX_NV ||
      types < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = dgdb + 2 * (size_t)C;
  int parts = blocks, rc;
  if (nv > 0) {
    rc = types == 0 ? lnv::bwd<float, float>(x, gamma, mu, rstd, dy, dx, part,
                                             nv, blocks, N, C, s)
         : types == 1
             ? lnv::bwd<__nv_bfloat16, __nv_bfloat16>(
                   x, gamma, mu, rstd, dy, dx, part, nv, blocks, N, C, s)
             : lnv::bwd<__nv_bfloat16, float>(x, gamma, mu, rstd, dy, dx,
                                              part, nv, blocks, N, C, s);
  } else {
    const int chunk = (N + blocks - 1) / blocks;
    parts = (N + chunk - 1) / chunk;
    rc = types == 0 ? bwd<float, float>(x, gamma, mu, rstd, dy, dx, part, N,
                                        C, chunk, s)
         : types == 1
             ? bwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, mu, rstd, dy, dx,
                                                 part, N, C, chunk, s)
             : bwd<__nv_bfloat16, float>(x, gamma, mu, rstd, dy, dx, part, N,
                                         C, chunk, s);
  }
  if (rc != 0) return rc;
  return lnv::launch_colsum(part, dgdb, parts, C, s);
}
