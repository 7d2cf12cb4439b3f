// Fused sampling for Hopper (sm_90a): one token id per row of logits
// [B, V], the Gumbel-perturbed argmax over the temperature-scaled logits'
// top-k / top-p kept set. Per row, in f32:
//   m = max_j l[j],  z[j] = (l[j] - m) / T
//   top k (when 0 < k < V): lo = min z - 1, hi = 1e-6; 24 times
//     mid = 0.5 (lo + hi); count(z >= mid) >= k ? lo = mid : hi = mid;
//     keep z >= lo
//   top p (when 0 < p < 1): P[j] = exp(z[j]) / sum exp(z); lo = 0,
//     hi = max P + 1e-6; 24 times mid = 0.5 (lo + hi);
//     sum_{P >= mid} P >= p ? lo = mid : hi = mid; keep P >= lo
//   score[j] = keep ? z[j] + noise[j] : -1e30; the first index of the max.
//
// Replaces the TPU kernel (deeplearning4j_tpu/ops/fused_sampling.py)
//   `_sample_pallas` -> `_sample_kernel` (K12), whose body is
//   `_select_body`. The arithmetic is that body's, operation for
//   operation: IEEE division (__fdiv_rn) and expf, no fast-math build, so
//   z, the counts and the top-k threshold equal the plain PyTorch
//   version's bit for bit. Only the top-p mass is a float sum whose order
//   differs (a block reduction here), so where a row's nucleus mass lands
//   within an ulp of p the kept set can differ by a boundary token.
//
// Shapes: logits [B, V] f32 or bf16, noise [B, V] f32, out [B] int32, all
// row-major contiguous. Any B >= 1 and V >= 1: the TPU's (8, 128) tiling
// envelope has no counterpart here.
//
// Design. One block of 256 threads per row. The row's z stays in dynamic
// shared memory when it fits (V * 4 bytes up to 160 KB; the flagship's
// V = 10000 is 40 KB); a longer row recomputes z from the logits in global
// memory on each pass (the same operations, so the same values). Each
// bisection step is one block reduction: a butterfly of warp shuffles,
// then the eight warp results read by every thread in one fixed order, so
// every thread holds the same lo/hi without a broadcast. P is recomputed
// from z on each top-p pass (expf and one division) instead of being
// stored. The argmax reduces (score, index) pairs, the lower index
// winning ties.
//
// What bounds it. The function reads logits and noise once and writes B
// ids: (elem + 4) bytes per element. The work per element is the compare
// and add of each bisection pass (48 passes with both filters on) and,
// for top-p, one expf, all on the CUDA cores. At V = 10000 the bytes take
// about 24 ns per row at 3.35 TB/s (f32 logits), the f32 operations about
// 15 ns at 67 TFLOP/s. This kernel is far from that: at the batch sizes
// serving gives it (B <= 32) the card is far from full (one block per
// row), the 48 block reductions run in sequence, each with two
// __syncthreads, and the top-p passes, which recompute an expf and a
// division per element on every pass, cost the most. Keeping P in shared
// memory beside z, spreading a row over several blocks, or bisecting on a
// histogram is the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BISECT_STEPS = 24;
constexpr float NEG_INF = -1e30f;
// z rows up to this many bytes stay in shared memory
constexpr int MAX_SMEM_BYTES = 160 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Block-wide reductions. Every thread returns the same value: the warp
// results are combined by every thread in warp order. `red` is reused by
// the next reduction only after the trailing __syncthreads.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = __fadd_rn(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_count(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

template <bool MAX>
__device__ __forceinline__ float block_extreme(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : fminf(v, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w)
    r = MAX ? fmaxf(r, red[w]) : fminf(r, red[w]);
  __syncthreads();
  return r;
}

// (score, index) with the larger score winning, the lower index on ties
__device__ __forceinline__ void better(float& s, int& i, float so, int io) {
  if (so > s || (so == s && io < i)) {
    s = so;
    i = io;
  }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(NTHREADS)
    sample_kernel(const T* __restrict__ logits,
                  const float* __restrict__ noise, int* __restrict__ out,
                  int V, float temperature, int top_k, float top_p) {
  extern __shared__ float zs[];
  __shared__ float red_f[NWARPS];
  __shared__ int red_i[NWARPS];
  const int tid = threadIdx.x;
  const T* l = logits + (size_t)blockIdx.x * V;
  const float* nz = noise + (size_t)blockIdx.x * V;

  float m = -INFINITY;
  for (int j = tid; j < V; j += NTHREADS) m = fmaxf(m, to_float(l[j]));
  m = block_extreme<true>(m, red_f);

  auto z_of = [&](int j) -> float {
    if constexpr (SMEM) return zs[j];
    return __fdiv_rn(__fsub_rn(to_float(l[j]), m), temperature);
  };
  float zmin = INFINITY;
  for (int j = tid; j < V; j += NTHREADS) {
    const float z = __fdiv_rn(__fsub_rn(to_float(l[j]), m), temperature);
    if constexpr (SMEM) zs[j] = z;
    zmin = fminf(zmin, z);
  }
  __syncthreads();

  const bool use_k = top_k > 0;
  float thr_k = 0.f;
  if (use_k) {
    float lo = __fsub_rn(block_extreme<false>(zmin, red_f), 1.0f);
    float hi = 1e-6f;
    for (int step = 0; step < BISECT_STEPS; ++step) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int cnt = 0;
      for (int j = tid; j < V; j += NTHREADS) cnt += z_of(j) >= mid;
      if (block_count(cnt, red_i) >= top_k)
        lo = mid;
      else
        hi = mid;
    }
    thr_k = lo;
  }

  const bool use_p = top_p < 1.0f;
  float thr_p = 0.f, denom = 1.f;
  if (use_p) {
    float s = 0.f;
    for (int j = tid; j < V; j += NTHREADS) s = __fadd_rn(s, expf(z_of(j)));
    denom = block_sum(s, red_f);
    float pmax = 0.f;
    for (int j = tid; j < V; j += NTHREADS)
      pmax = fmaxf(pmax, __fdiv_rn(expf(z_of(j)), denom));
    float lo = 0.f;
    float hi = __fadd_rn(block_extreme<true>(pmax, red_f), 1e-6f);
    for (int step = 0; step < BISECT_STEPS; ++step) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      float mass = 0.f;
      for (int j = tid; j < V; j += NTHREADS) {
        const float p = __fdiv_rn(expf(z_of(j)), denom);
        if (p >= mid) mass = __fadd_rn(mass, p);
      }
      if (block_sum(mass, red_f) >= top_p)
        lo = mid;
      else
        hi = mid;
    }
    thr_p = lo;
  }

  float best = -INFINITY;
  int best_j = V;
  for (int j = tid; j < V; j += NTHREADS) {
    const float z = z_of(j);
    bool keep = !use_k || z >= thr_k;
    if (use_p) keep = keep && __fdiv_rn(expf(z), denom) >= thr_p;
    better(best, best_j, keep ? __fadd_rn(z, nz[j]) : NEG_INF, j);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, best, off);
    const int io = __shfl_xor_sync(0xffffffffu, best_j, off);
    better(best, best_j, so, io);
  }
  if ((tid & 31) == 0) {
    red_f[tid >> 5] = best;
    red_i[tid >> 5] = best_j;
  }
  __syncthreads();
  if (tid == 0) {
    float s = red_f[0];
    int i = red_i[0];
    for (int w = 1; w < NWARPS; ++w) better(s, i, red_f[w], red_i[w]);
    out[blockIdx.x] = i;
  }
}

template <typename T>
int launch(const void* logits, const void* noise, void* out, int B, int V,
           float temperature, int top_k, float top_p, cudaStream_t stream) {
  const size_t zbytes = (size_t)V * sizeof(float);
  if (zbytes <= (size_t)MAX_SMEM_BYTES) {
    static bool attr_set = false;  // once per instantiation
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          sample_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          MAX_SMEM_BYTES);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    sample_kernel<T, true><<<B, NTHREADS, zbytes, stream>>>(
        static_cast<const T*>(logits), static_cast<const float*>(noise),
        static_cast<int*>(out), V, temperature, top_k, top_p);
  } else {
    sample_kernel<T, false><<<B, NTHREADS, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const float*>(noise),
        static_cast<int*>(out), V, temperature, top_k, top_p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16. top_k = 0 and top_p = 1 switch
// the two filters off (the wrapper decides, as the JAX package does).
// Returns 0 on success, a cudaError_t from the launch, or -1 for
// arguments the kernel does not take.
extern "C" int fused_sample(const void* logits, const void* noise, void* out,
                            int dtype, int B, int V, float temperature,
                            int top_k, float top_p, void* stream) {
  if (B <= 0 || V <= 0 || !(temperature > 0.f) || top_k < 0 || top_k >= V)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, noise, out, B, V, temperature, top_k, top_p,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, noise, out, B, V, temperature, top_k,
                                 top_p, s);
  return -1;
}
