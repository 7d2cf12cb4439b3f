// Skip-gram negative-sampling scores for Hopper (sm_90a): for each row b
// of a batch of (center, positive, K negatives) triples,
//   pos_score[b]    = sigmoid(sum_d c[b, d] * pos[b, d])
//   neg_score[b, k] = sigmoid(sum_d c[b, d] * neg[b, k, d])
// accumulated in f32, the sigmoid taken in f32, each result rounded once to
// the input type (as the TPU kernel's out_shape sets it).
//
// Replaces the TPU kernel (deeplearning4j_tpu/ops/fused_neg_softmax.py)
//   `_neg_softmax_pallas` -> `_neg_softmax_kernel` (K13), the scoring of
//   the embedding engine's SGNS step.
//
// Shapes: c, pos [B, D], neg [B, K, D], all one type (f32 or bf16),
// row-major contiguous; pos_score [B] and neg_score [B, K] in that type.
// Any B >= 1, K >= 1 and D >= 1: the TPU's lane-tile envelope (D % 128,
// B % 8, K <= 128, and the [B, 128] padded score tile) has no counterpart.
//
// Design. One warp per row b, eight rows per block. The warp walks D in
// slices of 32 x VEC elements (VEC = 16 bytes per lane: 4 f32 or 8 bf16,
// when D is a multiple of VEC and the pointers are 16-byte aligned; one
// element per lane otherwise). Per slice it loads the c row's piece once
// and takes it against up to KT = 8 of the K + 1 scored rows, each lane
// keeping KT partial sums in registers; at K <= 7 (the word2vec paths
// use K = 5) c is read once per row. A butterfly of warp shuffles sums
// each partial, and lane i writes the sigmoid of row i's sum.
//
// What bounds it. Each row does 2 * (K + 1) * D FLOPs against
// (K + 2) * D elements read: about one FLOP per byte in f32, far below the
// card's ridge, so the least time is the bytes over the memory rate. The
// gathered rows come from the caller's indexing (syn0[center],
// syn1neg[context], syn1neg[negatives]); reading the tables by index here
// and fusing the scatter update are the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr int NTHREADS = WARPS * 32;
constexpr int KT = 8;     // scored rows per pass over c

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

// VEC consecutive elements at p as f32 (p is VEC-aligned when VEC > 1)
template <typename T, int VEC> struct Load;
template <typename T> struct Load<T, 1> {
  __device__ __forceinline__ static void run(const T* p, float* out) {
    out[0] = to_float(*p);
  }
};
template <> struct Load<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <> struct Load<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    neg_softmax_kernel(const T* __restrict__ c, const T* __restrict__ pos,
                       const T* __restrict__ neg, T* __restrict__ pos_out,
                       T* __restrict__ neg_out, int B, int K, int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const T* crow = c + (size_t)b * D;
  const int rows = K + 1;  // row 0: the positive, rows 1..K: the negatives
  for (int r0 = 0; r0 < rows; r0 += KT) {
    float acc[KT];
#pragma unroll
    for (int i = 0; i < KT; ++i) acc[i] = 0.f;
    for (int d = lane * VEC; d < D; d += 32 * VEC) {
      float cv[VEC];
      Load<T, VEC>::run(crow + d, cv);
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int r = r0 + i;
        if (r < rows) {
          const T* row = r == 0 ? pos + (size_t)b * D
                                : neg + ((size_t)b * K + (r - 1)) * D;
          float rv[VEC];
          Load<T, VEC>::run(row + d, rv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[i] = fmaf(cv[v], rv[v], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      float s = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int r = r0 + i;
      if (lane == i && r < rows) {
        const T out = from_float<T>(1.f / (1.f + expf(-s)));
        if (r == 0)
          pos_out[b] = out;
        else
          neg_out[(size_t)b * K + (r - 1)] = out;
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int VEC>
int launch(const void* c, const void* pos, const void* neg, void* pos_out,
           void* neg_out, int B, int K, int D, cudaStream_t stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  const bool vec = VEC > 1 && D % VEC == 0 && aligned16(c) &&
                   aligned16(pos) && aligned16(neg);
  if (vec)
    neg_softmax_kernel<T, VEC><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(c), static_cast<const T*>(pos),
        static_cast<const T*>(neg), static_cast<T*>(pos_out),
        static_cast<T*>(neg_out), B, K, D);
  else
    neg_softmax_kernel<T, 1><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(c), static_cast<const T*>(pos),
        static_cast<const T*>(neg), static_cast<T*>(pos_out),
        static_cast<T*>(neg_out), B, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on success, a cudaError_t
// from the launch, or -1 for arguments the kernel does not take.
extern "C" int neg_softmax(const void* c, const void* pos, const void* neg,
                           void* pos_out, void* neg_out, int dtype, int B,
                           int K, int D, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 4>(c, pos, neg, pos_out, neg_out, B, K, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 8>(c, pos, neg, pos_out, neg_out, B, K, D,
                                    s);
  return -1;
}
