// Flash-attention forward for Hopper (sm_90a): one kernel for the flat
// [BH, T, D] layout and the packed [B, T, 3n] projection layout.
//
// Replaces the TPU kernels
//   deeplearning4j_tpu/ops/flash_attention.py `_flash_fwd` -> `_fwd_kernel`
//     (flat layout, optional key mask; K1 in PERF.md), and
//   `_flash_fwd_qkv` -> `_fwd_kernel(packed_heads=True)` (packed layout;
//     K2). At head_dim 64 the same kernel also computes the forward
//     function of `_flash_fwd_qkv_pair` / `_fwd_kernel_pair` (K3), which
//     exists on the TPU only to fit its 128-lane tile.
//
// What it computes, per (batch b, head h) and query row i:
//   s_ij = sm_scale * q_i . k_j, set to NEG_INF (-1e30) where j > i
//   (causal) or where the key mask is <= 0; online softmax over key tiles
//   with the running max m, sum l and accumulator kept in f32; when a key
//   mask is given the running max is floored at -1e20, so a row with every
//   key masked writes o = 0 and lse ~= -1e20 instead of a uniform average.
//   o_i = acc_i / max(l_i, 1e-30) in the input type; lse_i = m_i + log(l_i)
//   in f32. exp is taken in f32 throughout (the JAX single-block branch
//   takes it in the operand type, so bf16 results differ at bf16 rounding).
//
// Layouts: q, k, v and o are addressed as base + b*sb + h*sh + t*st + d,
// with element strides passed by the caller. The flat layout passes H = 1
// (sh unused); the packed layout passes the [B, T, 3n] strides with k and
// v pointing n and 2n columns into the projection, so neither layout is
// copied into a per-head relayout first. lse is [B*H, T] contiguous; the
// key mask, when given, is [B, T] f32 (row b).
//
// Design. One block of 256 threads per (64-query tile, b*h). The Q tile is
// staged once in shared memory as f32; 64-key tiles of K and V are
// streamed through shared memory up to the causal bound (tiles wholly
// above the diagonal are never read). Scores come from scalar f32 FMAs
// with a 4x4 register block per thread; the softmax pass uses 4 threads
// per row with warp shuffles; P.V accumulates into 4 x D/16 f32 registers
// per thread. Row padding (D+1, 64+1) keeps the shared-memory reads free
// of bank conflicts.
//
// What bounds it. Causal attention does about 2*D*T*T FLOPs per (b, h)
// against 8*T*D bytes of bf16 q, k, v and o, i.e. T/4 FLOPs per byte:
// below the H100's ~295 bf16 ridge at the serving lengths (T = 512..1024),
// so the card's least time for the function is set by memory. This first
// kernel is bound by neither: it uses no tensor cores (scalar f32 FMA) and
// at B*H = 2 launches only 16..32 blocks for 132 SMs. It keeps the traffic
// at the bound (each input element is read once per query tile, the
// scores never leave the SM); wgmma tiles, TMA loads and more blocks in
// flight are the later work that brings its time toward that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float MASK_FLOOR = -1e20f;
constexpr float L_FLOOR = 1e-30f;

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;  // [B, T] or null
  void* o;
  float* lse;          // [B*H, T]
  int H, T;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  float sm_scale;
  int causal;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ + BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Args a) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);       // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D]
  float* Ps = Vs + BK * D;             // [BQ][BK+1] scores, then p
  float* m_s = Ps + BQ * (BK + 1);     // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running sum
  float* a_s = l_s + BQ;               // [BQ] this tile's rescale factor
  float* km_s = a_s + BQ;              // [BK] this tile's key mask

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const bool masked = a.kmask != nullptr;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] = to_float(qp[(long long)(q0 + r) * a.q_st + c]);
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_tiles = a.T / BK;
  const int n_kt = a.causal ? min((q0 + BQ - 1) / BK + 1, n_tiles) : n_tiles;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      Ks[r * (D + 1) + c] = to_float(kp[(long long)(k0 + r) * a.k_st + c]);
      Vs[r * D + c] = to_float(vp[(long long)(k0 + r) * a.v_st + c]);
    }
    if (tid < BK)
      km_s[tid] = masked ? a.kmask[(long long)b * a.T + k0 + tid] : 1.f;
    __syncthreads();

    // scores: rows ty + 16*i, columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = a.sm_scale * s[i][j];
        if (a.causal && k0 + c > q0 + r) x = NEG_INF;
        if (masked && !(km_s[c] > 0.f)) x = NEG_INF;
        Ps[r * (BK + 1) + c] = x;
      }
    }
    __syncthreads();

    // online softmax: 4 neighbouring lanes share one row, 16 columns each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* prow = Ps + r * (BK + 1) + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      float m_new = fmaxf(m_old, mx);
      if (masked) m_new = fmaxf(m_new, MASK_FLOOR);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = fmaxf(l_s[r], L_FLOOR);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      op[(long long)(q0 + r) * a.o_st + tx + 16 * j] =
          from_float<T>(acc[i][j] / l);
  }
  if (tid < BQ)
    a.lse[(long long)bh * a.T + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], L_FLOOR));
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.T / BQ, B * a.H);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on success, a cudaError_t
// from the launch, or -1 for arguments the kernel does not take.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const float* kmask, void* o, float* lse, int dtype,
                         int D, int B, int H, int T, long long q_sb,
                         long long q_sh, long long q_st, long long k_sb,
                         long long k_sh, long long k_st, long long v_sb,
                         long long v_sh, long long v_st, long long o_sb,
                         long long o_sh, long long o_st, float sm_scale,
                         int causal, void* stream) {
  if (T <= 0 || T % BQ != 0 || B <= 0 || H <= 0 || B * H > 65535) return -1;
  Args a{q,    k,    v,    kmask, o,    lse,  H,    T,        q_sb,
         q_sh, q_st, k_sb, k_sh,  k_st, v_sb, v_sh, v_st,     o_sb,
         o_sh, o_st, sm_scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch<float, 64>(a, B, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(a, B, s);
  return -1;
}
