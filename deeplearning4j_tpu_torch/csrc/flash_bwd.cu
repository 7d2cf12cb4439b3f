// Flash-attention backward for Hopper (sm_90a): one source for the flat
// [BH, T, D] layout and the packed [B, T, 3n] projection layout, at any
// T that is a multiple of 64.
//
// Replaces the TPU kernels (deeplearning4j_tpu/ops/flash_attention.py)
//   `_flash_bwd_fused` -> `_bwd_fused_kernel` (flat, T <= 512; K4),
//   `_flash_bwd_impl` -> `_dq_kernel` + `_dkv_kernel` (flat, T past one
//     block; K5),
//   `_flash_bwd_qkv` -> `_bwd_fused_kernel(packed_heads=True)` (packed,
//     D = 128; K6), and
//   `_flash_bwd_qkv_pair` -> `_bwd_kernel_pair` (packed, D = 64; K7).
// The TPU needs four bodies because its single-block kernels hold the
// whole sequence in VMEM (T <= 512) and its 128-lane tile cannot address
// a 64-wide head. Neither limit exists here: the kernels below tile both
// the query and the key range and address each head through strides.
//
// What it computes, per (batch b, head h), with s_ij = sm_scale*q_i.k_j
// set to NEG_INF (-1e30) where j > i (causal) or the key mask is <= 0:
//   p_ij    = exp(s_ij - lse_i)             (lse from the forward, f32)
//   delta_i = sum_d do_id * o_id            (computed here, f32)
//   dp_ij   = do_i . v_j
//   ds_ij   = p_ij * (dp_ij - delta_i) * sm_scale
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i
// with every product and sum in f32 and the results rounded once to the
// input type. A row whose keys are all masked has lse ~= -1e20 from the
// forward, so its p is exp(-1e30 + 1e20) = 0 and its gradients are zero;
// a masked key gets p = 0 in every row, so its dk and dv are zero.
//
// Layouts: q, k, v, o, do, dq, dk, dv are addressed as
// base + b*sb + h*sh + t*st + d with element strides from the caller, so
// the packed route reads q|k|v as column slices of [B, T, 3n] and writes
// dq|dk|dv into one [B, T, 3n] gradient in place (no concatenate). lse
// and the delta scratch are [B*H, T] f32; the key mask is [B, T] f32.
//
// Design: the FA2 split, three launches on one stream.
//   1. delta: one warp per (b, h, t) row.
//   2. dk/dv: one block of 256 threads per (64-key tile, b*h). K and V
//      stay in shared memory as f32; 64-query tiles of Q and dO stream
//      through it from the causal bound (the key tile's own index) to T.
//      dk and dv accumulate in registers (4 x D/16 each per thread).
//   3. dq: one block per (64-query tile, b*h); Q and dO stay resident,
//      K and V tiles stream up to the causal bound; dq in registers.
// Each recomputes the 64x64 score and dp tiles with scalar f32 FMAs
// (4x4 per thread) and exchanges p and ds through shared memory; rows
// are padded by one float against bank conflicts.
//
// What bounds it. The function reads q, k, v, o, do and writes dq, dk,
// dv once: 8*T*D elements per (b, h), against about 4*D*T*T causal
// FLOPs (five T x T x D products over the causal half). That is T/2
// FLOPs per bf16 byte, below the H100's ~295 bf16 ridge for T = 512, so
// the card's least time is set by memory. This kernel is bound by
// neither: its products run on the scalar FMA units (no tensor cores),
// and dq recomputes the score tiles that dk/dv already formed. mma/wgmma
// tiles and one pass with atomic dq are the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

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

// element strides (batch, head, token) of one tensor
struct Strides {
  long long b, h, t;
};

enum { Q = 0, K, V, O, DO, DQ, DK, DV, NT };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // [B*H, T]
  const float* kmask;  // [B, T] or null
  float* delta;        // [B*H, T] scratch
  void* dq;
  void* dk;
  void* dv;
  int B, H, T;
  Strides st[NT];
  float sm_scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s,
                                       int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* at_mut(void* base, const Strides& s, int b,
                                     int h) {
  return static_cast<T*>(base) + b * s.b + h * s.h;
}

// delta[bh, t] = sum_d do[t, d] * o[t, d]: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) delta_kernel(Args a) {
  const long long row =
      ((long long)blockIdx.x * NTHREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.B * a.H * a.T;
  if (row >= rows) return;  // whole warps leave together
  const int t = (int)(row % a.T);
  const int bh = (int)(row / a.T);
  const int b = bh / a.H, h = bh % a.H;
  const T* op = at<T>(a.o, a.st[O], b, h) + (long long)t * a.st[O].t;
  const T* gp = at<T>(a.dout, a.st[DO], b, h) + (long long)t * a.st[DO].t;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s += to_float(op[d]) * to_float(gp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// a [64, D] tile of rows r0.. of a strided tensor into shared memory (f32)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0) {
  for (int i = threadIdx.x; i < 64 * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = to_float(src[(long long)(r0 + r) * st + c]);
  }
}

// s = Qt . Kt^T and dp = dOt . Vt^T on a 64 x 64 tile: rows ty + 16i,
// columns tx + 16j. Then p and ds into shared memory ([row][col]).
template <int D>
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* dl_s, const float* km_s, float* Ps,
    float* dSs, int q0, int k0, bool masked, const Args& a) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      gv[i] = dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float x = a.sm_scale * s[i][j];
      if (a.causal && k0 + c > q0 + r) x = NEG_INF;
      if (masked && !(km_s[c] > 0.f)) x = NEG_INF;
      const float p = expf(x - lse_s[r]);
      Ps[r * (BK + 1) + c] = p;
      dSs[r * (BK + 1) + c] = p * (dp[i][j] - dl_s[r]) * a.sm_scale;
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // four [64][D+1] tiles, p and ds [64][65], lse, delta, key mask
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (BK + 1) + 3 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(Args a) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * (D + 1);
  float* Qs = Vs + BK * (D + 1);
  float* dOs = Qs + BQ * (D + 1);
  float* Ps = dOs + BQ * (D + 1);
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* dl_s = lse_s + BQ;
  float* km_s = dl_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const bool masked = a.kmask != nullptr;

  const T* qp = at<T>(a.q, a.st[Q], b, h);
  const T* kp = at<T>(a.k, a.st[K], b, h);
  const T* vp = at<T>(a.v, a.st[V], b, h);
  const T* gp = at<T>(a.dout, a.st[DO], b, h);

  load_tile<T, D>(Ks, kp, a.st[K].t, k0);
  load_tile<T, D>(Vs, vp, a.st[V].t, k0);
  if (tid < BK)
    km_s[tid] = masked ? a.kmask[(long long)b * a.T + k0 + tid] : 1.f;

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_qt = a.T / BQ;
  for (int qt = a.causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers of Qs, dOs, Ps are done
    load_tile<T, D>(Qs, qp, a.st[Q].t, q0);
    load_tile<T, D>(dOs, gp, a.st[DO].t, q0);
    if (tid < BQ) {
      lse_s[tid] = a.lse[(long long)bh * a.T + q0 + tid];
      dl_s[tid] = a.delta[(long long)bh * a.T + q0 + tid];
    }
    __syncthreads();
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, km_s, Ps, dSs, q0, k0,
                 masked, a);
    __syncthreads();
    // dv[c] += sum_r p[r][c] do[r];  dk[c] += sum_r ds[r][c] q[r]
    // (keys c = ty + 16i, head columns tx + 16j)
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * (BK + 1) + ty + 16 * i];
        sv[i] = dSs[r * (BK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = dOs[r * (D + 1) + tx + 16 * j];
        const float qv = Qs[r * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], g, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
        }
      }
    }
  }

  T* dkp = at_mut<T>(a.dk, a.st[DK], b, h);
  T* dvp = at_mut<T>(a.dv, a.st[DV], b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[t * a.st[DK].t + tx + 16 * j] = from_float<T>(dk[i][j]);
      dvp[t * a.st[DV].t + tx + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(Args a) {
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (D + 1);
  float* Ks = dOs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ps = Vs + BK * (D + 1);
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* dl_s = lse_s + BQ;
  float* km_s = dl_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const bool masked = a.kmask != nullptr;

  const T* kp = at<T>(a.k, a.st[K], b, h);
  const T* vp = at<T>(a.v, a.st[V], b, h);
  load_tile<T, D>(Qs, at<T>(a.q, a.st[Q], b, h), a.st[Q].t, q0);
  load_tile<T, D>(dOs, at<T>(a.dout, a.st[DO], b, h), a.st[DO].t, q0);
  if (tid < BQ) {
    lse_s[tid] = a.lse[(long long)bh * a.T + q0 + tid];
    dl_s[tid] = a.delta[(long long)bh * a.T + q0 + tid];
  }

  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int n_kt = a.causal ? qt + 1 : a.T / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, dSs are done
    load_tile<T, D>(Ks, kp, a.st[K].t, k0);
    load_tile<T, D>(Vs, vp, a.st[V].t, k0);
    if (tid < BK)
      km_s[tid] = masked ? a.kmask[(long long)b * a.T + k0 + tid] : 1.f;
    __syncthreads();
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, km_s, Ps, dSs, q0, k0,
                 masked, a);
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]  (rows r = ty + 16i, columns tx + 16j)
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sv[i], kv, dq[i][j]);
      }
    }
  }

  T* dqp = at_mut<T>(a.dq, a.st[DQ], b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqp[t * a.st[DQ].t + tx + 16 * j] = from_float<T>(dq[i][j]);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.T;
  const long long warps_per_block = NTHREADS / 32;
  delta_kernel<T, D>
      <<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
         NTHREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.T / 64, a.B * a.H);
  dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// head, token) for q, k, v, o, do, dq, dk, dv in that order. Returns 0 on
// success, a cudaError_t from a launch, or -1 for arguments the kernels
// do not take.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* kmask, float* delta, void* dq,
                         void* dk, void* dv, int dtype, int D, int B, int H,
                         int T, const long long* strides, float sm_scale,
                         int causal, void* stream) {
  if (T <= 0 || T % 64 != 0 || B <= 0 || H <= 0 || B * H > 65535)
    return -1;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.kmask = kmask;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.T = T;
  for (int i = 0; i < NT; ++i)
    a.st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, s);
  if (dtype == 0 && D == 64) return launch<float, 64>(a, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(a, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(a, s);
  return -1;
}
