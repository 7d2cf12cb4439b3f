// Fused softmax cross-entropy head for Hopper (sm_90a): per-token loss of
// softmax(x @ W + b) against integer labels, and its three gradients,
// without writing the [N, V] logits to device memory.
//
// Replaces the TPU kernels (deeplearning4j_tpu/ops/fused_softmax_xent.py)
//   `_fused_fwd` -> `_fwd_kernel` (K8): loss and lse, online over vocab
//     chunks;
//   `_fused_bwd` -> `_dx_kernel` and `_dwdb_kernel` (K9):
//     dx = ((p - onehot) * g) @ W^T, dW = x^T @ ((p - onehot) * g),
//     db = column sums of (p - onehot) * g,
//   recomputing each logits chunk from (x, W, b, lse).
//
// Shapes: x [N, d], W [d, V], b [V] (all one type, f32 or bf16, row-major
// contiguous); labels [N] int32 in [0, V); lse, g (the loss cotangent)
// and loss [N] f32. Any N and any V: rows past N and columns past V are
// masked inside the kernels (no padded copy of W, unlike the TPU wrapper,
// which pads V to a whole number of chunks every step). d must be a
// multiple of 32.
//
// Design. A logits tile is 64 rows x 64 vocab columns, formed in
// registers (4x4 per thread of 256) from 32-wide slices of x and W staged
// in shared memory as f32; all softmax math and every accumulator is f32,
// and results are rounded once to the output type.
//   fwd: one block per 64-row block; it walks the vocab in 64-column
//        chunks keeping the running max, sum and label logit per row
//        (16 lanes share a row and reduce with shuffles).
//   dx:  one block per (64-row block, 256-column slice of d); per vocab
//        chunk it forms G = (p - onehot) * g in shared memory and
//        accumulates G @ W[slice, chunk]^T in registers (4 x 16 each).
//   dW:  one block per (64-column vocab chunk, 256-row slice of d); it
//        walks the row blocks, forms G and accumulates x[:, slice]^T @ G
//        in registers (16 x 4 each) and the column sums of G (db).
// At d <= 256 there is one slice; a wider d recomputes the logits once
// per slice.
//
// What bounds it. The forward does 2*N*d*V FLOPs and each backward
// kernel 4*N*d*V (recompute plus product) against (N*d + d*V) elements
// read: at the flagship (N = 16384, d = 256, V = 10000) that is hundreds
// of FLOPs per byte, above the bf16 ridge, so the card's least time is
// set by operations. This kernel runs them on the scalar f32 FMA units,
// not the tensor cores, so it is far from that bound; mma/wgmma tiles
// fed by TMA are the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BN = 64;    // rows per tile
constexpr int BV = 64;    // vocab columns per chunk
constexpr int KS = 32;    // depth of one staged slice of x and W
constexpr int DT = 256;   // d columns per dx / dW block
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;
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
  const void* x;
  const void* w;
  const void* b;
  const int* labels;
  const float* lse;  // bwd input
  const float* g;    // bwd input (loss cotangent)
  float* loss;       // fwd output
  float* lse_out;    // fwd output
  void* dx;
  void* dw;
  float* db;
  int N, d, V;
};

// logits of rows n0.., columns v0.. into s (rows ty + 16i, columns
// tx + 16j); columns past V get NEG_INF, rows past N are zero.
template <typename T>
__device__ __forceinline__ void logits_tile(const Args& a, int n0, int v0,
                                            float* Xs, float* Ws,
                                            float s[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < a.d; k0 += KS) {
    __syncthreads();  // earlier readers of Xs, Ws (and the caller's tiles)
    for (int i = tid; i < BN * KS; i += NTHREADS) {
      const int r = i / KS, c = i % KS;
      const int n = n0 + r;
      Xs[r * (KS + 1) + c] =
          n < a.N ? to_float(x[(long long)n * a.d + k0 + c]) : 0.f;
    }
    for (int i = tid; i < KS * BV; i += NTHREADS) {
      const int r = i / BV, c = i % BV;
      const int v = v0 + c;
      Ws[r * (BV + 1) + c] =
          v < a.V ? to_float(w[(long long)(k0 + r) * a.V + v]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * (KS + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk * (BV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], wv[j], s[i][j]);
    }
  }
  const T* bias = static_cast<const T*>(a.b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = v0 + tx + 16 * j;
    const float bj = v < a.V ? to_float(bias[v]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][j] = v < a.V ? s[i][j] + bj : NEG_INF;
  }
}

// G = (softmax - onehot) * g for the tile, into Gs[row][col]; zero past
// N and V. lab_s, lse_s, g_s hold the tile's rows.
__device__ __forceinline__ void grad_tile(const Args& a, int n0, int v0,
                                          const float s[4][4],
                                          const int* lab_s,
                                          const float* lse_s,
                                          const float* g_s, float* Gs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int v = v0 + c;
      float gv = 0.f;
      if (n0 + r < a.N && v < a.V) {
        const float p = expf(s[i][j] - lse_s[r]);
        gv = (p - (v == lab_s[r] ? 1.f : 0.f)) * g_s[r];
      }
      Gs[r * (BV + 1) + c] = gv;
    }
  }
}

__device__ __forceinline__ void load_rows(const Args& a, int n0, int* lab_s,
                                          float* lse_s, float* g_s) {
  const int tid = threadIdx.x;
  if (tid < BN) {
    const int n = n0 + tid;
    const bool in = n < a.N;
    lab_s[tid] = in ? a.labels[n] : -1;
    if (lse_s) lse_s[tid] = in ? a.lse[n] : 0.f;
    if (g_s) g_s[tid] = in ? a.g[n] : 0.f;
  }
}

constexpr size_t logits_smem() {
  return sizeof(float) * (BN * (KS + 1) + KS * (BV + 1));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) xent_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Ws = Xs + BN * (KS + 1);
  int* lab_s = reinterpret_cast<int*>(Ws + KS * (BV + 1));
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * BN;
  load_rows(a, n0, lab_s, nullptr, nullptr);

  float m[4], l[4], ll[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    ll[i] = 0.f;
  }
  for (int v0 = 0; v0 < a.V; v0 += BV) {
    float s[4][4];
    logits_tile<T>(a, n0, v0, Xs, Ws, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lab = lab_s[ty + 16 * i];
      float cmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float m_new = fmaxf(m[i], cmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum += expf(s[i][j] - m_new);
        if (v0 + tx + 16 * j == lab) ll[i] += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = ll[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    const int n = n0 + ty + 16 * i;
    if (tx == 0 && n < a.N) {
      const float lse = m[i] + logf(fmaxf(l[i], L_FLOOR));
      a.lse_out[n] = lse;
      a.loss[n] = lse - t;
    }
  }
}

constexpr size_t dx_smem() {
  return logits_smem() +
         sizeof(float) * (BN * (BV + 1) + DT * (BV + 1) + 3 * BN);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) xent_dx_kernel(Args a) {
  constexpr int NJ = DT / 16;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Ws = Xs + BN * (KS + 1);
  float* Gs = Ws + KS * (BV + 1);
  float* Wt = Gs + BN * (BV + 1);   // [DT][BV+1]: W[c0 + cc][v0 + vv]
  float* lse_s = Wt + DT * (BV + 1);
  float* g_s = lse_s + BN;
  int* lab_s = reinterpret_cast<int*>(g_s + BN);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * DT;
  const T* w = static_cast<const T*>(a.w);
  load_rows(a, n0, lab_s, lse_s, g_s);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < a.V; v0 += BV) {
    float s[4][4];
    logits_tile<T>(a, n0, v0, Xs, Ws, s);
    grad_tile(a, n0, v0, s, lab_s, lse_s, g_s, Gs);
    for (int i = tid; i < DT * BV; i += NTHREADS) {
      const int cc = i / BV, vv = i % BV;
      const int c = c0 + cc, v = v0 + vv;
      Wt[cc * (BV + 1) + vv] =
          (c < a.d && v < a.V) ? to_float(w[(long long)c * a.V + v]) : 0.f;
    }
    __syncthreads();
    // acc[r][c] += sum_v G[r][v] * W[c][v]
#pragma unroll 4
    for (int vv = 0; vv < BV; ++vv) {
      float gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = Gs[(ty + 16 * i) * (BV + 1) + vv];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float wv = Wt[(tx + 16 * j) * (BV + 1) + vv];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(gv[i], wv, acc[i][j]);
      }
    }
    // the next chunk's logits_tile syncs before Gs and Wt are rewritten
  }
  T* dx = static_cast<T*>(a.dx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= a.N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < a.d) dx[(long long)n * a.d + c] = from_float<T>(acc[i][j]);
    }
  }
}

constexpr size_t dw_smem() {
  return logits_smem() +
         sizeof(float) * (BN * (BV + 1) + BN * (DT + 1) + 3 * BN);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) xent_dwdb_kernel(Args a) {
  constexpr int NI = DT / 16;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Ws = Xs + BN * (KS + 1);
  float* Gs = Ws + KS * (BV + 1);
  float* Xt = Gs + BN * (BV + 1);   // [BN][DT+1]: x[n0 + r][c0 + cc]
  float* lse_s = Xt + BN * (DT + 1);
  float* g_s = lse_s + BN;
  int* lab_s = reinterpret_cast<int*>(g_s + BN);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int v0 = blockIdx.x * BV;
  const int c0 = blockIdx.y * DT;
  const T* x = static_cast<const T*>(a.x);

  // dW[c0 + ty + 16i][v0 + tx + 16j]
  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float db = 0.f;

  for (int n0 = 0; n0 < a.N; n0 += BN) {
    // the previous block of rows' readers of lab_s, Gs, Xt passed the
    // __syncthreads before its product
    load_rows(a, n0, lab_s, lse_s, g_s);
    float s[4][4];
    logits_tile<T>(a, n0, v0, Xs, Ws, s);
    grad_tile(a, n0, v0, s, lab_s, lse_s, g_s, Gs);
    for (int i = tid; i < BN * DT; i += NTHREADS) {
      const int r = i / DT, cc = i % DT;
      const int n = n0 + r, c = c0 + cc;
      Xt[r * (DT + 1) + cc] =
          (n < a.N && c < a.d) ? to_float(x[(long long)n * a.d + c]) : 0.f;
    }
    __syncthreads();
    if (tid < BV) {
      float t = 0.f;
      for (int r = 0; r < BN; ++r) t += Gs[r * (BV + 1) + tid];
      db += t;
    }
#pragma unroll 4
    for (int r = 0; r < BN; ++r) {
      float gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = Gs[r * (BV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float xv = Xt[r * (DT + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, gv[j], acc[i][j]);
      }
    }
    __syncthreads();  // readers of lab_s, Gs and Xt are done
  }
  T* dw = static_cast<T*>(a.dw);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= a.d) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (v < a.V) dw[(long long)c * a.V + v] = from_float<T>(acc[i][j]);
    }
  }
  if (blockIdx.y == 0 && tid < BV && v0 + tid < a.V) a.db[v0 + tid] = db;
}

bool bad_shape(int N, int d, int V) {
  return N <= 0 || V <= 0 || d <= 0 || d % KS != 0;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns 0 on success, a
// cudaError_t from the launch, or -1 for arguments the kernel does not
// take.

extern "C" int xent_fwd(const void* x, const void* w, const void* b,
                        const int* labels, float* loss, float* lse,
                        int dtype, int N, int d, int V, void* stream) {
  if (bad_shape(N, d, V)) return -1;
  Args a{};
  a.x = x;
  a.w = w;
  a.b = b;
  a.labels = labels;
  a.loss = loss;
  a.lse_out = lse;
  a.N = N;
  a.d = d;
  a.V = V;
  const dim3 grid((N + BN - 1) / BN);
  const size_t smem = logits_smem() + sizeof(int) * BN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(xent_fwd_kernel<float>, grid, smem, a, s);
  if (dtype == 1)
    return launch(xent_fwd_kernel<__nv_bfloat16>, grid, smem, a, s);
  return -1;
}

extern "C" int xent_bwd_dx(const void* x, const void* w, const void* b,
                           const int* labels, const float* lse,
                           const float* g, void* dx, int dtype, int N, int d,
                           int V, void* stream) {
  if (bad_shape(N, d, V)) return -1;
  Args a{};
  a.x = x;
  a.w = w;
  a.b = b;
  a.labels = labels;
  a.lse = lse;
  a.g = g;
  a.dx = dx;
  a.N = N;
  a.d = d;
  a.V = V;
  const dim3 grid((N + BN - 1) / BN, (d + DT - 1) / DT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(xent_dx_kernel<float>, grid, dx_smem(), a, s);
  if (dtype == 1)
    return launch(xent_dx_kernel<__nv_bfloat16>, grid, dx_smem(), a, s);
  return -1;
}

extern "C" int xent_bwd_dwdb(const void* x, const void* w, const void* b,
                             const int* labels, const float* lse,
                             const float* g, void* dw, float* db, int dtype,
                             int N, int d, int V, void* stream) {
  if (bad_shape(N, d, V)) return -1;
  Args a{};
  a.x = x;
  a.w = w;
  a.b = b;
  a.labels = labels;
  a.lse = lse;
  a.g = g;
  a.dw = dw;
  a.db = db;
  a.N = N;
  a.d = d;
  a.V = V;
  const dim3 grid((V + BV - 1) / BV, (d + DT - 1) / DT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(xent_dwdb_kernel<float>, grid, dw_smem(), a, s);
  if (dtype == 1)
    return launch(xent_dwdb_kernel<__nv_bfloat16>, grid, dw_smem(), a, s);
  return -1;
}
