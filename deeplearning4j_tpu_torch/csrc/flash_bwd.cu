// Flash-attention backward for Hopper (sm_90a): one source for the flat
// [BH, T, D] layout and the packed [B, T, 3n] projection layout, at head
// dims 32, 64, 128 and 256 and any T that is a multiple of 64.
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
// with every sum in f32 (in bf16, p and ds are rounded to bf16 before the
// second products, where the JAX split kernels round them) and the
// results rounded once to the input type. A row whose keys are all
// masked has lse ~= -1e20 from the forward, so its p is
// exp(-1e30 + 1e20) = 0 and its gradients are zero;
// a masked key gets p = 0 in every row, so its dk and dv are zero.
//
// Layouts: q, k, v, o, do, dq, dk, dv are addressed as
// base + b*sb + h*sh + t*st + d with element strides from the caller, so
// the packed route reads q|k|v as column slices of [B, T, 3n] and writes
// dq|dk|dv into one [B, T, 3n] gradient in place (no concatenate). lse
// and the delta scratch are [B*H, T] f32; the key mask is [B, T] f32.
// The grids are one dimension: block x is (b*h, tile) with the tile in
// the low bits (the heaviest causal tile first), so B*H is bounded only
// by 2^31 blocks.
//
// Design: the FA2 split, three launches on one stream, in both types.
//   1. delta: one warp per (b, h, t) row.
//   2. dk/dv: one block per (64-key tile, b*h). K and V stay resident;
//      64-query tiles of Q and dO stream through from the causal bound
//      (the key tile's own index) to T.
//   3. dq: one block per (64-query tile, b*h); Q and dO stay resident,
//      K and V tiles stream up to the causal bound. dq recomputes the
//      score tiles that dk/dv formed (about 7/5 of the minimum FLOPs)
//      instead of adding dq with f32 atomics in the dk/dv pass: no
//      [B*H, T, D] f32 scratch, no conversion pass, and a run is
//      reproducible bit for bit.
//
// What bounds it. The function reads q, k, v, o, do and writes dq, dk,
// dv once: 8*T*D elements per (b, h), against five causal T x T x D
// products (s, dp, dv, dk, dq: about 5*D*T*T FLOPs). That is about
// 5T/16 FLOPs per bf16 byte: below the H100's ~295 bf16 ridge at
// T = 512 (the flagship's K6, bound by memory), above it at T = 4096
// (K5, bound by the tensor cores).
//
// bf16 (`tcf::dkv_tc`, `tcf::dq_tc`): every product is mma.sync
// m16n8k16 bf16 x bf16 -> f32, fed by ldmatrix (.trans for the
// operands stored K-major) from bf16 tiles in shared memory whose
// 16-byte chunks are XOR-swizzled by row (no padding, no bank
// conflicts). cp.async fills them in two stages: the next Q/dO (or
// K/V) tile, with its lse and delta (or key mask), loads while the
// current one multiplies. Blocks are 4 warps; a warp owns 16 rows (keys
// in dk/dv, queries in dq) of each 64 x 64 tile. In dk/dv a warp forms
// S^T = K Q^T and dP^T = V dO^T for its keys (2 x 8 accumulators of 4
// f32), turns them into P and dS in registers and, packed to bf16 (the
// JAX kernels' rounding points, `_dkv_kernel` and `_dq_kernel`), into
// the A fragments of dv += P^T dO and dk += dS^T Q; dk and dv stay in
// registers (2 x 16 x D f32 per warp: 128 a thread at D = 128). dq
// keeps 16 x D f32 per warp. Shared memory: six [64][D] bf16 tiles
// (96 KB at D = 128, 48 KB at D = 64, 24 KB at D = 32) and 1 KB of row
// data: two blocks an SM at D = 128. Registers a thread (ptxas, no
// spills): dk/dv 249 and dq 244 at D = 128, 196 and 217 at D = 64, so
// two blocks of 128 threads an SM. The wrapper checks that every base
// pointer and stride is 16-byte aligned, as the copies need. At D = 32
// the tiles' rows are 64 bytes, which `tc::swz` swizzles within their 4
// chunks.
//
// f32 (`dkv_kernel`, `dq_kernel`): scalar kernels on the CUDA cores,
// kept because TF32 tensor cores would not hold f32's 1e-4 agreement.
// 256 threads;
// K and V (or Q and dO) resident as f32, the BT x BT score and dp tiles
// formed with scalar FMAs (BT/16 x BT/16 a thread), p and ds exchanged
// through shared memory, rows padded by one float against bank
// conflicts. BT = 64, except at D = 256, where four [64][257] f32 tiles
// (263 KB) would not fit a block and the tensor-core kernels would hold
// 256 f32 of dk and dv a thread: there both types take these scalar
// kernels with BT = 32 (140,416 bytes of shared memory), and in bf16
// they round p and ds to bf16 before the second products as the tensor-
// core kernels do. That D = 256 pair is right, not fast: its redesign is
// queued (ROADMAP Queue B).

#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

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

// x rounded to T and back (the identity in f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
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

// (b*h, tile index) of this block: tiles in the low bits, in launch
// order `tile` (ascending) or its reverse
struct BlockTile {
  int bh, b, h, tile;
};

__device__ __forceinline__ BlockTile block_tile(const Args& a, int n_t,
                                                bool reverse) {
  const int i = (int)(blockIdx.x % n_t);
  const int bh = (int)(blockIdx.x / n_t);
  return BlockTile{bh, bh / a.H, bh % a.H, reverse ? n_t - 1 - i : i};
}

// a [BT, D] tile of rows r0.. of a strided tensor into shared memory (f32)
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0) {
  for (int i = threadIdx.x; i < BT * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = to_float(src[(long long)(r0 + r) * st + c]);
  }
}

// s = Qt . Kt^T and dp = dOt . Vt^T on a BT x BT tile: rows ty + 16i,
// columns tx + 16j. Then p and ds (rounded to T, as the tensor-core
// kernels round them) into shared memory ([row][col]).
template <typename T, int D, int BT>
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* dl_s, const float* km_s, float* Ps,
    float* dSs, int q0, int k0, bool masked, const Args& a) {
  constexpr int R = BT / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
      gv[i] = dOs[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      float x = a.sm_scale * s[i][j];
      if (a.causal && k0 + c > q0 + r) x = NEG_INF;
      if (masked && !(km_s[c] > 0.f)) x = NEG_INF;
      const float p = expf(x - lse_s[r]);
      Ps[r * (BT + 1) + c] = round_to<T>(p);
      dSs[r * (BT + 1) + c] =
          round_to<T>(p * (dp[i][j] - dl_s[r]) * a.sm_scale);
    }
  }
}

template <int D, int BT>
constexpr size_t smem_bytes() {
  // four [BT][D+1] tiles, p and ds [BT][BT+1], lse, delta, key mask
  return sizeof(float) * (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int R = BT / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * (D + 1);
  float* Qs = Vs + BT * (D + 1);
  float* dOs = Qs + BT * (D + 1);
  float* Ps = dOs + BT * (D + 1);
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* dl_s = lse_s + BT;
  float* km_s = dl_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_t = a.T / BT;
  // key tile 0 meets the most causal query tiles: ascending order
  const BlockTile bt = block_tile(a, n_t, false);
  const int kt = bt.tile, k0 = kt * BT, bh = bt.bh, b = bt.b, h = bt.h;
  const bool masked = a.kmask != nullptr;

  const T* qp = at<T>(a.q, a.st[Q], b, h);
  const T* kp = at<T>(a.k, a.st[K], b, h);
  const T* vp = at<T>(a.v, a.st[V], b, h);
  const T* gp = at<T>(a.dout, a.st[DO], b, h);

  load_tile<T, D, BT>(Ks, kp, a.st[K].t, k0);
  load_tile<T, D, BT>(Vs, vp, a.st[V].t, k0);
  if (tid < BT)
    km_s[tid] = masked ? a.kmask[(long long)b * a.T + k0 + tid] : 1.f;

  float dk[R][NJ], dv[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int qt = a.causal ? kt : 0; qt < n_t; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's readers of Qs, dOs, Ps are done
    load_tile<T, D, BT>(Qs, qp, a.st[Q].t, q0);
    load_tile<T, D, BT>(dOs, gp, a.st[DO].t, q0);
    if (tid < BT) {
      lse_s[tid] = a.lse[(long long)bh * a.T + q0 + tid];
      dl_s[tid] = a.delta[(long long)bh * a.T + q0 + tid];
    }
    __syncthreads();
    p_ds_tile<T, D, BT>(Qs, dOs, Ks, Vs, lse_s, dl_s, km_s, Ps, dSs, q0, k0,
                        masked, a);
    __syncthreads();
    // dv[c] += sum_r p[r][c] do[r];  dk[c] += sum_r ds[r][c] q[r]
    // (keys c = ty + 16i, head columns tx + 16j)
#pragma unroll 2
    for (int r = 0; r < BT; ++r) {
      float pv[R], sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = Ps[r * (BT + 1) + ty + 16 * i];
        sv[i] = dSs[r * (BT + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = dOs[r * (D + 1) + tx + 16 * j];
        const float qv = Qs[r * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][j] = fmaf(pv[i], g, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
        }
      }
    }
  }

  T* dkp = at_mut<T>(a.dk, a.st[DK], b, h);
  T* dvp = at_mut<T>(a.dv, a.st[DV], b, h);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long t = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[t * a.st[DK].t + tx + 16 * j] = from_float<T>(dk[i][j]);
      dvp[t * a.st[DV].t + tx + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int R = BT / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * (D + 1);
  float* Ks = dOs + BT * (D + 1);
  float* Vs = Ks + BT * (D + 1);
  float* Ps = Vs + BT * (D + 1);
  float* dSs = Ps + BT * (BT + 1);
  float* lse_s = dSs + BT * (BT + 1);
  float* dl_s = lse_s + BT;
  float* km_s = dl_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_t = a.T / BT;
  // the last query tile meets the most causal key tiles: reverse order
  const BlockTile bt = block_tile(a, n_t, true);
  const int qt = bt.tile, q0 = qt * BT, bh = bt.bh, b = bt.b, h = bt.h;
  const bool masked = a.kmask != nullptr;

  const T* kp = at<T>(a.k, a.st[K], b, h);
  const T* vp = at<T>(a.v, a.st[V], b, h);
  load_tile<T, D, BT>(Qs, at<T>(a.q, a.st[Q], b, h), a.st[Q].t, q0);
  load_tile<T, D, BT>(dOs, at<T>(a.dout, a.st[DO], b, h), a.st[DO].t, q0);
  if (tid < BT) {
    lse_s[tid] = a.lse[(long long)bh * a.T + q0 + tid];
    dl_s[tid] = a.delta[(long long)bh * a.T + q0 + tid];
  }

  float dq[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  const int n_kt = a.causal ? qt + 1 : n_t;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers of Ks, Vs, dSs are done
    load_tile<T, D, BT>(Ks, kp, a.st[K].t, k0);
    load_tile<T, D, BT>(Vs, vp, a.st[V].t, k0);
    if (tid < BT)
      km_s[tid] = masked ? a.kmask[(long long)b * a.T + k0 + tid] : 1.f;
    __syncthreads();
    p_ds_tile<T, D, BT>(Qs, dOs, Ks, Vs, lse_s, dl_s, km_s, Ps, dSs, q0, k0,
                        masked, a);
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]  (rows r = ty + 16i, columns tx + 16j)
#pragma unroll 2
    for (int c = 0; c < BT; ++c) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dSs[(ty + 16 * i) * (BT + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) dq[i][j] = fmaf(sv[i], kv, dq[i][j]);
      }
    }
  }

  T* dqp = at_mut<T>(a.dq, a.st[DQ], b, h);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long t = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqp[t * a.st[DQ].t + tx + 16 * j] = from_float<T>(dq[i][j]);
  }
}

// delta = rowsum(do * o): one warp a row
template <typename T, int D>
int launch_delta(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.T;
  const long long warps_per_block = NTHREADS / 32;
  delta_kernel<T, D>
      <<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
         NTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, int BT>
int launch(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<T, D>(a, stream);
  if (rc != 0) return rc;
  constexpr size_t smem = smem_bytes<D, BT>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, D, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, D, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)a.B * a.H * (a.T / BT));
  dkv_kernel<T, D, BT><<<blocks, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D, BT><<<blocks, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16 dk/dv and dq on the tensor cores (see the note at the top)

namespace tcf {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;    // queries or keys per tile (16 rows per warp)
constexpr int NTH = 128;  // 4 warps

// rows r0 .. r0+63 of a strided [T, D] operand into a swizzled tile
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < BT * VPR; i += NTH) {
    const int r = i / VPR, c = (i % VPR) * 8;
    tc::cp_async<16>(dst + tc::swz(r, c, D),
                     src + (long long)(r0 + r) * st + c, true);
  }
}

// 64 consecutive f32 (lse, delta or the key mask of one tile)
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if (threadIdx.x < BT / 4)
    tc::cp_async<16>(dst + 4 * threadIdx.x, src + 4 * threadIdx.x, true);
}

// s += A[16 rows of this warp] . B[n0 .. n0 + 16 NP]^T and dp += C . E^T
// over D: A, C row-major [rows][D], B, E stored [n][D] (the two score
// products of one tile, which share their loop)
template <int D, int NP>
__device__ __forceinline__ void two_scores(float (&s)[2 * NP][4],
                                           float (&dp)[2 * NP][4],
                                           const bf16* A, const bf16* B,
                                           const bf16* C, const bf16* E,
                                           int n0, int warp, int lane) {
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb) {
    uint32_t aa[4], ac[4];
    tc::ldsm_x4(aa, A + tc::a_rowmajor(warp * 16, kb * 16, D, lane));
    tc::ldsm_x4(ac, C + tc::a_rowmajor(warp * 16, kb * 16, D, lane));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bb[4], be[4];
      tc::ldsm_x4(bb, B + tc::b_nk(n0 + np * 16, kb * 16, D, lane));
      tc::mma(s[2 * np], aa, bb[0], bb[1]);
      tc::mma(s[2 * np + 1], aa, bb[2], bb[3]);
      tc::ldsm_x4(be, E + tc::b_nk(n0 + np * 16, kb * 16, D, lane));
      tc::mma(dp[2 * np], ac, be[0], be[1]);
      tc::mma(dp[2 * np + 1], ac, be[2], be[3]);
    }
  }
}

// acc[16 rows][D] += a[16 rows][16 KB] . B[k0 .. k0 + 16 KB][D] (B a tile
// stored [k][D])
template <int D, int KB>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4],
                                            const uint32_t (&a)[KB][4],
                                            const bf16* B, int k0,
                                            int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np)
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint32_t bb[4];
      tc::ldsm_x4_t(bb, B + tc::b_kn(k0 + kb * 16, np * 16, D, lane));
      tc::mma(acc[2 * np], a[kb], bb[0], bb[1]);
      tc::mma(acc[2 * np + 1], a[kb], bb[2], bb[3]);
    }
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long st,
                                           const float (&acc)[D / 8][4],
                                           const int (&row)[2], int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(base + (long long)row[hh] * st + j * 8 +
                                   2 * t) =
          tc::pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 6 * BT * D + sizeof(float) * 4 * BT;
}

// dk, dv of one 64-key tile: K and V resident, Q and dO tiles (with
// their lse and delta) double-buffered from the causal bound to T.
// Warp w owns keys 16w .. 16w+15 and forms S^T and dP^T for them.
template <int D>
__global__ void __launch_bounds__(NTH, 2) dkv_tc(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][D]
  bf16* Vs = Ks + BT * D;
  bf16* Qs = Vs + BT * D;                         // 2 x [BT][D]
  bf16* Gs = Qs + 2 * BT * D;                     // dO, 2 x [BT][D]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BT * D);  // 2 x BT
  float* Dl = Ls + 2 * BT;                                 // 2 x BT
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const BlockTile bt = block_tile(a, a.T / BT, false);
  const int kt = bt.tile, k0 = kt * BT, bh = bt.bh, b = bt.b, h = bt.h;
  const bf16* qp = at<bf16>(a.q, a.st[Q], b, h);
  const bf16* gp = at<bf16>(a.dout, a.st[DO], b, h);
  const float* lse = a.lse + (long long)bh * a.T;
  const float* dl = a.delta + (long long)bh * a.T;
  const int nq = a.T / BT, qt0 = a.causal ? kt : 0;

  load_tile<D>(Ks, at<bf16>(a.k, a.st[K], b, h), a.st[K].t, k0);
  load_tile<D>(Vs, at<bf16>(a.v, a.st[V], b, h), a.st[V].t, k0);
  load_tile<D>(Qs, qp, a.st[Q].t, qt0 * BT);
  load_tile<D>(Gs, gp, a.st[DO].t, qt0 * BT);
  load_row(Ls, lse + qt0 * BT);
  load_row(Dl, dl + qt0 * BT);
  tc::cp_async_commit();

  int key[2];
  bool kok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + warp * 16 + g + 8 * hh;
    kok[hh] = a.kmask == nullptr ||
              a.kmask[(long long)b * a.T + key[hh]] > 0.f;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * BT;
    if (qt + 1 < nq) {
      const int nb = buf ^ 1;
      load_tile<D>(Qs + nb * BT * D, qp, a.st[Q].t, q0 + BT);
      load_tile<D>(Gs + nb * BT * D, gp, a.st[DO].t, q0 + BT);
      load_row(Ls + nb * BT, lse + q0 + BT);
      load_row(Dl + nb * BT, dl + q0 + BT);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qc = Qs + buf * BT * D;
    const bf16* Gc = Gs + buf * BT * D;
    const float* Lc = Ls + buf * BT;
    const float* Dc = Dl + buf * BT;

    // S^T = K Q^T and dP^T = V dO^T (rows this warp's keys, columns
    // the queries), 32 queries at a time, one after the other, to keep
    // the registers within 255 at D = 128 beside dk and dv
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      two_scores<D, 2>(s, dp, Ks, Qc, Vs, Gc, c0, warp, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1, qi = c0 + j * 8 + 2 * t + (e & 1);
          float x = a.sm_scale * s[j][e];
          if ((a.causal && key[hh] > q0 + qi) || !kok[hh]) x = NEG_INF;
          const float p = expf(x - Lc[qi]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dc[qi]) * a.sm_scale;
        }
      // P and dS rounded to bf16 for the products, as the reference
      // rounds them
      uint32_t pa[2][4], sa[2][4];
      tc::c_to_a<2>(s, pa);
      tc::c_to_a<2>(dp, sa);
      acc_product<D, 2>(dv, pa, Gc, c0, lane);  // dv += P^T dO
      acc_product<D, 2>(dk, sa, Qc, c0, lane);  // dk += dS^T Q
    }
    __syncthreads();  // Qc, Gc are refilled two tiles on
  }
  store_rows<D>(at_mut<bf16>(a.dk, a.st[DK], b, h), a.st[DK].t, dk, key, t);
  store_rows<D>(at_mut<bf16>(a.dv, a.st[DV], b, h), a.st[DV].t, dv, key, t);
}

// dq of one 64-query tile: Q and dO resident, K and V tiles (with the
// key mask) double-buffered up to the causal bound; the FA2 split,
// recomputing P and dS rather than adding dq with atomics, so a run is
// reproducible bit for bit.
template <int D>
__global__ void __launch_bounds__(NTH, 2) dq_tc(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][D]
  bf16* Gs = Qs + BT * D;                         // dO
  bf16* Ks = Gs + BT * D;                         // 2 x [BT][D]
  bf16* Vs = Ks + 2 * BT * D;                     // 2 x [BT][D]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BT * D);  // 2 x BT
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const BlockTile bt = block_tile(a, a.T / BT, true);
  const int qt = bt.tile, q0 = qt * BT, bh = bt.bh, b = bt.b, h = bt.h;
  const bool masked = a.kmask != nullptr;
  const bf16* kp = at<bf16>(a.k, a.st[K], b, h);
  const bf16* vp = at<bf16>(a.v, a.st[V], b, h);
  const float* km = masked ? a.kmask + (long long)b * a.T : nullptr;
  const int nk = a.causal ? qt + 1 : a.T / BT;

  load_tile<D>(Qs, at<bf16>(a.q, a.st[Q], b, h), a.st[Q].t, q0);
  load_tile<D>(Gs, at<bf16>(a.dout, a.st[DO], b, h), a.st[DO].t, q0);
  load_tile<D>(Ks, kp, a.st[K].t, 0);
  load_tile<D>(Vs, vp, a.st[V].t, 0);
  if (masked) load_row(Ms, km);
  tc::cp_async_commit();

  int qrow[2];
  float lse[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qrow[hh] = q0 + warp * 16 + g + 8 * hh;
    lse[hh] = a.lse[(long long)bh * a.T + qrow[hh]];
    dl[hh] = a.delta[(long long)bh * a.T + qrow[hh]];
  }
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BT;
    if (kt + 1 < nk) {
      const int nb = buf ^ 1;
      load_tile<D>(Ks + nb * BT * D, kp, a.st[K].t, k0 + BT);
      load_tile<D>(Vs + nb * BT * D, vp, a.st[V].t, k0 + BT);
      if (masked) load_row(Ms + nb * BT, km + k0 + BT);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kc = Ks + buf * BT * D;
    const bf16* Vc = Vs + buf * BT * D;
    const float* Mc = Ms + buf * BT;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    two_scores<D, 4>(s, dp, Qs, Kc, Gs, Vc, 0, warp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, kj = j * 8 + 2 * t + (e & 1);
        float x = a.sm_scale * s[j][e];
        if ((a.causal && k0 + kj > qrow[hh]) || (masked && !(Mc[kj] > 0.f)))
          x = NEG_INF;
        const float p = expf(x - lse[hh]);
        dp[j][e] = p * (dp[j][e] - dl[hh]) * a.sm_scale;
      }
    uint32_t sa[4][4];  // dS rounded to bf16, as the reference rounds it
    tc::c_to_a<4>(dp, sa);
    acc_product<D, 4>(dq, sa, Kc, 0, lane);  // dq += dS K
    __syncthreads();  // Kc, Vc, Mc are refilled two tiles on
  }
  store_rows<D>(at_mut<bf16>(a.dq, a.st[DQ], b, h), a.st[DQ].t, dq, qrow, t);
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<bf16, D>(a, stream);
  if (rc != 0) return rc;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)a.B * a.H * (a.T / BT));
  dkv_tc<D><<<blocks, NTH, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_tc<D><<<blocks, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tcf

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
  // blocks of the widest grid (32-row tiles) and of the delta pass
  if (T <= 0 || T % 64 != 0 || B <= 0 || H <= 0 ||
      (long long)B * H * (T / 32) > INT_MAX ||
      (long long)B * H * T / (NTHREADS / 32) > INT_MAX)
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
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32, 64>(a, s);
      case 64: return launch<float, 64, 64>(a, s);
      case 128: return launch<float, 128, 64>(a, s);
      case 256: return launch<float, 256, 32>(a, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return tcf::launch<32>(a, s);
      case 64: return tcf::launch<64>(a, s);
      case 128: return tcf::launch<128>(a, s);
      case 256: return launch<__nv_bfloat16, 256, 32>(a, s);
    }
  }
  return -1;
}
