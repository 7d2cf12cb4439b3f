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
// The lse cotangent (`dlse`, nullable): the chunked tier merges tiles
// by their lse, so its gradient reaches each tile's lse; d lse_i / d s_ij
// = p_ij, so ds = p * (dp - delta + dlse): the delta pass subtracts dlse
// (the JAX package's fold, `_flash_bwd_impl`), and the kernels run
// unchanged.
//
// Attention dropout (DROP = true instantiations, csrc/dropout.cuh): each
// pass regenerates the forward's keep mask from the seed and the
// element's global coordinates, then dp <- dp * keep * 1/(1 - rate) and
// dv takes p * keep * 1/(1 - rate), while ds = p * (dp - delta) *
// sm_scale keeps the undropped p (the JAX `_dkv_kernel`). At D = 256 both
// warps of a row block (the one forming P, the one forming dP) hash the
// same elements. DROP = false compiles to the kernels without dropout.
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
// Design: the FA2 split, three launches on one stream (two in bf16 at
// D = 256, where both passes share one launch), in both types.
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
// bf16 at D <= 128 (`tcf::dkv_tc`, `tcf::dq_tc`): every product is
// mma.sync m16n8k16 bf16 x bf16 -> f32, fed by ldmatrix (.trans for the
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
// bf16 at D = 256 (`tcf::bwd256_tc`). The design above does not fit:
// dk and dv would take 2 x 16 x 256 f32 a warp (256 registers a thread)
// and six [64][256] bf16 tiles 192 KB (one 4-warp block an SM). So a
// block owns 32 rows (keys in dk/dv, queries in dq) and streams 32-row
// tiles of the other side, and two warps share each 16-row block: warps
// 0-1 form S^T (S in dq) and P, warps 2-3 dP^T (dP); P crosses shared
// memory as f32 (for dS) and as bf16 (for dv), dS as bf16; then each
// warp adds its rows' share of dv and dk (or dq) over half the head's
// columns, 16 x 128 f32 each (128 registers a thread in dk/dv). Every
// product runs once per tile pair, as at D <= 128, with no atomics, so
// a run repeats bit for bit. Six [32][256] bf16 tiles, the row data and
// the exchange take 108,032 bytes: two blocks an SM. Both passes go in
// one launch (blocks below B*H*T/32 are dk/dv tiles, the rest dq tiles),
// so K6 at B*H = 16, T = 512 has 512 blocks for the card's 264 slots.
// 242 registers a thread (ptxas, no spills). Four barriers a tile
// bracket the exchange; with 8 warps an SM each warp's instruction rate
// and latency bound it, as at D <= 128.
//
// f32 (`dkv_kernel`, `dq_kernel`): scalar kernels on the CUDA cores,
// kept because TF32 tensor cores would not hold f32's 1e-4 agreement.
// 256 threads;
// K and V (or Q and dO) resident as f32, the BT x BT score and dp tiles
// formed with scalar FMAs (BT/16 x BT/16 a thread), p and ds exchanged
// through shared memory, rows padded by one float against bank
// conflicts. BT = 64, except at D = 256, where four [64][257] f32 tiles
// (263 KB) would not fit a block: there BT = 32 (140,416 bytes of shared
// memory).

#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "dropout.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
  const float* dlse;  // [B*H, T] or null: the lse cotangent, folded into delta
  // attention dropout (dropout.cuh), read by the DROP instantiations
  // only: the step seed in device memory, the call's global window
  // origin, the global sequence length, the keep threshold and scale
  const int* seed;
  uint32_t q_origin, k_origin, hash_t, thr;
  float keep_scale;
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

// delta[bh, t] = sum_d do[t, d] * o[t, d] - dlse[bh, t] (dlse when
// given): one warp per row
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
  // the lse cotangent: d lse / d s = p, so ds = p * (dp - delta + dlse)
  if (lane == 0) a.delta[row] = a.dlse ? s - a.dlse[row] : s;
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

// a [BT, D] tile of rows r0.. of a strided f32 tensor into shared memory
template <int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0) {
  for (int i = threadIdx.x; i < BT * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = src[(long long)(r0 + r) * st + c];
  }
}

// s = Qt . Kt^T and dp = dOt . Vt^T on a BT x BT tile: rows ty + 16i,
// columns tx + 16j. Then p and ds into shared memory ([row][col]); with
// dropout, p * keep * scale (for dv) and ds = p * (dp * keep * scale -
// delta) * sm_scale. key: the slice's dropout key.
template <int D, int BT, bool DROP>
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* dl_s, const float* km_s, float* Ps,
    float* dSs, int q0, int k0, bool masked, uint32_t key, const Args& a) {
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
      if constexpr (DROP) {
        const float ks =
            drop::keep(key + (a.q_origin + q0 + r) * a.hash_t + a.k_origin +
                           k0 + c,
                       a.thr)
                ? a.keep_scale
                : 0.f;
        Ps[r * (BT + 1) + c] = p * ks;
        dSs[r * (BT + 1) + c] = p * (dp[i][j] * ks - dl_s[r]) * a.sm_scale;
      } else {
        Ps[r * (BT + 1) + c] = p;
        dSs[r * (BT + 1) + c] =
            p * (dp[i][j] - dl_s[r]) * a.sm_scale;
      }
    }
  }
}

template <int D, int BT>
constexpr size_t smem_bytes() {
  // four [BT][D+1] tiles, p and ds [BT][BT+1], lse, delta, key mask
  return sizeof(float) * (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 3 * BT);
}

template <int D, int BT, bool DROP>
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
  const uint32_t key = DROP ? drop::slice_key(a.seed, bh) : 0u;

  const float* qp = at<float>(a.q, a.st[Q], b, h);
  const float* kp = at<float>(a.k, a.st[K], b, h);
  const float* vp = at<float>(a.v, a.st[V], b, h);
  const float* gp = at<float>(a.dout, a.st[DO], b, h);

  load_tile<D, BT>(Ks, kp, a.st[K].t, k0);
  load_tile<D, BT>(Vs, vp, a.st[V].t, k0);
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
    load_tile<D, BT>(Qs, qp, a.st[Q].t, q0);
    load_tile<D, BT>(dOs, gp, a.st[DO].t, q0);
    if (tid < BT) {
      lse_s[tid] = a.lse[(long long)bh * a.T + q0 + tid];
      dl_s[tid] = a.delta[(long long)bh * a.T + q0 + tid];
    }
    __syncthreads();
    p_ds_tile<D, BT, DROP>(Qs, dOs, Ks, Vs, lse_s, dl_s, km_s, Ps, dSs, q0,
                           k0, masked, key, a);
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

  float* dkp = at_mut<float>(a.dk, a.st[DK], b, h);
  float* dvp = at_mut<float>(a.dv, a.st[DV], b, h);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long t = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[t * a.st[DK].t + tx + 16 * j] = dk[i][j];
      dvp[t * a.st[DV].t + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D, int BT, bool DROP>
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
  const uint32_t key = DROP ? drop::slice_key(a.seed, bh) : 0u;

  const float* kp = at<float>(a.k, a.st[K], b, h);
  const float* vp = at<float>(a.v, a.st[V], b, h);
  load_tile<D, BT>(Qs, at<float>(a.q, a.st[Q], b, h), a.st[Q].t, q0);
  load_tile<D, BT>(dOs, at<float>(a.dout, a.st[DO], b, h), a.st[DO].t, q0);
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
    load_tile<D, BT>(Ks, kp, a.st[K].t, k0);
    load_tile<D, BT>(Vs, vp, a.st[V].t, k0);
    if (tid < BT)
      km_s[tid] = masked ? a.kmask[(long long)b * a.T + k0 + tid] : 1.f;
    __syncthreads();
    p_ds_tile<D, BT, DROP>(Qs, dOs, Ks, Vs, lse_s, dl_s, km_s, Ps, dSs, q0,
                           k0, masked, key, a);
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

  float* dqp = at_mut<float>(a.dq, a.st[DQ], b, h);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long t = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqp[t * a.st[DQ].t + tx + 16 * j] = dq[i][j];
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

template <int D, int BT, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<float, D>(a, stream);
  if (rc != 0) return rc;
  constexpr size_t smem = smem_bytes<D, BT>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D, BT, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<D, BT, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)a.B * a.H * (a.T / BT));
  dkv_kernel<D, BT, DROP><<<blocks, NTHREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D, BT, DROP><<<blocks, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16 dk/dv and dq on the tensor cores (see the note at the top)

namespace tcf {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;    // queries or keys per tile (16 rows per warp)
constexpr int NTH = 128;  // 4 warps

// rows r0 .. r0+ROWS-1 of a strided [T, D] operand into a swizzled tile
template <int D, int ROWS = BT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTH) {
    const int r = i / VPR, c = (i % VPR) * 8;
    tc::cp_async<16>(dst + tc::swz(r, c, D),
                     src + (long long)(r0 + r) * st + c, true);
  }
}

// ROWS consecutive f32 (lse, delta or the key mask of one tile)
template <int ROWS = BT>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if (threadIdx.x < ROWS / 4)
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
template <int D, bool DROP>
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
  // dropout: the hash coordinate of this thread's keys at query 0 (the
  // query adds gq * hash_t)
  uint32_t hkey[2];
  const uint32_t skey = DROP ? drop::slice_key(a.seed, bh) : 0u;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + warp * 16 + g + 8 * hh;
    kok[hh] = a.kmask == nullptr ||
              a.kmask[(long long)b * a.T + key[hh]] > 0.f;
    hkey[hh] = skey + a.q_origin * a.hash_t + a.k_origin + key[hh];
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
          if constexpr (DROP) {
            // dv takes p * keep * scale, dS the dropped dP
            const float ks =
                drop::keep(hkey[hh] + (uint32_t)(q0 + qi) * a.hash_t, a.thr)
                    ? a.keep_scale
                    : 0.f;
            s[j][e] = p * ks;
            dp[j][e] = p * (dp[j][e] * ks - Dc[qi]) * a.sm_scale;
          } else {
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - Dc[qi]) * a.sm_scale;
          }
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
template <int D, bool DROP>
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
  // dropout: the hash coordinate of this thread's first key in each row,
  // at key tile 0
  uint32_t hrow[2];
  const uint32_t skey = DROP ? drop::slice_key(a.seed, bh) : 0u;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qrow[hh] = q0 + warp * 16 + g + 8 * hh;
    lse[hh] = a.lse[(long long)bh * a.T + qrow[hh]];
    dl[hh] = a.delta[(long long)bh * a.T + qrow[hh]];
    hrow[hh] =
        skey + (a.q_origin + qrow[hh]) * a.hash_t + a.k_origin + 2 * t;
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
        if constexpr (DROP) {
          const float ks =
              drop::keep(hrow[hh] + k0 + j * 8 + (e & 1), a.thr)
                  ? a.keep_scale
                  : 0.f;
          dp[j][e] = p * (dp[j][e] * ks - dl[hh]) * a.sm_scale;
        } else {
          dp[j][e] = p * (dp[j][e] - dl[hh]) * a.sm_scale;
        }
      }
    uint32_t sa[4][4];  // dS rounded to bf16, as the reference rounds it
    tc::c_to_a<4>(dp, sa);
    acc_product<D, 4>(dq, sa, Kc, 0, lane);  // dq += dS K
    __syncthreads();  // Kc, Vc, Mc are refilled two tiles on
  }
  store_rows<D>(at_mut<bf16>(a.dq, a.st[DQ], b, h), a.st[DQ].t, dq, qrow, t);
}

// ---- D = 256: 32-row blocks, each row block shared by two warps
//
// Rows r of a block are keys (dk/dv) or queries (dq); warp w owns rows
// 16 (w & 1) .. + 15 and, in the products, head columns 128 (w >> 1) ..
// + 127. Per streamed 32-row tile, warps 0-1 form S (or S^T) and P,
// warps 2-3 dP (or dP^T); P crosses in shared memory as f32 for dS and
// as bf16 for dv, dS as bf16; then every warp adds its 16 x 128 share
// of dv and dk (or dq).

constexpr int BR = 32;        // rows of a block, and of a streamed tile
constexpr int DH = 256;       // the head dim of these kernels
constexpr int PF = BR + 8;    // row stride of the f32 P tile (no conflicts)

constexpr size_t smem256() {
  // six [BR][DH] bf16 tiles; lse and delta (or the key mask), two
  // stages each; P as f32; P and dS as bf16
  return sizeof(bf16) * (6 * BR * DH + 2 * BR * BR) +
         sizeof(float) * (4 * BR + BR * PF);
}

// s += A[rows r0 .. r0 + 15] . B[32 rows]^T over DH (A row-major
// [rows][DH], B stored [n][DH])
__device__ __forceinline__ void score256(float (&s)[4][4], const bf16* A,
                                         int r0, const bf16* B, int lane) {
#pragma unroll
  for (int kb = 0; kb < DH / 16; ++kb) {
    uint32_t aa[4];
    tc::ldsm_x4(aa, A + tc::a_rowmajor(r0, kb * 16, DH, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      tc::ldsm_x4(bb, B + tc::b_nk(np * 16, kb * 16, DH, lane));
      tc::mma(s[2 * np], aa, bb[0], bb[1]);
      tc::mma(s[2 * np + 1], aa, bb[2], bb[3]);
    }
  }
}

// acc[16 rows][128 columns from c0] += a[16 rows][32] . B[32][DH] (B a
// tile stored [k][DH])
__device__ __forceinline__ void acc_half(float (&acc)[16][4],
                                         const uint32_t (&a)[2][4],
                                         const bf16* B, int c0, int lane) {
#pragma unroll
  for (int np = 0; np < 8; ++np)
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      uint32_t bb[4];
      tc::ldsm_x4_t(bb, B + tc::b_kn(kb * 16, c0 + np * 16, DH, lane));
      tc::mma(acc[2 * np], a[kb], bb[0], bb[1]);
      tc::mma(acc[2 * np + 1], a[kb], bb[2], bb[3]);
    }
}

// the A fragments of this warp's 16 rows from a [BR][BR] bf16 tile
__device__ __forceinline__ void frag_rows(uint32_t (&f)[2][4], const bf16* X,
                                          int r0, int lane) {
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
    tc::ldsm_x4(f[kb], X + tc::a_rowmajor(r0, kb * 16, BR, lane));
}

// dk, dv of one 32-key tile (block `blk` of the dk/dv grid): K and V
// resident, Q and dO tiles (with lse and delta) double-buffered from the
// causal bound to T.
template <bool DROP>
__device__ __forceinline__ void dkv256(const Args& a, int blk,
                                       unsigned char* smem_raw) {
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BR][DH]
  bf16* Vs = Ks + BR * DH;
  bf16* Qs = Vs + BR * DH;                        // 2 x [BR][DH]
  bf16* Gs = Qs + 2 * BR * DH;                    // dO, 2 x [BR][DH]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BR * DH);  // 2 x BR
  float* Dl = Ls + 2 * BR;                                  // 2 x BR
  float* Pf = Dl + 2 * BR;                                  // [BR][PF]
  bf16* Pb = reinterpret_cast<bf16*>(Pf + BR * PF);         // [BR][BR]
  bf16* Sb = Pb + BR * BR;                                  // [BR][BR]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 1) * 16, role = warp >> 1;
  const int n_t = a.T / BR;
  // key tile 0 meets the most causal query tiles: ascending order
  const int kt = blk % n_t, bh = blk / n_t, b = bh / a.H, h = bh % a.H;
  const int k0 = kt * BR, qt0 = a.causal ? kt : 0;
  const bf16* qp = at<bf16>(a.q, a.st[Q], b, h);
  const bf16* gp = at<bf16>(a.dout, a.st[DO], b, h);
  const float* lse = a.lse + (long long)bh * a.T;
  const float* dl = a.delta + (long long)bh * a.T;

  load_tile<DH, BR>(Ks, at<bf16>(a.k, a.st[K], b, h), a.st[K].t, k0);
  load_tile<DH, BR>(Vs, at<bf16>(a.v, a.st[V], b, h), a.st[V].t, k0);
  load_tile<DH, BR>(Qs, qp, a.st[Q].t, qt0 * BR);
  load_tile<DH, BR>(Gs, gp, a.st[DO].t, qt0 * BR);
  load_row<BR>(Ls, lse + qt0 * BR);
  load_row<BR>(Dl, dl + qt0 * BR);
  tc::cp_async_commit();

  int key[2];
  bool kok[2];
  // dropout: the hash coordinate of this thread's keys at query 0 (the
  // query adds gq * hash_t); both roles need the keep mask
  uint32_t hkey[2];
  const uint32_t skey = DROP ? drop::slice_key(a.seed, bh) : 0u;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + r0 + g + 8 * hh;
    kok[hh] = a.kmask == nullptr ||
              a.kmask[(long long)b * a.T + key[hh]] > 0.f;
    hkey[hh] = skey + a.q_origin * a.hash_t + a.k_origin + key[hh];
  }
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = qt0; qt < n_t; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * BR;
    if (qt + 1 < n_t) {
      const int nb = buf ^ 1;
      load_tile<DH, BR>(Qs + nb * BR * DH, qp, a.st[Q].t, q0 + BR);
      load_tile<DH, BR>(Gs + nb * BR * DH, gp, a.st[DO].t, q0 + BR);
      load_row<BR>(Ls + nb * BR, lse + q0 + BR);
      load_row<BR>(Dl + nb * BR, dl + q0 + BR);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Qc = Qs + buf * BR * DH;
    const bf16* Gc = Gs + buf * BR * DH;
    const float* Lc = Ls + buf * BR;
    const float* Dc = Dl + buf * BR;

    // S^T = K Q^T (warps 0-1) or dP^T = V dO^T (warps 2-3): rows this
    // warp's keys, columns the tile's queries
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    score256(s, role ? Vs : Ks, r0, role ? Gc : Qc, lane);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh, c = j * 8 + 2 * t;
          float p[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float x = a.sm_scale * s[j][2 * hh + i];
            if ((a.causal && key[hh] > q0 + c + i) || !kok[hh]) x = NEG_INF;
            p[i] = expf(x - Lc[c + i]);
          }
          *reinterpret_cast<float2*>(Pf + r * PF + c) =
              make_float2(p[0], p[1]);
          if constexpr (DROP) {
            // dv takes p * keep * scale
#pragma unroll
            for (int i = 0; i < 2; ++i)
              p[i] *= drop::keep(hkey[hh] + (uint32_t)(q0 + c + i) * a.hash_t,
                                 a.thr)
                          ? a.keep_scale
                          : 0.f;
          }
          // P rounded to bf16 for dv, as the reference rounds it
          *reinterpret_cast<uint32_t*>(Pb + tc::swz(r, c, BR)) =
              tc::pack_bf16(p[0], p[1]);
        }
    }
    __syncthreads();
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh, c = j * 8 + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(Pf + r * PF + c);
          float dp[2] = {s[j][2 * hh], s[j][2 * hh + 1]};
          if constexpr (DROP) {
            // dS takes the dropped dP
#pragma unroll
            for (int i = 0; i < 2; ++i)
              dp[i] *= drop::keep(hkey[hh] + (uint32_t)(q0 + c + i) * a.hash_t,
                                  a.thr)
                           ? a.keep_scale
                           : 0.f;
          }
          // dS rounded to bf16 for dk, as the reference rounds it
          *reinterpret_cast<uint32_t*>(Sb + tc::swz(r, c, BR)) =
              tc::pack_bf16(p.x * (dp[0] - Dc[c]) * a.sm_scale,
                            p.y * (dp[1] - Dc[c + 1]) * a.sm_scale);
        }
    }
    __syncthreads();
    uint32_t pa[2][4], sa[2][4];
    frag_rows(pa, Pb, r0, lane);
    frag_rows(sa, Sb, r0, lane);
    acc_half(dv, pa, Gc, role * 128, lane);  // dv += P^T dO
    acc_half(dk, sa, Qc, role * 128, lane);  // dk += dS^T Q
    __syncthreads();  // Qc, Gc, Pb, Sb are rewritten
  }
  store_rows<128>(at_mut<bf16>(a.dk, a.st[DK], b, h) + role * 128,
                  a.st[DK].t, dk, key, t);
  store_rows<128>(at_mut<bf16>(a.dv, a.st[DV], b, h) + role * 128,
                  a.st[DV].t, dv, key, t);
}

// dq of one 32-query tile (block `blk` of the dq grid): Q and dO
// resident, K and V tiles (with the key mask) double-buffered up to the
// causal bound.
template <bool DROP>
__device__ __forceinline__ void dq256(const Args& a, int blk,
                                      unsigned char* smem_raw) {
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BR][DH]
  bf16* Gs = Qs + BR * DH;                        // dO
  bf16* Ks = Gs + BR * DH;                        // 2 x [BR][DH]
  bf16* Vs = Ks + 2 * BR * DH;                    // 2 x [BR][DH]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BR * DH);  // 2 x BR
  float* Pf = Ms + 4 * BR;                                  // [BR][PF]
  bf16* Sb = reinterpret_cast<bf16*>(Pf + BR * PF);         // [BR][BR]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 1) * 16, role = warp >> 1;
  const int n_t = a.T / BR;
  // the last query tile meets the most causal key tiles: reverse order
  const int qt = n_t - 1 - blk % n_t, bh = blk / n_t, b = bh / a.H,
            h = bh % a.H;
  const int q0 = qt * BR, nk = a.causal ? qt + 1 : n_t;
  const bool masked = a.kmask != nullptr;
  const bf16* kp = at<bf16>(a.k, a.st[K], b, h);
  const bf16* vp = at<bf16>(a.v, a.st[V], b, h);
  const float* km = masked ? a.kmask + (long long)b * a.T : nullptr;

  load_tile<DH, BR>(Qs, at<bf16>(a.q, a.st[Q], b, h), a.st[Q].t, q0);
  load_tile<DH, BR>(Gs, at<bf16>(a.dout, a.st[DO], b, h), a.st[DO].t, q0);
  load_tile<DH, BR>(Ks, kp, a.st[K].t, 0);
  load_tile<DH, BR>(Vs, vp, a.st[V].t, 0);
  if (masked) load_row<BR>(Ms, km);
  tc::cp_async_commit();

  int qrow[2];
  float lse[2], dl[2];
  // dropout: the hash coordinate of this thread's rows at key 0
  uint32_t hrow[2];
  const uint32_t skey = DROP ? drop::slice_key(a.seed, bh) : 0u;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qrow[hh] = q0 + r0 + g + 8 * hh;
    lse[hh] = a.lse[(long long)bh * a.T + qrow[hh]];
    dl[hh] = a.delta[(long long)bh * a.T + qrow[hh]];
    hrow[hh] = skey + (a.q_origin + qrow[hh]) * a.hash_t + a.k_origin;
  }
  float dq[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BR;
    if (kt + 1 < nk) {
      const int nb = buf ^ 1;
      load_tile<DH, BR>(Ks + nb * BR * DH, kp, a.st[K].t, k0 + BR);
      load_tile<DH, BR>(Vs + nb * BR * DH, vp, a.st[V].t, k0 + BR);
      if (masked) load_row<BR>(Ms + nb * BR, km + k0 + BR);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kc = Ks + buf * BR * DH;
    const bf16* Vc = Vs + buf * BR * DH;
    const float* Mc = Ms + buf * BR;

    // S = Q K^T (warps 0-1) or dP = dO V^T (warps 2-3): rows this
    // warp's queries, columns the tile's keys
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    score256(s, role ? Gs : Qs, r0, role ? Vc : Kc, lane);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh, c = j * 8 + 2 * t;
          float p[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float x = a.sm_scale * s[j][2 * hh + i];
            if ((a.causal && k0 + c + i > qrow[hh]) ||
                (masked && !(Mc[c + i] > 0.f)))
              x = NEG_INF;
            p[i] = expf(x - lse[hh]);
          }
          *reinterpret_cast<float2*>(Pf + r * PF + c) =
              make_float2(p[0], p[1]);
        }
    }
    __syncthreads();
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh, c = j * 8 + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(Pf + r * PF + c);
          float dp[2] = {s[j][2 * hh], s[j][2 * hh + 1]};
          if constexpr (DROP) {
            // dS takes the dropped dP
#pragma unroll
            for (int i = 0; i < 2; ++i)
              dp[i] *= drop::keep(hrow[hh] + k0 + c + i, a.thr)
                           ? a.keep_scale
                           : 0.f;
          }
          // dS rounded to bf16 for dq, as the reference rounds it
          *reinterpret_cast<uint32_t*>(Sb + tc::swz(r, c, BR)) =
              tc::pack_bf16(p.x * (dp[0] - dl[hh]) * a.sm_scale,
                            p.y * (dp[1] - dl[hh]) * a.sm_scale);
        }
    }
    __syncthreads();
    uint32_t sa[2][4];
    frag_rows(sa, Sb, r0, lane);
    acc_half(dq, sa, Kc, role * 128, lane);  // dq += dS K
    __syncthreads();  // Kc, Vc, Mc, Sb are rewritten
  }
  store_rows<128>(at_mut<bf16>(a.dq, a.st[DQ], b, h) + role * 128,
                  a.st[DQ].t, dq, qrow, t);
}

// One launch for both passes, which depend only on delta: blocks below
// n_dkv are dk/dv tiles, the rest dq tiles.
template <bool DROP>
__global__ void __launch_bounds__(NTH, 2) bwd256_tc(Args a, int n_dkv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if ((int)blockIdx.x < n_dkv)
    dkv256<DROP>(a, (int)blockIdx.x, smem_raw);
  else
    dq256<DROP>(a, (int)blockIdx.x - n_dkv, smem_raw);
}

template <bool DROP>
int launch256(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<bf16, DH>(a, stream);
  if (rc != 0) return rc;
  constexpr size_t smem = smem256();
  cudaError_t err = cudaFuncSetAttribute(
      bwd256_tc<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n = (int)((long long)a.B * a.H * (a.T / BR));
  bwd256_tc<DROP><<<2 * n, NTH, smem, stream>>>(a, n);
  return (int)cudaGetLastError();
}

template <int D, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  int rc = launch_delta<bf16, D>(a, stream);
  if (rc != 0) return rc;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_tc<D, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_tc<D, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)a.B * a.H * (a.T / BT));
  dkv_tc<D, DROP><<<blocks, NTH, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_tc<D, DROP><<<blocks, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tcf

template <bool DROP>
int dispatch(const Args& a, int dtype, int D, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 32: return launch<32, 64, DROP>(a, s);
      case 64: return launch<64, 64, DROP>(a, s);
      case 128: return launch<128, 64, DROP>(a, s);
      case 256: return launch<256, 32, DROP>(a, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return tcf::launch<32, DROP>(a, s);
      case 64: return tcf::launch<64, DROP>(a, s);
      case 128: return tcf::launch<128, DROP>(a, s);
      case 256: return tcf::launch256<DROP>(a, s);
    }
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, (batch,
// head, token) for q, k, v, o, do, dq, dk, dv in that order. dlse: the
// lse cotangent [B*H, T] f32, or null. seed: the int32 step seed in
// device memory, or null for no dropout; with it, q_origin, k_origin,
// hash_t, thr and keep_scale define the keep mask (dropout.cuh). Returns
// 0 on success, a cudaError_t from a launch, or -1 for arguments the
// kernels do not take.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         const float* kmask, float* delta, void* dq,
                         void* dk, void* dv, int dtype, int D, int B, int H,
                         int T, const long long* strides, float sm_scale,
                         int causal, const float* dlse, const int* seed,
                         uint32_t q_origin, uint32_t k_origin,
                         uint32_t hash_t, uint32_t thr, float keep_scale,
                         void* stream) {
  // blocks of the widest grid (both D = 256 passes of 32-row tiles in
  // one launch) and of the delta pass
  if (T <= 0 || T % 64 != 0 || B <= 0 || H <= 0 ||
      2LL * B * H * (T / 32) > INT_MAX ||
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
  a.dlse = dlse;
  a.seed = seed;
  a.q_origin = q_origin;
  a.k_origin = k_origin;
  a.hash_t = hash_t;
  a.thr = thr;
  a.keep_scale = keep_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seed ? dispatch<true>(a, dtype, D, s) : dispatch<false>(a, dtype, D, s);
}
