// Fused softmax cross-entropy head for Hopper (sm_90a): per-token loss of
// softmax(x @ W + b) against integer labels, and its three gradients,
// without writing the [N, V] logits to device memory.
//
// Replaces the TPU kernels (deeplearning4j_tpu/ops/fused_softmax_xent.py)
//   `_fused_fwd` -> `_fwd_kernel` (K8): loss and lse, online over vocab
//     chunks;
//   `_fused_bwd` -> `_dx_kernel` and `_dwdb_kernel` (K9):
//     G = (softmax - onehot) * g, dx = G @ W^T, dW = x^T @ G,
//     db = column sums of G,
//   recomputing each logits chunk from (x, W, b, lse).
//
// Shapes: x [N, d], W [d, V], b [V] (all one type, f32 or bf16, row-major
// contiguous); labels [N] int32 in [0, V); lse, g (the loss cotangent)
// and loss [N] f32. Any N and any V: rows past N and columns past V are
// masked inside the kernels (no padded copy of W, unlike the TPU wrapper,
// which pads V to a whole number of chunks every step). d must be a
// multiple of 32. The softmax math and every accumulator are f32, and
// results are rounded once to the output type.
//
// What bounds it. The forward does 2*N*d*V FLOPs, the backward 6*N*d*V
// (the logits, G @ W^T, x^T @ G) and, as two kernels that each recompute
// the logits, executes 8*N*d*V, against (N*d + d*V) elements read: at the
// flagship (N = 16384, d = 256, V = 10000) hundreds of FLOPs per byte,
// above the bf16 ridge, so the card's least time is set by operations,
// on the tensor cores.
//
// f32 (all three kernels): scalar f32 FMA. A logits tile of 64 rows x
// 64 vocab columns is formed in registers (4x4 per thread of 256) from
// 32-wide slices of x and W staged in shared memory as f32; the forward
// keeps the running max, sum and label logit per row over the chunks;
// dx and dW/db blocks form G in shared memory and accumulate its
// products in registers. f32 stays on them because TF32 tensor cores
// would not hold f32's 1e-4 agreement.
//
// bf16 runs on the tensor cores: every product is mma.sync m16n8k16
// bf16 x bf16 -> f32, fed by ldmatrix from bf16 tiles in shared memory
// (rows of 64 or 256 bf16, 16-byte chunks XOR-swizzled by row, so no
// padding and no bank conflicts) that cp.async fills. G is rounded to
// bf16 for the two products, where the JAX kernels round it
// (`g.astype(w.dtype)`, `g.astype(x.dtype)`); db sums the f32 G. Blocks
// are 4 warps; a warp owns 16 rows of N of each 64 x 64 logits tile.
//   forward (`xent_fwd_tc`, K8): one block of 8 warps per 128 rows.
//     Each block streams all of W from L2, so the row tile sets that
//     traffic: 128 rows read 0.66 GB at the flagship, half of what 64
//     would. x's rows [128][256] pass once through shared memory into A
//     fragments that stay in registers (16 x 256 bf16 a warp, 64
//     registers a thread), so their space is then the ring of W's vocab
//     chunks [256][64], three stages deep: one barrier a chunk, the
//     next two chunks loading while one multiplies. A chunk costs a
//     warp 64 ldmatrix of W and 128 mma.sync; its 16 x 64 logits plus
//     bias then fold, in registers, into a running max in log2 units
//     (the same for the 4 lanes of a row, which meet by two shuffles),
//     this thread's share of the sum (one MUFU.EX2 an element) and the
//     label's logit; lse = m ln 2 + ln(the shares' sum) and the loss are
//     written once a row at the end. No atomics: a run repeats bit for
//     bit. 177 registers a thread (ptxas, no spills), 96.75 KB of shared
//     memory: one block an SM, 128 blocks (one wave) at the flagship.
//     Eight warps an SM issuing mma.sync leave the tensor cores far from
//     full; wgmma is the next step.
//   dx (`xent_dx_tc`): one block per (64 rows, 256-column slice of d).
//     Its x rows stay resident (32 KB); W's vocab chunks [256][64] come
//     in through two stages (2 x 32 KB), the next loading while the
//     current one multiplies. Per chunk a warp forms its 16 x 64 logits
//     (8 accumulators of 4 f32), turns them into G and, packed to bf16,
//     into the A fragments of the dx product without leaving registers;
//     dx accumulates as 16 x 256 f32 per warp (128 a thread). 96 KB of
//     shared memory: two blocks an SM; 256 blocks at the flagship.
//   dW/db (`xent_dwdb_tc`): one block per (64 vocab columns, 256-row
//     slice of d, slice of N). W's chunk stays resident; x's row blocks
//     come in through two stages; G goes through shared memory (bf16,
//     8 KB) to the x^T @ G product, where a warp owns 64 rows of dW
//     (4 x 8 accumulators, 128 f32 a thread). The N reduction is split
//     into S slices (`dw_slices`: at least two blocks for each of the
//     card's 2 x 132 block slots, S picked to fill the last wave best;
//     S = 5 at the flagship: 785 blocks), each writing an f32 partial of
//     dW and db to a workspace the wrapper allocates; `xent_dw_reduce`
//     sums the slices in a fixed order and casts, so a run is
//     reproducible bit for bit. 105 KB: two blocks an SM.
//   dx and dW/db use 243-255 registers a thread (ptxas, no spills): 2
//   blocks of 128 threads fill an SM's 64K registers, as their shared
//   memory does.
// W is copied 16 bytes at a time where V % 8 == 0 and in 8-, 4- or
// 2-byte pieces otherwise (a row of W is then not 16-byte aligned; plain
// loads when V is odd), in the same kernels. At d > 256 a block also
// forms the logits over the rest of d from 64-deep slices of x and W
// loaded one at a time (off the main path; dx and dW recompute the
// logits once per slice of d).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BN = 64;    // rows per tile
constexpr int BV = 64;    // vocab columns per chunk
constexpr int KS = 32;    // depth of one staged slice of x and W
constexpr int DT = 256;   // d columns per dx / dW block
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-30f;

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
__device__ __forceinline__ void logits_tile(const Args& a, int n0, int v0,
                                            float* Xs, float* Ws,
                                            float s[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
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
          n < a.N ? x[(long long)n * a.d + k0 + c] : 0.f;
    }
    for (int i = tid; i < KS * BV; i += NTHREADS) {
      const int r = i / BV, c = i % BV;
      const int v = v0 + c;
      Ws[r * (BV + 1) + c] =
          v < a.V ? w[(long long)(k0 + r) * a.V + v] : 0.f;
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
  const float* bias = static_cast<const float*>(a.b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = v0 + tx + 16 * j;
    const float bj = v < a.V ? bias[v] : 0.f;
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
    logits_tile(a, n0, v0, Xs, Ws, s);
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
  const float* w = static_cast<const float*>(a.w);
  load_rows(a, n0, lab_s, lse_s, g_s);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < a.V; v0 += BV) {
    float s[4][4];
    logits_tile(a, n0, v0, Xs, Ws, s);
    grad_tile(a, n0, v0, s, lab_s, lse_s, g_s, Gs);
    for (int i = tid; i < DT * BV; i += NTHREADS) {
      const int cc = i / BV, vv = i % BV;
      const int c = c0 + cc, v = v0 + vv;
      Wt[cc * (BV + 1) + vv] =
          (c < a.d && v < a.V) ? w[(long long)c * a.V + v] : 0.f;
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
  float* dx = static_cast<float*>(a.dx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= a.N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < a.d) dx[(long long)n * a.d + c] = acc[i][j];
    }
  }
}

constexpr size_t dw_smem() {
  return logits_smem() +
         sizeof(float) * (BN * (BV + 1) + BN * (DT + 1) + 3 * BN);
}

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
  const float* x = static_cast<const float*>(a.x);

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
    logits_tile(a, n0, v0, Xs, Ws, s);
    grad_tile(a, n0, v0, s, lab_s, lse_s, g_s, Gs);
    for (int i = tid; i < BN * DT; i += NTHREADS) {
      const int r = i / DT, cc = i % DT;
      const int n = n0 + r, c = c0 + cc;
      Xt[r * (DT + 1) + cc] =
          (n < a.N && c < a.d) ? x[(long long)n * a.d + c] : 0.f;
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
  float* dw = static_cast<float*>(a.dw);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= a.d) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (v < a.V) dw[(long long)c * a.V + v] = acc[i][j];
    }
  }
  if (blockIdx.y == 0 && tid < BV && v0 + tid < a.V) a.db[v0 + tid] = db;
}

// ---------------------------------------------------------------------
// bf16 backward on the tensor cores (see the note at the top)

namespace tcx {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;    // rows of N per tile (16 per warp)
constexpr int BV = 64;    // vocab columns per chunk
constexpr int DT = 256;   // columns of d per block (the dx / dW slice)
constexpr int RK = 64;    // depth of one ring slice outside the slice
constexpr int NTH = 128;  // 4 warps

// Copy the [rows][cols] window at `src` (row stride ld) into a swizzled
// tile of width `cols`, VEC elements a copy (8: 16-byte cp.async; 4, 2:
// 8- and 4-byte cp.async; 1: plain loads). Rows at or past nr and
// columns at or past nc are zero-filled.
template <int VEC, int NT = NTH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int rows, int cols,
                                          int nr, int nc) {
  const int vpr = cols / VEC;
  for (int i = threadIdx.x; i < rows * vpr; i += NT) {
    const int r = i / vpr, c = (i % vpr) * VEC;
    const bool ok = r < nr && c < nc;
    const bf16* s = ok ? src + r * ld + c : src;
    bf16* d = dst + tc::swz(r, c, cols);
    if constexpr (VEC == 1) {
      *d = ok ? *s : __float2bfloat16(0.f);
    } else {
      tc::cp_async<VEC * 2>(d, s, ok);
    }
  }
}

// s += X[16 rows of this warp][xk0 .. xk0 + 16 nk) @ W[wk0 .. + 16 nk][BV]
// (X a swizzled tile of width xw, W one of width BV)
__device__ __forceinline__ void s_accum(float (&s)[8][4], const bf16* X,
                                        int xw, int xk0, const bf16* W,
                                        int wk0, int nk, int warp, int lane) {
  for (int kb = 0; kb < nk; ++kb) {
    uint32_t af[4];
    tc::ldsm_x4(af, X + tc::a_rowmajor(warp * 16, xk0 + kb * 16, xw, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      tc::ldsm_x4_t(bf, W + tc::b_kn(wk0 + kb * 16, np * 16, BV, lane));
      tc::mma(s[2 * np], af, bf[0], bf[1]);
      tc::mma(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// The logits outside the block's d slice [c0, c0 + DT) (d > DT only):
// 64-deep slices of x (ROWS rows from n0) and W through XR / WR, one at
// a time, by the block's NT threads.
template <int VEC, int ROWS = BN, int NT = NTH>
__device__ void s_outside(float (&s)[8][4], const Args& a, int n0, int v0,
                          int c0, bf16* XR, bf16* WR, int warp, int lane) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  for (int k0 = 0; k0 < a.d; k0 += RK) {
    if (k0 >= c0 && k0 < c0 + DT) continue;
    load_tile<8, NT>(XR, x + (long long)n0 * a.d + k0, a.d, ROWS, RK,
                     a.N - n0, a.d - k0);
    load_tile<VEC, NT>(WR, w + (long long)k0 * a.V + v0, a.V, RK, BV,
                       a.d - k0, a.V - v0);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    s_accum(s, XR, RK, 0, WR, 0, RK / 16, warp, lane);
    __syncthreads();
  }
}

// G = (softmax - onehot) * g in place of the logits s (rows r[h] =
// this thread's two rows, columns v0 + nb*8 + 2t + {0, 1}); zero past
// N and V. bs: the bias of the chunk's 64 columns (shared memory).
__device__ __forceinline__ void grad_frag(float (&s)[8][4], const float* bs,
                                          int v0, int V,
                                          const bool (&rv)[2],
                                          const float (&lse)[2],
                                          const float (&gg)[2],
                                          const int (&lab)[2], int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, v = v0 + nb * 8 + 2 * t + (e & 1);
      float G = 0.f;
      if (rv[h] && v < V)
        G = (expf(s[nb][e] + bs[nb * 8 + 2 * t + (e & 1)] - lse[h]) -
             (v == lab[h] ? 1.f : 0.f)) *
            gg[h];
      s[nb][e] = G;
    }
}

// the bias of vocab columns v0 .. v0+63 into bs (zero past V); visible
// to the block after its next __syncthreads
__device__ __forceinline__ void load_bias(float* bs, const Args& a, int v0) {
  const bf16* b = static_cast<const bf16*>(a.b);
  const int j = threadIdx.x;
  if (j < BV) bs[j] = v0 + j < a.V ? __bfloat162float(b[v0 + j]) : 0.f;
}

__device__ __forceinline__ void load_row_data(const Args& a, int n0,
                                              int warp, int g, bool (&rv)[2],
                                              float (&lse)[2], float (&gg)[2],
                                              int (&lab)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + warp * 16 + g + 8 * h;
    rv[h] = n < a.N;
    lse[h] = rv[h] ? a.lse[n] : 0.f;
    gg[h] = rv[h] ? a.g[n] : 0.f;
    lab[h] = rv[h] ? a.labels[n] : -1;
  }
}

// xent_dx_tc: x's rows, two stages of W, the bias
size_t dx_smem(int d) {
  return sizeof(bf16) * (BN * DT + 2 * DT * BV) + sizeof(float) * BV +
         (d > DT ? sizeof(bf16) * (BN * RK + RK * BV) : 0);
}

// the forward: 8 warps (128 rows) a block, W's chunks three stages deep
constexpr int FW = 8;
constexpr int FROWS = 16 * FW;
constexpr int FNTH = 32 * FW;
constexpr int FST = 3;

// x's rows [FROWS][DT] share the ring's space (they are read once,
// before the first chunk arrives)
size_t fwd_smem(int d) {
  return sizeof(bf16) * FST * DT * BV + sizeof(float) * FST * BV +
         (d > DT ? sizeof(bf16) * (FROWS * RK + RK * BV) : 0);
}
static_assert(FROWS * DT <= FST * DT * BV, "x's rows fit the W ring");

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x (MUFU.EX2; inputs below -126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// W's vocab chunk i (and its bias) into stage i % FST
template <int VEC>
__device__ __forceinline__ void load_chunk(const Args& a, int i, bf16* Wb,
                                           float* bs) {
  const int v0 = i * BV;
  load_tile<VEC, FNTH>(Wb + (i % FST) * DT * BV,
                       static_cast<const bf16*>(a.w) + v0, a.V, DT, BV, a.d,
                       a.V - v0);
  load_bias(bs + (i % FST) * BV, a, v0);
}

// loss and lse of rows n0 .. n0+127: x's first DT columns go once into
// registers as A fragments; W's vocab chunks come through a ring of FST
// stages, so one barrier a chunk suffices; per chunk a warp forms its
// 16 x 64 logits and folds them into a running max (log2 units,
// quad-uniform), this thread's share of the sum and the label's logit.
template <int VEC>
__global__ void __launch_bounds__(FNTH, 1) xent_fwd_tc(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Wb = reinterpret_cast<bf16*>(smem_raw);  // FST x [DT][BV]
  float* bs = reinterpret_cast<float*>(Wb + FST * DT * BV);  // FST x [BV]
  bf16* XR = reinterpret_cast<bf16*>(bs + FST * BV);  // [FROWS][RK], d > DT
  bf16* WR = XR + FROWS * RK;                         // [RK][BV], d > DT
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * FROWS;
  const int dc = min(DT, a.d);
  const int nch = (a.V + BV - 1) / BV;

  // x's rows through the ring's space into registers
  load_tile<8, FNTH>(Wb, static_cast<const bf16*>(a.x) + (long long)n0 * a.d,
                     a.d, FROWS, DT, a.N - n0, a.d);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t xa[DT / 16][4];
#pragma unroll
  for (int kb = 0; kb < DT / 16; ++kb)
    if (kb * 16 < dc)
      tc::ldsm_x4(xa[kb], Wb + tc::a_rowmajor(warp * 16, kb * 16, DT, lane));
  __syncthreads();  // every warp holds its fragments before W lands there

#pragma unroll
  for (int i = 0; i < FST - 1; ++i) {
    if (i < nch) load_chunk<VEC>(a, i, Wb, bs);
    tc::cp_async_commit();
  }

  int lab[2];
  float m[2], l[2], ll[2];  // running max (log2 units), sum share, label
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + warp * 16 + g + 8 * h;
    lab[h] = n < a.N ? a.labels[n] : -1;
    m[h] = NEG_INF;
    l[h] = ll[h] = 0.f;
  }

  for (int i = 0; i < nch; ++i) {
    const int v0 = i * BV;
    tc::cp_async_wait<FST - 2>();  // chunk i has landed
    __syncthreads();  // ... for every thread; chunk i - 1's readers are done
    if (i + FST - 1 < nch) load_chunk<VEC>(a, i + FST - 1, Wb, bs);
    tc::cp_async_commit();
    const bf16* Wc = Wb + (i % FST) * DT * BV;
    const float* bc = bs + (i % FST) * BV;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < DT / 16; ++kb) {
      if (kb * 16 >= dc) break;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, Wc + tc::b_kn(kb * 16, np * 16, BV, lane));
        tc::mma(s[2 * np], xa[kb], bf[0], bf[1]);
        tc::mma(s[2 * np + 1], xa[kb], bf[2], bf[3]);
      }
    }
    if (a.d > DT)
      s_outside<VEC, FROWS, FNTH>(s, a, n0, v0, 0, XR, WR, warp, lane);

    // logits + bias; the label's logit; log2 units, NEG_INF past V
    const bool ragged = v0 + BV > a.V;
    float cm[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = nb * 8 + 2 * t + (e & 1);
        const float z = s[nb][e] + bc[c];
        if (v0 + c == lab[h]) ll[h] += z;
        const float u = ragged && v0 + c >= a.V ? NEG_INF : z * LOG2E;
        s[nb][e] = u;
        cm[h] = fmaxf(cm[h], u);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cm[h] = fmaxf(cm[h], __shfl_xor_sync(0xffffffffu, cm[h], 1));
      cm[h] = fmaxf(cm[h], __shfl_xor_sync(0xffffffffu, cm[h], 2));
      const float m_new = fmaxf(m[h], cm[h]);
      l[h] *= ex2(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(s[nb][e] - m[e >> 1]);
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h], lab_z = ll[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lab_z += __shfl_xor_sync(0xffffffffu, lab_z, off);
    }
    const int n = n0 + warp * 16 + g + 8 * h;
    if (t == 0 && n < a.N) {
      const float lse = m[h] * LN2 + logf(fmaxf(sum, L_FLOOR));
      a.lse_out[n] = lse;
      a.loss[n] = lse - lab_z;
    }
  }
}

// dx[n0 .. n0+64][c0 .. c0+DT): x's rows resident (Xf), W's vocab
// chunks double-buffered (Wb), G kept in registers between the logits
// product and the dx product.
template <int VEC>
__global__ void __launch_bounds__(NTH, 2) xent_dx_tc(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Xf = reinterpret_cast<bf16*>(smem_raw);  // [BN][DT]
  bf16* Wb = Xf + BN * DT;                         // 2 x [DT][BV]
  float* bs = reinterpret_cast<float*>(Wb + 2 * DT * BV);  // [BV]
  bf16* XR = reinterpret_cast<bf16*>(bs + BV);     // [BN][RK], d > DT
  bf16* WR = XR + BN * RK;                         // [RK][BV], d > DT
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * DT;
  const int dc = min(DT, a.d - c0);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int nch = (a.V + BV - 1) / BV;

  load_tile<8>(Xf, x + (long long)n0 * a.d + c0, a.d, BN, DT, a.N - n0,
               a.d - c0);
  load_tile<VEC>(Wb, w + (long long)c0 * a.V, a.V, DT, BV, a.d - c0, a.V);
  tc::cp_async_commit();

  bool rv[2];
  float lse[2], gg[2];
  int lab[2];
  load_row_data(a, n0, warp, g, rv, lse, gg, lab);

  float acc[DT / 8][4];
#pragma unroll
  for (int j = 0; j < DT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < nch; ++i) {
    const int v0 = i * BV;
    const bf16* Wc = Wb + (i & 1) * DT * BV;
    if (i + 1 < nch)
      load_tile<VEC>(Wb + ((i + 1) & 1) * DT * BV,
                     w + (long long)c0 * a.V + v0 + BV, a.V, DT, BV,
                     a.d - c0, a.V - v0 - BV);
    tc::cp_async_commit();
    load_bias(bs, a, v0);  // the last chunk's readers passed its sync
    tc::cp_async_wait<1>();
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    s_accum(s, Xf, DT, 0, Wc, 0, dc / 16, warp, lane);
    if (a.d > DT) s_outside<VEC>(s, a, n0, v0, c0, XR, WR, warp, lane);
    grad_frag(s, bs, v0, a.V, rv, lse, gg, lab, t);
    uint32_t ga[4][4];  // G rounded to bf16, as the reference rounds it
    tc::c_to_a<4>(s, ga);

    // acc[16 rows][c] += G[16 rows][v] W[c][v] (W chunk stored [c][v])
#pragma unroll
    for (int np = 0; np < DT / 16; ++np) {
      if (np * 16 >= dc) break;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, Wc + tc::b_nk(np * 16, kb * 16, BV, lane));
        tc::mma(acc[2 * np], ga[kb], bf[0], bf[1]);
        tc::mma(acc[2 * np + 1], ga[kb], bf[2], bf[3]);
      }
    }
    __syncthreads();  // Wc is refilled two chunks on
  }

  bf16* dx = static_cast<bf16*>(a.dx);
#pragma unroll
  for (int j = 0; j < DT / 8; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    if (c >= a.d) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + warp * 16 + g + 8 * h;
      if (n < a.N)
        *reinterpret_cast<uint32_t*>(dx + (long long)n * a.d + c) =
            tc::pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

size_t dw_smem(int d) {
  return sizeof(bf16) * (DT * BV + 2 * BN * DT + BN * BV) +
         sizeof(float) * 5 * BV +
         (d > DT ? sizeof(bf16) * (BN * RK + RK * BV) : 0);
}

// One slice of the N reduction of dW[c0 .. c0+DT)[v0 .. v0+64) and db:
// W's chunk resident (Wf), x's row blocks double-buffered (Xb), G
// through shared memory (Gs, bf16) into x^T G. The f32 partial goes to
// work[z] (row stride Vw); db's to the tail of work.
template <int VEC>
__global__ void __launch_bounds__(NTH, 2) xent_dwdb_tc(Args a, float* work,
                                                      int S, int Vw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Wf = reinterpret_cast<bf16*>(smem_raw);  // [DT][BV]
  bf16* Xb = Wf + DT * BV;                         // 2 x [BN][DT]
  bf16* Gs = Xb + 2 * BN * DT;                     // [BN][BV]
  float* dbs = reinterpret_cast<float*>(Gs + BN * BV);  // [4][BV]
  float* bs = dbs + 4 * BV;                             // [BV]
  bf16* XR = reinterpret_cast<bf16*>(bs + BV);          // d > DT
  bf16* WR = XR + BN * RK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * BV, c0 = blockIdx.y * DT, z = blockIdx.z;
  const int dc = min(DT, a.d - c0);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int nrb = (a.N + BN - 1) / BN, rps = (nrb + S - 1) / S;
  const int rb0 = z * rps, rb1 = min(nrb, rb0 + rps);

  load_tile<VEC>(Wf, w + (long long)c0 * a.V + v0, a.V, DT, BV, a.d - c0,
                 a.V - v0);
  if (rb0 < rb1)
    load_tile<8>(Xb, x + (long long)rb0 * BN * a.d + c0, a.d, BN, DT,
                 a.N - rb0 * BN, a.d - c0);
  tc::cp_async_commit();
  load_bias(bs, a, v0);
  // db of this block's slice: a row of column sums per warp, each warp
  // adding its 16 rows' sums in row-block order
  for (int j = threadIdx.x; j < 4 * BV; j += NTH) dbs[j] = 0.f;

  float acc[4][8][4];  // dW[c0 + 64 warp + 16 mb + ..][v0 + 8 nb + ..]
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][j][e] = 0.f;

  for (int rb = rb0; rb < rb1; ++rb) {
    const int n0 = rb * BN;
    const bf16* Xc = Xb + ((rb - rb0) & 1) * BN * DT;
    if (rb + 1 < rb1)
      load_tile<8>(Xb + ((rb - rb0 + 1) & 1) * BN * DT,
                   x + (long long)(n0 + BN) * a.d + c0, a.d, BN, DT,
                   a.N - n0 - BN, a.d - c0);
    tc::cp_async_commit();
    bool rv[2];
    float lse[2], gg[2];
    int lab[2];
    load_row_data(a, n0, warp, g, rv, lse, gg, lab);
    tc::cp_async_wait<1>();
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    s_accum(s, Xc, DT, 0, Wf, 0, dc / 16, warp, lane);
    if (a.d > DT) s_outside<VEC>(s, a, n0, v0, c0, XR, WR, warp, lane);
    grad_frag(s, bs, v0, a.V, rv, lse, gg, lab, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        // G rounded to bf16 for the product, as the reference rounds it
        *reinterpret_cast<uint32_t*>(
            Gs + tc::swz(warp * 16 + g + 8 * h, nb * 8 + 2 * t, BV)) =
            tc::pack_bf16(s[nb][2 * h], s[nb][2 * h + 1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = s[nb][j] + s[nb][2 + j];  // the f32 G, for db
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (g == 0) dbs[warp * BV + nb * 8 + 2 * t + j] += v;
      }
    }
    __syncthreads();

    // acc[c][v] += sum_n x[n][c] G[n][v]: x tile stored [n][c] = [k][m],
    // Gs stored [n][v] = [k][n]
    if (warp * 64 < dc) {
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        uint32_t af[4][4];
#pragma unroll
        for (int mb = 0; mb < 4; ++mb)
          tc::ldsm_x4_t(af[mb],
                        Xc + tc::a_km(kb * 16, warp * 64 + mb * 16, DT, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, Gs + tc::b_kn(kb * 16, np * 16, BV, lane));
#pragma unroll
          for (int mb = 0; mb < 4; ++mb) {
            tc::mma(acc[mb][2 * np], af[mb], bf[0], bf[1]);
            tc::mma(acc[mb][2 * np + 1], af[mb], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // Xc and Gs are rewritten for the next row block
  }
  tc::cp_async_wait<0>();

  float* part = work + (long long)z * a.d * Vw;
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + warp * 64 + mb * 16 + g + 8 * h;
      if (c >= c0 + dc) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<float2*>(part + (long long)c * Vw + v0 + nb * 8 +
                                   2 * t) =
            make_float2(acc[mb][nb][2 * h], acc[mb][nb][2 * h + 1]);
    }

  __syncthreads();
  if (blockIdx.y == 0 && threadIdx.x < BV) {
    const int j = threadIdx.x;
    work[(long long)S * a.d * Vw + (long long)z * Vw + v0 + j] =
        ((dbs[j] + dbs[BV + j]) + dbs[2 * BV + j]) + dbs[3 * BV + j];
  }
}

// dW = sum over the S slices (in order) cast to bf16; db the same in f32
__global__ void xent_dw_reduce(const float* work, int S, int d, int V,
                               int Vw, bf16* dw, float* db) {
  const long long total = (long long)d * V + V;
  const long long plane = (long long)d * Vw;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < (long long)d * V) {
      const long long c = i / V, v = i % V;
      const float* p = work + c * Vw + v;
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += p[s * plane];
      dw[i] = __float2bfloat16(sum);
    } else {
      const long long v = i - (long long)d * V;
      const float* p = work + S * plane + v;
      float sum = 0.f;
      for (int s = 0; s < S; ++s) sum += p[(long long)s * Vw];
      db[v] = sum;
    }
  }
}

// Slices of the N reduction: at least two blocks for each block slot of
// the card (2 per SM by design), and among up to twice that many the
// count that fills the last wave best. Depends on the shape and the
// card only, so a run is reproducible bit for bit.
int dw_slices(int N, int d, int V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int slots = 2 * sms;
  const long long tiles =
      (long long)((V + BV - 1) / BV) * ((d + DT - 1) / DT);
  const int nrb = (N + BN - 1) / BN;
  int s0 = (int)((2 * slots + tiles - 1) / tiles);
  if (s0 < 1) s0 = 1;
  int best = s0;
  double best_fill = 0.0;
  for (int s = s0; s <= 2 * s0; ++s) {
    const long long blocks = tiles * s;
    const double fill =
        (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  return best < nrb ? best : nrb;
}

// elements a copy of W can move: 16 bytes where V % 8 == 0, else less
int vec_of(int V) {
  return V % 8 == 0 ? 8 : V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;
}

}  // namespace tcx

bool bad_shape(int N, int d, int V) {
  return N <= 0 || V <= 0 || d <= 0 || d % KS != 0;
}

template <typename Kernel, typename... Extra>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           int threads, const Args& a, Extra... extra) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a, extra...);
  return (int)cudaGetLastError();
}

// the bf16 kernels, instantiated at the widest copy V allows
template <template <int> class Pick, typename... Extra>
int launch_vec(int V, dim3 grid, size_t smem, cudaStream_t stream,
               const Args& a, Extra... extra) {
  switch (tcx::vec_of(V)) {
    case 8:
      return launch(Pick<8>::kernel(), grid, smem, stream,
                    Pick<8>::threads, a, extra...);
    case 4:
      return launch(Pick<4>::kernel(), grid, smem, stream,
                    Pick<4>::threads, a, extra...);
    case 2:
      return launch(Pick<2>::kernel(), grid, smem, stream,
                    Pick<2>::threads, a, extra...);
    default:
      return launch(Pick<1>::kernel(), grid, smem, stream,
                    Pick<1>::threads, a, extra...);
  }
}

template <int VEC>
struct FwdTc {
  static constexpr int threads = tcx::FNTH;
  static auto kernel() { return tcx::xent_fwd_tc<VEC>; }
};
template <int VEC>
struct DxTc {
  static constexpr int threads = tcx::NTH;
  static auto kernel() { return tcx::xent_dx_tc<VEC>; }
};
template <int VEC>
struct DwTc {
  static constexpr int threads = tcx::NTH;
  static auto kernel() { return tcx::xent_dwdb_tc<VEC>; }
};

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(xent_fwd_kernel, grid,
                  logits_smem() + sizeof(int) * BN, s, NTHREADS, a);
  if (dtype == 1)
    return launch_vec<FwdTc>(V, dim3((N + tcx::FROWS - 1) / tcx::FROWS),
                             tcx::fwd_smem(d), s, a);
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
  if (dtype == 0)
    return launch(xent_dx_kernel, grid, dx_smem(), s, NTHREADS, a);
  if (dtype == 1)
    return launch_vec<DxTc>(V, grid, tcx::dx_smem(d), s, a);
  return -1;
}

// Slices of the N reduction that the bf16 dW/db kernel splits into;
// its workspace holds slices * (d + 1) * Vw floats, Vw = V rounded up
// to a multiple of 64.
extern "C" int xent_dw_slices(int N, int d, int V) {
  if (bad_shape(N, d, V)) return -1;
  return tcx::dw_slices(N, d, V);
}

extern "C" int xent_bwd_dwdb(const void* x, const void* w, const void* b,
                             const int* labels, const float* lse,
                             const float* g, void* dw, float* db,
                             float* work, int slices, int dtype, int N,
                             int d, int V, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(xent_dwdb_kernel,
                  dim3((V + BV - 1) / BV, (d + DT - 1) / DT), dw_smem(), s,
                  NTHREADS, a);
  // the slices (the wrapper's, from `dw_slices` or a tuning table) must
  // be from 1 to the row blocks: the workspace holds `slices` partials
  if (dtype != 1 || work == nullptr || slices < 1 ||
      slices > (N + tcx::BN - 1) / tcx::BN)
    return -1;
  const int Vw = (V + tcx::BV - 1) / tcx::BV * tcx::BV;
  const dim3 grid(Vw / tcx::BV, (d + tcx::DT - 1) / tcx::DT, slices);
  int err = launch_vec<DwTc>(V, grid, tcx::dw_smem(d), s, a, work, slices,
                             Vw);
  if (err != 0) return err;
  const long long total = (long long)d * V + V;
  const int blocks = (int)(total / 256 + 1 < 8192 ? total / 256 + 1 : 8192);
  tcx::xent_dw_reduce<<<blocks, 256, 0, s>>>(
      work, slices, d, V, Vw, static_cast<__nv_bfloat16*>(dw), db);
  return (int)cudaGetLastError();
}
