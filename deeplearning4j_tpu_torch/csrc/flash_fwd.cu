// Flash-attention forward for Hopper (sm_90a): one source for the flat
// [BH, T, D] layout and the packed [B, T, 3n] projection layout, at head
// dims 32, 64, 128 and 256 (and 16 in f32, whose scalar kernels take any
// multiple of 16) and any T that is a multiple of 64.
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
//   in f32. exp is taken in f32 throughout. In bf16, p is rounded to bf16
//   for the P.V product, where the JAX blocked kernel rounds it
//   (`pd.astype(vb.dtype)`), and l sums the unrounded f32 p, as there.
//
// Attention dropout (the JAX kernels' `dropout` arm, `_keep_mask`): with
// a seed, each kernel is instantiated with DROP = true and multiplies p
// by keep * 1/(1 - rate) for P.V, after l has summed the undropped p, as
// the JAX kernels do; keep is the counter hash of csrc/dropout.cuh on the
// element's GLOBAL (b*h, query, key) coordinates, so every tile and
// kernel draws the same mask. A thread folds its row's hash base into
// one register a row; the per-element cost is the hash tail and a
// select. DROP = false compiles to the kernels without dropout.
//
// Layouts: q, k, v and o are addressed as base + b*sb + h*sh + t*st + d,
// with element strides passed by the caller. The flat layout passes H = 1
// (sh unused); the packed layout passes the [B, T, 3n] strides with k and
// v pointing n and 2n columns into the projection, so neither layout is
// copied into a per-head relayout first. lse is [B*H, T] contiguous; the
// key mask, when given, is [B, T] f32 (row b). The grid is one dimension:
// block x is (b*h, query tile) with the tile in the low bits, so B*H is
// bounded only by 2^31 / (T / 64) blocks.
//
// What bounds it. Causal attention does about 2*D*T*T FLOPs per (b, h)
// against 8*T*D bytes of bf16 q, k, v and o, i.e. T/4 FLOPs per byte:
// below the H100's ~295 bf16 ridge at the training and serving lengths
// (T = 512..1024), where the least time is set by memory, and above it
// at T = 4096 (K1's long context), where the tensor cores set it. On an
// H100 the kernel reaches neither. Timed with its K/V loads removed, it
// takes the same time at D = 128, T = 512 (K2) and at D = 256: there it is
// bound by the issue and latency of each warp's instruction stream, with
// 2 (D >= 128) or 3 (D <= 64) blocks of 4 warps an SM. At D <= 64 and at
// long T the loads still cost about a fifth to a third of the time (K3
// and K1 at D = 32 about 18-25%, K1 at D = 128, T = 1024..4096 about
// 26-33%), which the two-stage cp.async pipeline does not hide.
//
// bf16 (`tcf::fwd_tc`), the kernel of every path: both products run on
// the tensor cores as mma.sync m16n8k16 bf16 x bf16 -> f32. A block is 4
// warps and 64 queries, 16 per warp. Q's A fragments come from a
// swizzled bf16 tile by ldmatrix, once per block at D <= 128 (held in
// registers) and once per key tile at D = 256 (where 64 registers of Q
// beside 128 f32 of O would not fit). K and V stream through
// XOR-swizzled bf16 tiles that cp.async fills two stages deep: the next
// tile (with its key mask) loads while the current one multiplies, and
// no f32 copy is kept in shared memory. S = Q K^T reads K as [n][k]
// (plain ldmatrix); O += P V reads V `.trans`. P never leaves the
// registers: the row max and sum are taken across each quad with
// __shfl_xor (rows g and g+8 of the C fragment), and P's C fragments are
// packed into the A fragments of P.V (`tc::c_to_a`). The softmax works in
// log2 units, so an element costs one multiply, max, subtract, MUFU.EX2
// and add; on an H100 SXM (700 W) that took 40-48% off the kernel's
// time against expf on scores scaled in natural units. Key tiles
// wholly above the diagonal are never read, and only the tiles that
// cross a warp's diagonal mask element by element. Skipping the
// products of a warp's wholly future 16-key blocks there made the
// kernel 2.5x slower (the branches stop the compiler from interleaving
// the ldmatrix and mma streams), so they run and are masked. Query tiles
// launch heaviest first (reverse tile order), which shortens the causal
// tail. Key tiles are 64 wide, and 32 at D = 256, which keeps S at 16
// registers there. Shared memory: 20.5 KB (D = 32), 40.5 KB (64), 80.5
// KB (128) and 96.3 KB (256) a block. Two 16-row blocks a warp (128
// queries a block) was slower at D <= 64 and spilled at D >= 128.
//
// f32 (`flash_fwd_f32`): the scalar kernel on the CUDA cores, kept
// because TF32 tensor cores would not hold f32's 1e-4 agreement. One
// block of 256 threads per (64-query tile, b*h); Q and 64-key tiles of K
// and V staged as f32 in shared memory (rows padded by one float), the
// scores from 4x4 register blocks of scalar FMAs, the softmax with 4
// threads a row. 214,784 bytes of shared memory at D = 256.

#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "dropout.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr float NEG_INF = -1e30f;
constexpr float MASK_FLOOR = -1e20f;
constexpr float L_FLOOR = 1e-30f;

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
  // attention dropout (dropout.cuh), read by the DROP instantiations
  // only: the step seed in device memory, the call's global window
  // origin, the global sequence length, the keep threshold and scale
  const int* seed;
  uint32_t q_origin, k_origin, hash_t, thr;
  float keep_scale;
};

// (b*h, query tile) of this block, the heaviest causal tile first
struct Tile {
  int bh, b, h, q0;
};

__device__ __forceinline__ Tile block_tile(const Args& a) {
  const int n_qt = a.T / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int bh = (int)(blockIdx.x / n_qt);
  return Tile{bh, bh / a.H, bh % a.H, qt * BQ};
}

// ---------------------------------------------------------------------
// f32: scalar FMA on the CUDA cores

constexpr int BK = 64;
constexpr int NTHREADS = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ + BK);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32(Args a) {
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
  const Tile tile = block_tile(a);
  const int q0 = tile.q0, bh = tile.bh, b = tile.b, h = tile.h;
  const bool masked = a.kmask != nullptr;
  const uint32_t key = DROP ? drop::slice_key(a.seed, bh) : 0u;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    Qs[r * (D + 1) + c] = qp[(long long)(q0 + r) * a.q_st + c];
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
      Ks[r * (D + 1) + c] = kp[(long long)(k0 + r) * a.k_st + c];
      Vs[r * D + c] = vp[(long long)(k0 + r) * a.v_st + c];
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
      // dropout: P.V takes p * keep * scale, l the undropped p
      const uint32_t hrow = key + (a.q_origin + q0 + r) * a.hash_t +
                            a.k_origin + k0 + part * 16;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        if constexpr (DROP)
          prow[c] = drop::keep(hrow + c, a.thr) ? p * a.keep_scale : 0.f;
        else
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
      op[(long long)(q0 + r) * a.o_st + tx + 16 * j] = acc[i][j] / l;
  }
  if (tid < BQ)
    a.lse[(long long)bh * a.T + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], L_FLOOR));
}

template <int D, bool DROP>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)B * a.H * (a.T / BQ));
  flash_fwd_f32<D, DROP><<<blocks, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores (see the note at the top)

namespace tcf {

using bf16 = __nv_bfloat16;

constexpr int NTH = 128;  // 4 warps, 16 queries each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// key tile: 64 keys, 32 at D = 256
template <int D>
constexpr int KEY_TILE = D == 256 ? 32 : 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BQ * D + 4 * KEY_TILE<D> * D) +
         sizeof(float) * 2 * KEY_TILE<D>;
}

// 2^x (MUFU.EX2; inputs below -126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows r0 .. r0 + ROWS - 1 of a strided [T, D] operand into a swizzled
// tile
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTH) {
    const int r = i / VPR, c = (i % VPR) * 8;
    tc::cp_async<16>(dst + tc::swz(r, c, D),
                     src + (long long)(r0 + r) * st + c, true);
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NTH, 2) fwd_tc(Args a) {
  constexpr int BKT = KEY_TILE<D>;
  constexpr int KB = BKT / 16;     // 16-key blocks of a key tile
  constexpr int NB = BKT / 8;      // 8-key blocks: S's C fragments
  constexpr int DB = D / 16;       // 16-deep blocks of the head dim
  constexpr bool QREG = D <= 128;  // Q's A fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);           // [BQ][D]
  bf16* Ks = Qs + BQ * D;                                  // 2 x [BKT][D]
  bf16* Vs = Ks + 2 * BKT * D;                             // 2 x [BKT][D]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BKT * D);  // 2 x BKT
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Tile tile = block_tile(a);
  const int q0 = tile.q0, b = tile.b, h = tile.h;
  const bool masked = a.kmask != nullptr;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* km = masked ? a.kmask + (long long)b * a.T : nullptr;
  const int nk = a.causal ? (q0 + BQ) / BKT : a.T / BKT;
  // scores in log2 units, so that exp is one MUFU.EX2
  const float scale2 = a.sm_scale * LOG2E;

  load_tile<D, BQ>(Qs,
                   static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh,
                   a.q_st, q0);
  load_tile<D, BKT>(Ks, kp, a.k_st, 0);
  load_tile<D, BKT>(Vs, vp, a.v_st, 0);
  if (masked && threadIdx.x < BKT / 4)
    tc::cp_async<16>(Ms + 4 * threadIdx.x, km + 4 * threadIdx.x, true);
  tc::cp_async_commit();

  // this thread's rows of the C fragments: g and g + 8 of the warp's 16
  const int r_lo = q0 + warp * 16;
  int row[2];
  float m[2], l[2];  // running max (log2 units), this thread's share of l
  // dropout: the hash coordinate of this thread's first element in each
  // row, at key tile 0
  uint32_t hrow[2];
  const uint32_t key = DROP ? drop::slice_key(a.seed, tile.bh) : 0u;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = r_lo + g + 8 * hh;
    m[hh] = NEG_INF;
    l[hh] = 0.f;
    hrow[hh] = key + (a.q_origin + row[hh]) * a.hash_t + a.k_origin + 2 * t;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qa[QREG ? DB : 1][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1, k0 = kt * BKT;
    if (kt + 1 < nk) {
      const int nb = buf ^ 1;
      load_tile<D, BKT>(Ks + nb * BKT * D, kp, a.k_st, k0 + BKT);
      load_tile<D, BKT>(Vs + nb * BKT * D, vp, a.v_st, k0 + BKT);
      if (masked && threadIdx.x < BKT / 4)
        tc::cp_async<16>(Ms + nb * BKT + 4 * threadIdx.x,
                         km + k0 + BKT + 4 * threadIdx.x, true);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kc = Ks + buf * BKT * D;
    const bf16* Vc = Vs + buf * BKT * D;
    const float* Mc = Ms + buf * BKT;
    if constexpr (QREG) {
      if (kt == 0) {
#pragma unroll
        for (int kb = 0; kb < DB; ++kb)
          tc::ldsm_x4(qa[kb], Qs + tc::a_rowmajor(warp * 16, kb * 16, D,
                                                  lane));
      }
    }

    // S = Q K^T for this warp's 16 queries and the tile's keys
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < DB; ++kb) {
      uint32_t aq[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[e] = qa[kb][e];
      } else {
        tc::ldsm_x4(aq, Qs + tc::a_rowmajor(warp * 16, kb * 16, D, lane));
      }
#pragma unroll
      for (int np = 0; np < KB; ++np) {
        uint32_t bb[4];
        tc::ldsm_x4(bb, Kc + tc::b_nk(np * 16, kb * 16, D, lane));
        tc::mma(s[2 * np], aq, bb[0], bb[1]);
        tc::mma(s[2 * np + 1], aq, bb[2], bb[3]);
      }
    }

    // scale, then mask: masked keys, and future keys on a tile that
    // crosses this warp's diagonal (its last key past the warp's first
    // query)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (masked) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(Mc[j * 8 + 2 * t + (e & 1)] > 0.f)) s[j][e] = NEG_INF;
    }
    if (a.causal && k0 + BKT - 1 > r_lo) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) > row[e >> 1]) s[j][e] = NEG_INF;
    }
    // online softmax: the quad of lanes 4g .. 4g+3 holds rows g and g+8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      float m_new = fmaxf(m[hh], mx[hh]);
      if (masked) m_new = fmaxf(m_new, MASK_FLOOR * LOG2E);
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;  // the unrounded p, as the reference sums it
        // dropout: P.V takes p * keep * scale, l the undropped p
        if constexpr (DROP)
          s[j][e] = drop::keep(hrow[e >> 1] + k0 + j * 8 + (e & 1), a.thr)
                        ? p * a.keep_scale
                        : 0.f;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V, P rounded to bf16 where the reference rounds it
    uint32_t pa[KB][4];
    tc::c_to_a<KB>(s, pa);
#pragma unroll
    for (int np = 0; np < D / 16; ++np)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        uint32_t bb[4];
        tc::ldsm_x4_t(bb, Vc + tc::b_kn(kb * 16, np * 16, D, lane));
        tc::mma(acc[2 * np], pa[kb], bb[0], bb[1]);
        tc::mma(acc[2 * np + 1], pa[kb], bb[2], bb[3]);
      }
    __syncthreads();  // Kc, Vc, Mc are refilled two tiles on
  }

  bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  float* lse = a.lse + (long long)tile.bh * a.T;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float lf = fmaxf(l[hh], L_FLOOR);
    bf16* orow = op + (long long)row[hh] * a.o_st + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          tc::pack_bf16(acc[j][2 * hh] / lf, acc[j][2 * hh + 1] / lf);
    if (t == 0) lse[row[hh]] = m[hh] * LN2 + logf(lf);
  }
}

template <int D, bool DROP>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)B * a.H * (a.T / BQ));
  fwd_tc<D, DROP><<<blocks, NTH, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tcf

template <bool DROP>
int dispatch(const Args& a, int dtype, int D, int B, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16, DROP>(a, B, s);
      case 32: return launch_f32<32, DROP>(a, B, s);
      case 64: return launch_f32<64, DROP>(a, B, s);
      case 128: return launch_f32<128, DROP>(a, B, s);
      case 256: return launch_f32<256, DROP>(a, B, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return tcf::launch<32, DROP>(a, B, s);
      case 64: return tcf::launch<64, DROP>(a, B, s);
      case 128: return tcf::launch<128, DROP>(a, B, s);
      case 256: return tcf::launch<256, DROP>(a, B, s);
    }
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. seed: the int32 step seed in device
// memory, or null for no dropout; with it, q_origin, k_origin (the
// call's window in the global sequence), hash_t (the global sequence
// length), thr and keep_scale (dropout.cuh) define the keep mask.
// Returns 0 on success, a cudaError_t from the launch, or -1 for
// arguments the kernel does not take.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const float* kmask, void* o, float* lse, int dtype,
                         int D, int B, int H, int T, long long q_sb,
                         long long q_sh, long long q_st, long long k_sb,
                         long long k_sh, long long k_st, long long v_sb,
                         long long v_sh, long long v_st, long long o_sb,
                         long long o_sh, long long o_st, float sm_scale,
                         int causal, const int* seed, uint32_t q_origin,
                         uint32_t k_origin, uint32_t hash_t, uint32_t thr,
                         float keep_scale, void* stream) {
  if (T <= 0 || T % BQ != 0 || B <= 0 || H <= 0) return -1;
  const long long blocks = (long long)B * H * (T / BQ);
  if (blocks > INT_MAX) return -1;
  Args a{q,    k,    v,    kmask, o,    lse,  H,    T,        q_sb,
         q_sh, q_st, k_sb, k_sh,  k_st, v_sb, v_sh, v_st,     o_sb,
         o_sh, o_st, sm_scale, causal, seed, q_origin, k_origin, hash_t,
         thr,  keep_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seed ? dispatch<true>(a, dtype, D, B, s)
              : dispatch<false>(a, dtype, D, B, s);
}
