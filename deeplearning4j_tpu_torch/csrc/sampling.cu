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
//   differs, so where a row's nucleus mass lands within an ulp of p the
//   kept set can differ by a boundary token.
//
// Shapes: logits [B, V] f32 or bf16, noise [B, V] f32, out [B] int32, all
// row-major contiguous; thr, when not null, [B, 2] f32 receives each
// row's top-k and top-p thresholds (0 for a filter that is off). Any
// B >= 1 and V >= 1: the TPU's (8, 128) tiling envelope has no
// counterpart here.
//
// Design (smp::sample_kernel<T, NT, SMEM>), for the shapes serving gives
// it (B <= 32 rows of V = 10000):
// * A row is spread over a thread-block cluster of `cluster` blocks of NT
//   threads (the wrapper's `_plan`: 8 blocks a row at V = 10000, of 256
//   threads at [4, 10000] and of 128 at [32, 10000]; one block of 128 up
//   to V = 1024), so [4, 10000] runs on 32 SMs. Block r owns the slice
//   [r * S, (r + 1) * S) of the row, S = ceil(V / cluster), and each
//   thread the same elements on every pass. A cluster of one block is a
//   plain launch.
// * z, P and the score are computed once and held in shared memory (12
//   bytes an element: 15 KB a block at V = 10000); the first pass reads
//   the logits and the noise together. min z comes with max l ((x - m) /
//   T is monotonic, and so is its rounding) and max P with the
//   denominator (max e / denom, division being monotonic). A slice past
//   184 KB recomputes them from global memory on every pass (the same
//   operations, so the same values).
// * Reductions in two levels (Reducer): warps through `part` and
//   __syncthreads, blocks by pushing each block's total into every
//   block's `inbox` (stores to distributed shared memory) before one
//   cluster barrier; every thread folds the same partials in the same
//   order. On the H100 the cluster barrier costs about 900 cycles even
//   for one block, and pulling partials from other blocks several times
//   that, so the design counts barriers.
// * The bisections walk 4 levels a round while more than CAP = 128
//   elements lie in a walk's [lo, hi): the next 4 levels of mid = 0.5 (lo
//   + hi) are fixed by (lo, hi), so a round forms the 15 candidate mids of
//   that subtree exactly as the binary walk would (__fmul_rn(0.5f,
//   __fadd_rn(lo, hi)), heap order), counts z >= each (sums P >= each),
//   and walks the subtree on the 15 votes, with the same lo and hi bit for
//   bit (`_tree_bisect` in ops/fused_sampling.py is the plain model).
//   top-k and top-p share each round's reduction (they are independent).
//   At V = 10000 top-k needs one round, top-p three.
// * Then one pass settles every element: kept for sure, dropped for sure,
//   or in a walk's [lo, hi). The sure ones' best (score, index) and the
//   others as records go to the first block, with one barrier. Its warp 0
//   finishes each walk from its records: count(z >= mid) >= k exactly
//   when mid <= the k-th largest z, and the mass at or above mid reaches
//   top_p exactly when mid <= the P where the running sum from the largest
//   P down (from the mass at or above hi) first does, so a bitonic sort of
//   at most 128 values (32, 64 or 128 as there are) gives each walk's
//   last levels without another barrier (`_walk_model` and
//   `_finish_reference` are the plain model). It then keeps the
//   undecided records under the thresholds and writes the id. Without a
//   filter the rounds and the second pass are skipped: the settling pass
//   forms z and the score itself, and T = 1 skips the division (exact).
// * Only the top-p masses are float sums (a fixed tree in the rounds, the
//   sorted order in the finish), so every launch repeats bit for bit. The
//   argmax keeps the larger score, the lower index on ties.
//
// What bounds it. The function reads logits and noise once and writes B
// ids: (elem + 4) bytes per element, about 24 ns a row at 3.35 TB/s for
// f32 logits at V = 10000; the work per element is a compare and an add
// per bisection step on the CUDA cores, about 15 ns. At serving's batch
// sizes neither binds: the chain of barriers does (at V = 10000, with
// both filters 6: the extremes, the denominator, three rounds and the
// settling pass; top-k alone 3; no filter 2), each about 900 cycles on
// the H100 even for one block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {
namespace smp {

constexpr int BISECT_STEPS = 24;
constexpr int LEVELS = 4;                 // bisection levels a round
constexpr int NODES = (1 << LEVELS) - 1;  // candidate mids a round
static_assert(BISECT_STEPS % LEVELS == 0, "the walk takes whole rounds");
// words of one warp's partial in a round: the top-k counts of the 15
// nodes in words 0..14, the top-p masses in 16..30 and its count of live
// P in 31 (0..14 and 15 when top-p is alone)
constexpr int SLOTS = 32;
constexpr int MASS = 16;  // the first word of the masses
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
// words of a block's reduction buffers (Reducer): `inbox` and, for each
// warp of the block, its part of `part`
constexpr int INBOX_WORDS = 2 * MAX_CLUSTER * SLOTS;
constexpr int PART_WORDS = 2 * SLOTS;
// a filter's walk is finished by one warp once at most CAP elements lie
// in its [lo, hi): the words of `lists` and `undecided` that gather them
// and the elements they leave undecided (settle), and of their counters
constexpr int CAP = 128;
constexpr int REC_STRIDE = MAX_CLUSTER * 2 * CAP;  // one field's records
constexpr int RCAP = 2 * CAP;                       // records a block
constexpr int RECORD_WORDS = 4 * REC_STRIDE;
constexpr int FINISH_WORDS = CAP + 4;
// a block's z, P and score slices stay in shared memory up to this size
constexpr int ELEM_BYTES = 12;
constexpr int MAX_SLICE_BYTES = 184 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the block's dynamic shared memory
__device__ __forceinline__ uint32_t* block_smem() {
  extern __shared__ __align__(16) uint32_t smem_words[];
  return smem_words;
}

__device__ __forceinline__ float as_float(uint32_t w) {
  return __uint_as_float(w);
}
__device__ __forceinline__ uint32_t as_word(float f) {
  return __float_as_uint(f);
}
// a count (integer add) or a mass (f32 add) held as a 32-bit word
__device__ __forceinline__ uint32_t add_word(bool mass, uint32_t a,
                                             uint32_t b) {
  return mass ? as_word(__fadd_rn(as_float(a), as_float(b))) : a + b;
}

// z = d / T, IEEE; a division by 1 is exact, so T = 1 skips it
__device__ __forceinline__ float scale(float d, float temperature) {
  return temperature == 1.0f ? d : __fdiv_rn(d, temperature);
}

// 1 when x >= c, else 0, for x and c not NaN (c finite): the sign of
// x - c, which rounding keeps (an exact difference is a multiple of the
// least subnormal, and x - x is +0). Compares would each take one of a
// thread's seven predicate registers, which serialises the 15-candidate
// loops; this is three plain instructions.
__device__ __forceinline__ uint32_t at_least(float x, float c) {
  return 1u - (as_word(__fsub_rn(x, c)) >> 31);
}

// (score, index) with the larger score winning, the lower index on ties
__device__ __forceinline__ void better(float& s, int& i, float so, int io) {
  if (so > s || (so == s && io < i)) {
    s = so;
    i = io;
  }
}

// The 15 candidate mids of the next 4 bisection levels under (lo, hi),
// in heap order (c[1] the root; node n's children 2n and 2n + 1 split
// [its lo, c[n]] and [c[n], its hi]), each formed as the binary walk
// forms it.
__device__ __forceinline__ void tree(float lo, float hi,
                                     float (&c)[NODES + 1]) {
  float a[NODES + 1], b[NODES + 1];
  a[1] = lo;
  b[1] = hi;
#pragma unroll
  for (int n = 1; n <= NODES; ++n) {
    c[n] = __fmul_rn(0.5f, __fadd_rn(a[n], b[n]));
    if (2 * n <= NODES) {
      a[2 * n] = a[n];
      b[2 * n] = c[n];
      a[2 * n + 1] = c[n];
      b[2 * n + 1] = b[n];
    }
  }
  c[0] = 0.f;
}

// The binary walk down the subtree: at node n, vote bit n - 1 set means
// "the count (or mass) at c[n] reaches the target": lo = c[n], go right;
// else hi = c[n], go left. lo_node / hi_node: the last node that set lo
// / hi (0: not set in this walk).
__device__ __forceinline__ void walk(unsigned votes,
                                     const float (&c)[NODES + 1], float& lo,
                                     float& hi, int& lo_node, int& hi_node) {
  int n = 1;
  lo_node = hi_node = 0;
#pragma unroll
  for (int level = 0; level < LEVELS; ++level) {
    float m = c[1];
#pragma unroll
    for (int i = 2; i <= NODES; ++i)
      if (n == i) m = c[i];
    if ((votes >> (n - 1)) & 1u) {
      lo = m;
      lo_node = n;
      n = 2 * n + 1;
    } else {
      hi = m;
      hi_node = n;
      n = 2 * n;
    }
  }
}

// One exchange of the halving below: each lane keeps the lower or upper
// H of its first 2H words (by lane bit BIT), sends the other half to the
// lane across that bit, and adds what it receives. The halves are chosen
// by masks, as a select of two array elements would become a select of
// their addresses and put v in local memory; H is a template argument so
// the loop unrolls.
template <int H, int BIT, int NS>
__device__ __forceinline__ void halve(uint32_t (&v)[NS], bool mass) {
  const uint32_t low = (threadIdx.x & BIT) ? 0u : FULL;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const uint32_t a = v[i], b = v[i + H];
    const uint32_t keep = b ^ ((a ^ b) & low);
    const uint32_t send = a ^ ((a ^ b) & low);
    v[i] = add_word(mass, keep, __shfl_xor_sync(FULL, send, BIT));
  }
}

// A warp's NS words (counts below MASS, masses from it) reduced by
// halving: the first exchange splits the words in halves, the last leaves
// lane l with the warp's total of word rev(l). NS = 32: five exchanges,
// lane l holds word rev5(l) (the first decides the kind: lanes with bit
// 0 set keep the masses); NS = 16 (one kind, `mass`): four exchanges and
// a fifth add, lanes l and l + 16 hold word rev4(l & 15).
template <int NS>
__device__ __forceinline__ uint32_t reduce_scatter(uint32_t (&v)[NS],
                                                   bool mass) {
  if constexpr (NS == 32) {
    mass = threadIdx.x & 1;
    halve<16, 1>(v, mass);
    halve<8, 2>(v, mass);
    halve<4, 4>(v, mass);
    halve<2, 8>(v, mass);
    halve<1, 16>(v, mass);
  } else {
    halve<8, 1>(v, mass);
    halve<4, 2>(v, mass);
    halve<2, 4>(v, mass);
    halve<1, 8>(v, mass);
    v[0] = add_word(mass, v[0], __shfl_xor_sync(FULL, v[0], 16));
  }
  return v[0];
}

template <int BITS>
__device__ __forceinline__ int rev(int l) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b) r |= ((l >> b) & 1) << (BITS - 1 - b);
  return r;
}

// The cluster's reductions, in two levels. A warp's partial (up to SLOTS
// words, word w held by lane w after the warp's own reduction) goes to
// its block's `part` [2][WARPS][SLOTS]; after __syncthreads every warp
// folds the block's partials in warp order (the same bits in every
// warp). In a cluster of more than one block, warp 0 then pushes the
// block's total into the `inbox` [2][MAX_CLUSTER][SLOTS] of every block
// of the cluster (stores to distributed shared memory, which do not
// wait), the cluster barrier makes them visible, and every warp folds the
// inbox in rank order from its own block's shared memory. Pulling the
// partials from the other blocks instead costs several times the
// barrier on the H100, and pushing every warp's partial makes the barrier
// wait for eight times the stores. Both buffers are double-buffered by
// the reduction's parity, so the next reduction can be written while a
// slow warp still reads this one. Every thread ends with the same bits.
template <int WARPS>
struct Reducer {
  cg::cluster_group cl;
  uint32_t* part;   // [2][WARPS][SLOTS]
  uint32_t* inbox;  // [2][MAX_CLUSTER][SLOTS]
  int nblocks, rank, parity;

  // p's address in block r of the cluster (this block's own for r ==
  // rank, and when the cluster is one block)
  template <typename U>
  __device__ __forceinline__ U* at_rank(U* p, int r) {
    return r == rank ? p : cl.map_shared_rank(p, r);
  }
  __device__ __forceinline__ void sync() {
    if (nblocks == 1)
      __syncthreads();
    else
      cl.sync();
  }

  // Lane l < n holds word l of its warp's partial, combined by op(l, a,
  // b). Returns, in lane l < n, word l of the cluster's total.
  template <typename Op>
  __device__ __forceinline__ uint32_t reduce(uint32_t word, int n, Op op) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t* mine = part + parity * WARPS * SLOTS;
    if (lane < n) mine[warp * SLOTS + lane] = word;
    __syncthreads();
    uint32_t acc = 0;
    if (lane < n) {
      acc = mine[lane];
#pragma unroll
      for (int w = 1; w < WARPS; ++w)
        acc = op(lane, acc, mine[w * SLOTS + lane]);
    }
    if (nblocks > 1) {
      uint32_t* box = inbox + parity * MAX_CLUSTER * SLOTS;
      const int at = rank * SLOTS + lane;
      if (warp == 0 && lane < n) {
        box[at] = acc;
        for (int r = 0; r < nblocks; ++r)
          if (r != rank) cl.map_shared_rank(box, r)[at] = acc;
      }
      cl.sync();
      if (lane < n) {
        acc = box[lane];
        for (int r = 1; r < nblocks; ++r)
          acc = op(lane, acc, box[r * SLOTS + lane]);
      }
    }
    parity ^= 1;
    return acc;
  }

  // the row's max and, `with_min`, its min (of the logits)
  __device__ __forceinline__ void extremes(float& mx, float& mn,
                                           bool with_min) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      if (with_min) mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
    }
    const uint32_t t = reduce(
        as_word((threadIdx.x & 1) ? mn : mx), with_min ? 2 : 1,
        [](int slot, uint32_t a, uint32_t b) {
          return as_word(slot ? fminf(as_float(a), as_float(b))
                              : fmaxf(as_float(a), as_float(b)));
        });
    mx = as_float(__shfl_sync(FULL, t, 0));
    mn = as_float(__shfl_sync(FULL, t, 1));
  }

  // max e and sum e over the row
  __device__ __forceinline__ void stats(float& emax, float& esum) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      emax = fmaxf(emax, __shfl_xor_sync(FULL, emax, off));
      esum = __fadd_rn(esum, __shfl_xor_sync(FULL, esum, off));
    }
    const uint32_t t = reduce(
        as_word((threadIdx.x & 1) ? esum : emax), 2,
        [](int slot, uint32_t a, uint32_t b) {
          return as_word(slot ? __fadd_rn(as_float(a), as_float(b))
                              : fmaxf(as_float(a), as_float(b)));
        });
    emax = as_float(__shfl_sync(FULL, t, 0));
    esum = as_float(__shfl_sync(FULL, t, 1));
  }

  // The row's totals of each thread's NS words v (NS = 32: the counts in
  // words 0..14 and the masses in 16..30; NS = 16: one kind, `mass`).
  // Returns the total of word `lane` (NS = 32) or `lane & 15` (NS = 16).
  template <int NS>
  __device__ __forceinline__ uint32_t totals(uint32_t (&v)[NS], bool mass) {
    const int lane = threadIdx.x & 31;
    const uint32_t warp_total = reduce_scatter<NS>(v, mass);
    // lane l holds the warp's word rev(l), so lane rev(l) holds word l
    const uint32_t in_order =
        __shfl_sync(FULL, warp_total, NS == 32 ? rev<5>(lane)
                                               : rev<4>(lane & 15));
    const bool kinds = NS == 32;
    const uint32_t t = reduce(
        in_order, NS, [kinds, mass](int slot, uint32_t a, uint32_t b) {
          return add_word(kinds ? slot >= MASS : mass, a, b);
        });
    return NS == 32 ? t : __shfl_sync(FULL, t, lane & 15);
  }
};

// A filter's bisection: lo and hi, the levels walked, and what tells
// when few enough elements are left in [lo, hi) to finish in one warp:
// top-k, the exact counts of z >= lo and z >= hi (every element, and
// none, at the start); top-p, the number of P in [lo, hi) when the last
// round began (every element at the start), and the mass at or above hi
// as the rounds summed it (none at the start).
struct Walk {
  float lo, hi;
  int levels;
  int cnt_lo, cnt_hi;
  float live_p, mass_hi;
};

// One round of the bisections that are on (K: top-k, P: top-p), 4 levels
// each, both in the same reduction when both are on (they are
// independent: top-p's nucleus is over every token's P, as in the plain
// version). Each thread counts z >= each of the 15 candidates of its
// elements (and sums P >= each); top-p also counts its P in [lo, hi)
// (word 15 of its 16).
template <bool K, bool P, int WARPS, int NT, typename Z, typename PF>
__device__ __forceinline__ void bisect_round(Reducer<WARPS>& red, int j0,
                                             int j1, Z z_at, PF p_at,
                                             int top_k, float top_p,
                                             Walk& wk, Walk& wp) {
  constexpr int NS = K && P ? 32 : 16;
  constexpr int PM = K && P ? MASS : 0;  // the first top-p word
  constexpr int BATCH = 2;  // elements whose loads are issued together
  const int lane = threadIdx.x & 31;
  float ck[NODES + 1], cp[NODES + 1];
  if (K) tree(wk.lo, wk.hi, ck);
  if (P) tree(wp.lo, wp.hi, cp);
  int cnt[NODES];
  float mass[NODES], live = 0.f;
#pragma unroll
  for (int n = 0; n < NODES; ++n) {
    cnt[n] = 0;
    mass[n] = 0.f;
  }
  for (int j = j0 + threadIdx.x; j < j1; j += BATCH * NT) {
    // a missing element: z = -inf counts for no candidate, P = -1 adds
    // to no mass and is not live (every candidate is finite, P's >= 0)
    float z[BATCH], pr[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int jj = j + u * NT;
      if (K) z[u] = jj < j1 ? z_at(jj) : -INFINITY;
      if (P) pr[u] = jj < j1 ? p_at(jj) : -1.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
#pragma unroll
      for (int n = 1; n <= NODES; ++n) {
        if (K) cnt[n - 1] += at_least(z[u], ck[n]);
        if (P)
          mass[n - 1] = __fadd_rn(
              mass[n - 1],
              as_float(as_word(pr[u]) & (0u - at_least(pr[u], cp[n]))));
      }
      if (P)
        live += (float)(at_least(pr[u], wp.lo) &
                        (1u - at_least(pr[u], wp.hi)));
    }
  }
  uint32_t v[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) v[n] = 0;
#pragma unroll
  for (int n = 0; n < NODES; ++n) {
    if (K) v[n] = (uint32_t)cnt[n];
    if (P) v[PM + n] = as_word(mass[n]);
  }
  if (P) v[PM + NODES] = as_word(live);
  const uint32_t total = red.template totals<NS>(v, !K);
  const int slot = NS == 32 ? lane : lane & 15;
  const bool is_p = P && slot >= PM;
  const int node_slot = is_p ? slot - PM : slot;
  const bool reaches =
      node_slot < NODES && (is_p ? as_float(total) >= top_p
                                 : (int)total >= top_k);
  const unsigned votes = __ballot_sync(FULL, reaches);
  int lo_node, hi_node;
  if (K) {
    walk(votes & ((1u << NODES) - 1), ck, wk.lo, wk.hi, lo_node, hi_node);
    // the counts at the new bounds, from the lanes that hold them
    const int c_lo = (int)__shfl_sync(FULL, total, max(lo_node - 1, 0));
    const int c_hi = (int)__shfl_sync(FULL, total, max(hi_node - 1, 0));
    if (lo_node) wk.cnt_lo = c_lo;
    if (hi_node) wk.cnt_hi = c_hi;
    wk.levels += LEVELS;
  }
  if (P) {
    walk((votes >> PM) & ((1u << NODES) - 1), cp, wp.lo, wp.hi, lo_node,
         hi_node);
    wp.live_p = as_float(__shfl_sync(FULL, total, PM + NODES));
    const float m_hi =
        as_float(__shfl_sync(FULL, total, PM + max(hi_node - 1, 0)));
    if (hi_node) wp.mass_hi = m_hi;
    wp.levels += LEVELS;
  }
}

// The rest of a walk, one level a step, now that its decision is known:
// for top-k, count(z >= mid) >= k exactly when mid <= the k-th largest z;
// for top-p, the mass at or above mid reaches top_p exactly when mid <=
// the P at which the descending running sum (from the mass at or above
// hi) first does.
__device__ __forceinline__ void finish(Walk& w, float bound) {
  for (; w.levels < BISECT_STEPS; ++w.levels) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(w.lo, w.hi));
    if (mid <= bound)
      w.lo = mid;
    else
      w.hi = mid;
  }
}

// What is left after the rounds, in one pass and one barrier. Each
// element is kept for sure (z >= k_hi and P >= p_hi), dropped for sure
// (z < k_lo or P < p_lo), or undecided; a filter that is off has both
// bounds at -inf, one that its rounds finished both at its threshold, so
// only the walks still to finish leave elements undecided. Each thread
// keeps the best (score, index) of its sure ones. The elements in [lo,
// hi) of a walk still to finish (which include the undecided ones) are
// written as records (z, P, score, index) into the first block's
// `records` [4][MAX_CLUSTER][2 * CAP], each block's at the places a
// counter of its own gives. After __syncthreads warp 0 pushes the block's
// best and its count of records into the first block's `inbox`; then one
// barrier. The records' order varies from launch to launch, but what the
// first block computes from them (`finish_k`, `finish_p`, the best) does
// not depend on it.
template <int WARPS, int NT, typename Z, typename S, typename PF>
__device__ __forceinline__ void settle(Reducer<WARPS>& red, int j0, int j1,
                                       Z z_at, S score_at, PF p_at,
                                       bool use_p, const float (&lo)[2],
                                       const float (&hi)[2],
                                       const float (&open)[2],
                                       float* records, int* count,
                                       float& best, int& best_j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* rec = red.at_rank(records, 0) + red.rank * RCAP;
#pragma unroll 4
  for (int j = j0 + threadIdx.x; j < j1; j += NT) {
    const float z = z_at(j);
    const float pr = use_p ? p_at(j) : 0.f;
    const float sc = score_at(j, z);
    if (z >= hi[0] && pr >= hi[1]) better(best, best_j, sc, j);
    // in [lo, hi) of a walk still to finish (whose open bound is hi; the
    // others' is -inf)
    if ((z >= lo[0] && z < open[0]) || (pr >= lo[1] && pr < open[1])) {
      const int at = atomicAdd(count, 1);
      rec[at] = z;
      rec[REC_STRIDE + at] = pr;
      rec[2 * REC_STRIDE + at] = sc;
      rec[3 * REC_STRIDE + at] = __int_as_float(j);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(FULL, best, off);
    const int io = __shfl_xor_sync(FULL, best_j, off);
    better(best, best_j, so, io);
  }
  uint32_t* mine = red.part + red.parity * WARPS * SLOTS;
  if (lane == 0) {
    mine[warp * SLOTS] = as_word(best);
    mine[warp * SLOTS + 1] = (uint32_t)best_j;
  }
  __syncthreads();
  uint32_t* box = red.inbox + red.parity * MAX_CLUSTER * SLOTS;
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      better(best, best_j, as_float(mine[w * SLOTS]),
             (int)mine[w * SLOTS + 1]);
    if (lane < 3) {
      const uint32_t word = lane == 0   ? as_word(best)
                            : lane == 1 ? (uint32_t)best_j
                                        : (uint32_t)*count;
      red.at_rank(box, 0)[red.rank * 4 + lane] = word;
    }
  }
  if (red.nblocks > 1) {
    red.cl.sync();
    if (red.rank == 0 && warp == 0)
      for (int r = 1; r < red.nblocks; ++r)
        better(best, best_j, as_float(box[r * 4]), (int)box[r * 4 + 1]);
  } else {
    __syncwarp();
  }
}

// Warp 0 of the first block: the records of every block, at most
// 2 * CAP, in registers: record e (blocks in rank order, each block's in
// its order) is R[i] of lane e % 32, i = e / 32; `cnt` of them.
struct Held {
  float z[RCAP / 32], p[RCAP / 32], score[RCAP / 32];
  int index[RCAP / 32];
  int cnt;
};

__device__ __forceinline__ void hold(const float* records,
                                     const uint32_t* box, int nblocks,
                                     Held& h) {
  const int lane = threadIdx.x & 31;
  // block r's first record: lane r holds its count, then the scan
  const int mine = lane < nblocks ? (int)box[lane * 4 + 2] : 0;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += o;
  }
  int first[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    first[r] = __shfl_sync(FULL, incl - mine, r);
  h.cnt = __shfl_sync(FULL, incl, 31);
#pragma unroll
  for (int i = 0; i < RCAP / 32; ++i) {
    const int e = i * 32 + lane;
    if (i * 32 >= h.cnt) {  // (the same in every lane)
      h.z[i] = h.p[i] = h.score[i] = -INFINITY;
      h.index[i] = 0x7fffffff;
      continue;
    }
    int r = 0;
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < nblocks && first[q] <= e) r = q;
    const float* rec = records + r * RCAP + (e - first[r]);
    const bool in = e < h.cnt;
    h.z[i] = in ? rec[0] : -INFINITY;
    h.p[i] = in ? rec[REC_STRIDE] : -INFINITY;
    h.score[i] = in ? rec[2 * REC_STRIDE] : -INFINITY;
    h.index[i] = in ? __float_as_int(rec[3 * REC_STRIDE]) : 0x7fffffff;
  }
}

// the held values in [lo, hi) of walk f (0: z, 1: P) written to `list`
// in the held order; returns how many
__device__ __forceinline__ int gather(const Held& h, int f, float lo,
                                      float hi, float* list) {
  const int lane = threadIdx.x & 31;
  int n = 0;
#pragma unroll
  for (int i = 0; i < RCAP / 32; ++i) {
    if (i * 32 >= h.cnt) break;
    const float x = f == 0 ? h.z[i] : h.p[i];
    const bool in = x >= lo && x < hi;
    const unsigned m = __ballot_sync(FULL, in);
    if (in) list[n + __popc(m & ((1u << lane) - 1))] = x;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// One stage (block size K, distance J) of a bitonic sort, ascending, of
// the warp's 32 * PER values, value i of lane l at index PER * l + i:
// distances below PER inside a lane, the others across lanes by
// shuffles.
template <int PER, int K, int J>
__device__ __forceinline__ void bitonic_stage(float (&v)[PER]) {
  const int lane = threadIdx.x & 31;
  if constexpr (J >= PER) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = PER * lane + i;
      const float o = __shfl_xor_sync(FULL, v[i], J / PER);
      v[i] = ((e & J) == 0) == ((e & K) == 0) ? fminf(v[i], o)
                                              : fmaxf(v[i], o);
    }
  } else {
#pragma unroll
    for (int a = 0; a < PER; ++a) {
      const int b = a ^ J;
      if (b > a) {
        const bool asc = ((PER * lane + a) & K) == 0;
        const float lo = fminf(v[a], v[b]), hi = fmaxf(v[a], v[b]);
        v[a] = asc ? lo : hi;
        v[b] = asc ? hi : lo;
      }
    }
  }
}

template <int PER, int K = 2, int J = K / 2>
__device__ __forceinline__ void bitonic_sort(float (&v)[PER]) {
  bitonic_stage<PER, K, J>(v);
  if constexpr (J > 1)
    bitonic_sort<PER, K, J / 2>(v);
  else if constexpr (K < PER * 32)
    bitonic_sort<PER, 2 * K>(v);
}

// Warp 0: the n values of list f sorted ascending as v[i] of lane l at
// index PER * l + i, `pad` filling the places past n.
template <int PER>
__device__ __forceinline__ void load_sorted(const float* list, int n,
                                            float pad, float (&v)[PER]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = PER * lane + i;
    v[i] = e < n ? list[e] : pad;
  }
  bitonic_sort<PER>(v);
}

// value `at` (an index of the ascending order) of the sorted warp
template <int PER>
__device__ __forceinline__ float sorted_at(const float (&v)[PER], int at) {
  float mine = v[0];
#pragma unroll
  for (int i = 1; i < PER; ++i)
    if (at % PER == i) mine = v[i];
  return __shfl_sync(FULL, mine, at / PER);
}

// Warp 0, top-k: z_(k) lies in [lo, hi), so it is the (k - above)-th
// largest of the n there; the walk's last levels follow from it.
template <int PER>
__device__ __forceinline__ void finish_k(Walk& w, const float* list, int n,
                                         int top_k) {
  float v[PER];
  load_sorted<PER>(list, n, -INFINITY, v);
  const int rank = min(max(top_k - w.cnt_hi, 1), n);  // from the top
  finish(w, sorted_at<PER>(v, PER * 32 - rank));
}

// Warp 0, top-p: the running sum from the largest P in [lo, hi) down,
// from the mass at or above hi; its first value that reaches top_p
// decides the walk's last levels. The higher lanes hold the larger P:
// lane l sums its own from v[PER - 1] down, after every higher lane's.
template <int PER>
__device__ __forceinline__ void finish_p(Walk& w, const float* list, int n,
                                         float top_p) {
  const int lane = threadIdx.x & 31;
  float v[PER], loc[PER];
  load_sorted<PER>(list, n, 0.f, v);
  loc[PER - 1] = v[PER - 1];
#pragma unroll
  for (int i = PER - 2; i >= 0; --i) loc[i] = __fadd_rn(loc[i + 1], v[i]);
  float incl = loc[0];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_down_sync(FULL, incl, d);
    if (lane + d < 32) incl = __fadd_rn(incl, o);
  }
  const float after = __shfl_down_sync(FULL, incl, 1);
  const float start = __fadd_rn(w.mass_hi, lane < 31 ? after : 0.f);
  int here = -1;
#pragma unroll
  for (int i = PER - 1; i >= 0; --i)
    if (here < 0 && __fadd_rn(start, loc[i]) >= top_p) here = i;
  const unsigned hit = __ballot_sync(FULL, here >= 0);
  float bound = -INFINITY;
  if (w.mass_hi >= top_p) {
    bound = INFINITY;
  } else if (hit) {
    const int l = 31 - __clz(hit);
    bound = sorted_at<PER>(v, PER * l + __shfl_sync(FULL, here, l));
  }
  finish(w, bound);
}

template <typename T, int NT, bool SMEM>
__global__ void __launch_bounds__(NT)
    sample_kernel(const T* __restrict__ logits,
                  const float* __restrict__ noise, int* __restrict__ out,
                  float* __restrict__ thr, int V, int slice,
                  float temperature, int top_k, float top_p) {
  constexpr int WARPS = NT / 32;
  cg::cluster_group cl = cg::this_cluster();
  const int ncl = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int row = blockIdx.x / ncl;
  const int tid = threadIdx.x;
  uint32_t* part = block_smem();
  uint32_t* inbox = part + PART_WORDS * WARPS;
  float* records = reinterpret_cast<float*>(inbox + INBOX_WORDS);
  float* list = records + RECORD_WORDS;
  int* count = reinterpret_cast<int*>(list + CAP);
  float* zs = reinterpret_cast<float*>(count + 4);
  float* ps = zs + slice;  // e, then P
  float* ss = ps + slice;  // the noise, then the score
  const int j0 = rank * slice;
  const int j1 = min(V, j0 + slice);
  const T* l = logits + (size_t)row * V;
  const float* nz = noise + (size_t)row * V;
  Reducer<WARPS> red{cl, part, inbox, ncl, rank, 0};
  if (tid == 0) *count = 0;  // read after a barrier

  float m = -INFINITY, lmin = INFINITY;
#pragma unroll 4
  for (int j = j0 + tid; j < j1; j += NT) {
    const float x = to_float(l[j]);
    m = fmaxf(m, x);
    lmin = fminf(lmin, x);
    if constexpr (SMEM) {
      zs[j - j0] = x;
      ss[j - j0] = nz[j];
    }
  }
  const bool use_k = top_k > 0;
  const bool use_p = top_p < 1.0f;
  red.extremes(m, lmin, use_k);
  // min z, as (x - m) / T is monotonic in x and so is its rounding
  const float zmin = scale(__fsub_rn(lmin, m), temperature);

  // with no filter on, the last pass (settle) forms z and the score from
  // the logits and the noise where they lie
  const bool formed = use_k || use_p;
  float emax = 0.f, esum = 0.f;
#pragma unroll 4
  for (int j = j0 + tid; formed && j < j1; j += NT) {
    float x;
    if constexpr (SMEM)
      x = zs[j - j0];
    else
      x = to_float(l[j]);
    const float z = scale(__fsub_rn(x, m), temperature);
    if constexpr (SMEM) {
      zs[j - j0] = z;
      ss[j - j0] = __fadd_rn(z, ss[j - j0]);
    }
    if (use_p) {
      const float e = expf(z);
      if constexpr (SMEM) ps[j - j0] = e;
      esum = __fadd_rn(esum, e);
      emax = fmaxf(emax, e);
    }
  }
  if (use_p) red.stats(emax, esum);
  const float denom = esum;

  auto z_at = [=](int j) -> float {
    if constexpr (SMEM)
      if (formed) return zs[j - j0];
    return scale(__fsub_rn(SMEM ? zs[j - j0] : to_float(l[j]), m),
                 temperature);
  };
  // the score of element j, whose z is z
  auto score_at = [=](int j, float z) -> float {
    if constexpr (SMEM)
      if (formed) return ss[j - j0];
    return __fadd_rn(z, SMEM ? ss[j - j0] : nz[j]);
  };
  auto p_at = [=](int j) -> float {
    if constexpr (SMEM) return ps[j - j0];
    return __fdiv_rn(expf(z_at(j)), denom);
  };

  if constexpr (SMEM)
    if (use_p)
      for (int j = j0 + tid; j < j1; j += NT)
        ps[j - j0] = __fdiv_rn(ps[j - j0], denom);
  // the walks, in rounds over the cluster while more than CAP elements
  // of a filter lie in its [lo, hi), then finished by one warp
  Walk wk{__fsub_rn(zmin, 1.0f), 1e-6f, use_k ? 0 : BISECT_STEPS, V, 0,
          0.f, 0.f};
  Walk wp{0.f, __fadd_rn(__fdiv_rn(emax, denom), 1e-6f),
          use_p ? 0 : BISECT_STEPS, 0, 0, (float)V, 0.f};
  auto k_more = [&] {
    return wk.levels < BISECT_STEPS && wk.cnt_lo - wk.cnt_hi > CAP;
  };
  auto p_more = [&] {
    return wp.levels < BISECT_STEPS && wp.live_p > (float)CAP;
  };
  for (bool k = k_more(), q = p_more(); k || q; k = k_more(), q = p_more()) {
    if (k && q)
      bisect_round<true, true, WARPS, NT>(red, j0, j1, z_at, p_at, top_k,
                                          top_p, wk, wp);
    else if (k)
      bisect_round<true, false, WARPS, NT>(red, j0, j1, z_at, p_at, top_k,
                                           top_p, wk, wp);
    else
      bisect_round<false, true, WARPS, NT>(red, j0, j1, z_at, p_at, top_k,
                                           top_p, wk, wp);
  }
  const bool k_fin = wk.levels < BISECT_STEPS;
  const bool p_fin = wp.levels < BISECT_STEPS;
  // the bounds that settle an element (see settle)
  const float lo[2] = {use_k ? wk.lo : -INFINITY, use_p ? wp.lo : -INFINITY};
  const float hi[2] = {use_k ? (k_fin ? wk.hi : wk.lo) : -INFINITY,
                       use_p ? (p_fin ? wp.hi : wp.lo) : -INFINITY};
  const float open[2] = {k_fin ? wk.hi : -INFINITY,
                         p_fin ? wp.hi : -INFINITY};
  float best = -INFINITY;
  int best_j = V;
  settle<WARPS, NT>(red, j0, j1, z_at, score_at, p_at, use_p, lo, hi, open,
                    records, count, best, best_j);
  if (rank != 0 || tid >= 32) return;
  // the first block's warp 0: the walks' last levels, then the undecided
  // elements kept under the thresholds
  const uint32_t* box = inbox + red.parity * MAX_CLUSTER * SLOTS;
  Held h;
  h.cnt = 0;
  if (k_fin || p_fin) hold(records, box, ncl, h);
  if (k_fin) {
    const int n = gather(h, 0, wk.lo, wk.hi, list);
    if (n <= 32)
      finish_k<1>(wk, list, n, top_k);
    else if (n <= 64)
      finish_k<2>(wk, list, n, top_k);
    else
      finish_k<4>(wk, list, n, top_k);
  }
  if (p_fin) {
    const int n = gather(h, 1, wp.lo, wp.hi, list);
    if (n <= 32)
      finish_p<1>(wp, list, n, top_p);
    else if (n <= 64)
      finish_p<2>(wp, list, n, top_p);
    else
      finish_p<4>(wp, list, n, top_p);
  }
  const float thr_k = use_k ? wk.lo : 0.f;
  const float thr_p = use_p ? wp.lo : 0.f;
  // the undecided records that the thresholds keep (the sure ones are in
  // best already)
#pragma unroll
  for (int i = 0; i < RCAP / 32; ++i) {
    if (i * 32 >= h.cnt) break;
    const float z = h.z[i], pr = h.p[i];
    if (z >= lo[0] && pr >= lo[1] && !(z >= hi[0] && pr >= hi[1]) &&
        (!use_k || z >= thr_k) && (!use_p || pr >= thr_p))
      better(best, best_j, h.score[i], h.index[i]);
  }
  if (h.cnt > 0) {  // else every lane holds the best already
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float so = __shfl_xor_sync(FULL, best, off);
      const int io = __shfl_xor_sync(FULL, best_j, off);
      better(best, best_j, so, io);
    }
  }
  if (tid == 0) {
    out[row] = best_j;
    if (thr != nullptr) {
      thr[2 * row] = thr_k;
      thr[2 * row + 1] = thr_p;
    }
  }
}

template <typename T, int NT, bool SMEM>
int launch(const void* logits, const void* noise, void* out, float* thr,
           int B, int V, int cluster, float temperature, int top_k,
           float top_p, cudaStream_t stream) {
  constexpr int SCRATCH =
      (INBOX_WORDS + RECORD_WORDS + FINISH_WORDS + PART_WORDS * (NT / 32)) *
      4;
  static_assert(SCRATCH + MAX_SLICE_BYTES <= 232448,
                "over the 227 KB of shared memory a block can have");
  const int slice = (V + cluster - 1) / cluster;
  const size_t smem = SCRATCH + (SMEM ? (size_t)slice * ELEM_BYTES : 0);
  auto kernel = sample_kernel<T, NT, SMEM>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SCRATCH + MAX_SLICE_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // a cluster of one block is a plain launch (the kernel's cluster is
  // then the implicit one of its block)
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  // a cluster's blocks must be resident together: asked once per
  // instantiation and cluster size, again when more shared memory is asked
  static size_t checked[MAX_CLUSTER + 1] = {};
  if (cluster > 1 && smem > checked[cluster]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return -2;
    checked[cluster] = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(logits),
      static_cast<const float*>(noise), static_cast<int*>(out), thr, V, slice,
      temperature, top_k, top_p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T, int NT>
int by_slice(const void* logits, const void* noise, void* out, float* thr,
             int B, int V, int cluster, float temperature, int top_k,
             float top_p, cudaStream_t s) {
  const long long slice = (V + cluster - 1) / cluster;
  if (slice * ELEM_BYTES <= MAX_SLICE_BYTES)
    return launch<T, NT, true>(logits, noise, out, thr, B, V, cluster,
                               temperature, top_k, top_p, s);
  return launch<T, NT, false>(logits, noise, out, thr, B, V, cluster,
                              temperature, top_k, top_p, s);
}

template <typename T>
int by_threads(const void* logits, const void* noise, void* out, float* thr,
               int B, int V, int threads, int cluster, float temperature,
               int top_k, float top_p, cudaStream_t s) {
  switch (threads) {
    case 128:
      return by_slice<T, 128>(logits, noise, out, thr, B, V, cluster,
                              temperature, top_k, top_p, s);
    case 256:
      return by_slice<T, 256>(logits, noise, out, thr, B, V, cluster,
                              temperature, top_k, top_p, s);
  }
  return -1;
}

}  // namespace smp
}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16. top_k = 0 and top_p = 1 switch
// the two filters off (the wrapper decides, as the JAX package does).
// threads (128 or 256) and cluster (1 to 8): the launch's plan, from
// the wrapper's `_plan`. thr: null, or [B, 2] f32 for the thresholds.
// Returns 0 on success, a cudaError_t from the launch, -2 when a cluster
// of that size cannot be resident, or -1 for arguments the kernel does
// not take.
extern "C" int fused_sample(const void* logits, const void* noise, void* out,
                            float* thr, int dtype, int B, int V,
                            float temperature, int top_k, float top_p,
                            int threads, int cluster, void* stream) {
  if (B <= 0 || V <= 0 || !(temperature > 0.f) || top_k < 0 ||
      top_k >= V || cluster < 1 || cluster > smp::MAX_CLUSTER)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return smp::by_threads<float>(logits, noise, out, thr, B, V, threads,
                                  cluster, temperature, top_k, top_p, s);
  if (dtype == 1)
    return smp::by_threads<__nv_bfloat16>(logits, noise, out, thr, B, V,
                                          threads, cluster, temperature,
                                          top_k, top_p, s);
  return -1;
}
