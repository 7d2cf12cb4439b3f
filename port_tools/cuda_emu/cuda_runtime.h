// CPU emulation of the part of the CUDA runtime that the port's kernels
// use (see emulate.py): each CUDA thread is a fiber (a stack of its own,
// ucontext) of the launching host thread, the blocks of a grid run one
// after another (the blocks of one thread-block cluster together,
// launched by cudaLaunchKernelEx), and a warp's collective operations
// (shuffles, ballots, ldmatrix, mma.sync) meet at a barrier of its 32
// threads. A fiber runs until it waits at a barrier, then the next one
// runs, round robin: one host thread a launch, so the emulation's speed
// does not hang on how many cores the host has free.
#pragma once
#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <stdexcept>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(...)

struct uint3e {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local uint3e threadIdx, blockIdx;
extern dim3 blockDim, gridDim;

struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

// the IEEE single-precision operations, rounded to nearest (the host's
// own; the emulation builds without FMA contraction)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16,
  cudaLaunchAttributeClusterDimension = 4
};
// the dynamic shared memory a block may ask for: at most 227 KB
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int attr, int value) {
  return attr == cudaFuncAttributeMaxDynamicSharedMemorySize &&
                 value > 232448
             ? 1
             : 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
// an H100's 132 SMs
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 132;
  return 0;
}

using std::max;
using std::min;

// a CUDA thread: its fiber, its coordinates and rendezvous, and a slot
// for per-thread emulation state (emu_tc.h's cp.async groups)
struct EmuBlock;
struct EmuCluster;
struct EmuFiber {
  ucontext_t ctx;
  ucontext_t* back = nullptr;
  void* stack = nullptr;
  std::function<void()> body;
  uint3e tid{}, bid{};
  EmuBlock* blk = nullptr;
  EmuCluster* cluster = nullptr;
  unsigned rank = 0;
  unsigned char* smem = nullptr;
  void* slot = nullptr;
  void (*slot_free)(void*) = nullptr;
  bool done = false;
};
inline thread_local EmuFiber* g_fiber = nullptr;
// arrivals at barriers and returns of fibers: a round of every waiting
// fiber that adds none is a deadlock (a barrier some threads skip)
inline thread_local unsigned long g_emu_events = 0;
// a running fiber gives the host thread back to the scheduler
inline void emu_yield() { swapcontext(&g_fiber->ctx, g_fiber->back); }

// a barrier of n fibers: each arrival waits until the n-th has arrived
struct EmuBarrier {
  unsigned n, arrived = 0;
  unsigned long phase = 0;
  explicit EmuBarrier(unsigned count) : n(count) {}
  void arrive_and_wait() {
    const unsigned long mine = phase;
    ++g_emu_events;
    if (++arrived == n) {
      arrived = 0;
      ++phase;
      return;
    }
    while (phase == mine) emu_yield();
  }
};

// the rendezvous of one block: a barrier of all its threads, one of each
// warp, and exchange slots (16 words a lane)
struct EmuBlock {
  EmuBarrier* block;
  EmuBarrier* warps[32];
  uint64_t slots[32][32][16];
};
// a thread-block cluster: a barrier of all its threads, and each block's
// dynamic shared memory (its distributed shared memory)
struct EmuCluster {
  EmuBarrier* all;
  unsigned blocks;
  size_t bytes;
  unsigned char* smem[8];
};
// the calling thread's block, cluster, rank in it and shared memory
extern thread_local EmuBlock* g_blk;
extern thread_local EmuCluster* g_cluster;
extern thread_local unsigned g_rank;
extern thread_local unsigned char* g_smem;
// fills the kernel's shared memory with NaN before each block
extern void (*emu_poison)();

// the dynamic shared memory of a block in a cudaLaunchKernelEx launch
inline void* emu_block_smem() { return g_smem; }

// each fiber's stack: reserved, not committed, so a block of 1024
// threads costs only the pages its kernel touches
constexpr size_t kEmuStack = 4u << 20;

inline void emu_fiber_entry() {
  EmuFiber* f = g_fiber;
  f->body();
  f->done = true;
  ++g_emu_events;
  swapcontext(&f->ctx, f->back);
}

// run the fibers round robin until every one has returned, each resumed
// with its thread's coordinates in place; then free their stacks and
// slots
inline void emu_run(std::vector<EmuFiber>& fibers) {
  ucontext_t main;
  for (auto& f : fibers) {
    f.stack = mmap(nullptr, kEmuStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (f.stack == MAP_FAILED) throw std::runtime_error("fiber stack");
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack;
    f.ctx.uc_stack.ss_size = kEmuStack;
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, emu_fiber_entry, 0);
    f.back = &main;
  }
  size_t live = fibers.size();
  while (live) {
    const unsigned long before = g_emu_events;
    for (auto& f : fibers) {
      if (f.done) continue;
      g_fiber = &f;
      threadIdx = f.tid;
      blockIdx = f.bid;
      g_blk = f.blk;
      g_cluster = f.cluster;
      g_rank = f.rank;
      g_smem = f.smem;
      swapcontext(&main, &f.ctx);
      if (f.done) --live;
    }
    if (live && g_emu_events == before)
      throw std::runtime_error("emulated threads wait at barriers that "
                               "no other thread reaches");
  }
  g_fiber = nullptr;
  for (auto& f : fibers) {
    munmap(f.stack, kEmuStack);
    if (f.slot) f.slot_free(f.slot);
  }
}

inline void __syncthreads() { g_blk->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_blk->warps[threadIdx.x >> 5]->arrive_and_wait();
}
// the 32-bit word v of every lane of the warp, then the one of lane `src`
template <typename T>
inline T emu_exchange(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  uint32_t u;
  std::memcpy(&u, &v, 4);
  g_blk->slots[w][l][0] = u;
  __syncwarp();
  const uint32_t r = (uint32_t)g_blk->slots[w][src & 31][0];
  __syncwarp();
  T out;
  std::memcpy(&out, &r, 4);
  return out;
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_exchange(v, (int)(threadIdx.x & 31) ^ mask);
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, src);
}
// lane l gets lane l + d's value (its own past lane 31), or l - d's
template <typename T>
inline T __shfl_down_sync(unsigned, T v, int d) {
  const int l = threadIdx.x & 31;
  return emu_exchange(v, l + d < 32 ? l + d : l);
}
template <typename T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  const int l = threadIdx.x & 31;
  return emu_exchange(v, l >= d ? l - d : l);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x >> 5;
  g_blk->slots[w][threadIdx.x & 31][0] = pred ? 1 : 0;
  __syncwarp();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l)
    if (g_blk->slots[w][l][0]) r |= 1u << l;
  __syncwarp();
  return r;
}

// kernel<<<grid, block, smem>>>(args...), rewritten by emulate.py
template <typename... P, typename... A>
void emu_launch(void (*k)(P...), dim3 grid, int block, size_t smem,
                A... args) {
  if (smem > 232448) throw std::runtime_error("shared memory over 227 KB");
  gridDim = grid;
  blockDim = dim3((unsigned)block);
  const unsigned n = (unsigned)block;
  for (unsigned bi = 0; bi < grid.x * grid.y * grid.z; ++bi) {
    const unsigned bx = bi % grid.x, by = bi / grid.x % grid.y,
                   bz = bi / grid.x / grid.y;
    EmuBlock blk;
    EmuBarrier bb(n);
    std::vector<EmuBarrier> wb;
    wb.reserve((n + 31) / 32);
    for (unsigned w = 0; w < (n + 31) / 32; ++w)
      wb.emplace_back(std::min(32u, n - 32 * w));
    blk.block = &bb;
    for (unsigned w = 0; w < wb.size(); ++w) blk.warps[w] = &wb[w];
    emu_poison();
    std::vector<EmuFiber> fibers(n);
    for (unsigned tx = 0; tx < n; ++tx) {
      EmuFiber& f = fibers[tx];
      f.tid = {tx, 0, 0};
      f.bid = {bx, by, bz};
      f.blk = &blk;
      f.body = [&] { k(args...); };
    }
    emu_run(fibers);
  }
}

// cudaLaunchKernelEx with a cluster dimension: the blocks of one cluster
// run together (every thread of them a host thread), each with its own
// dynamic shared memory, poisoned with NaN, which the others reach
// through cooperative_groups' map_shared_rank; clusters run one after
// another. A grid along x only.
template <typename... P, typename... A>
void emu_launch_cluster(void (*k)(P...), dim3 grid, unsigned block,
                        size_t smem, unsigned cl, A... args) {
  if (smem > 232448) throw std::runtime_error("shared memory over 227 KB");
  if (cl < 1 || cl > 8 || grid.x % cl || grid.y != 1 || grid.z != 1)
    throw std::runtime_error("cluster shape the emulation does not take");
  gridDim = grid;
  blockDim = dim3(block);
  const unsigned n = block;
  for (unsigned c0 = 0; c0 < grid.x; c0 += cl) {
    std::vector<std::vector<unsigned char>> mem(
        cl, std::vector<unsigned char>(std::max<size_t>(smem, 1), 0xff));
    std::vector<EmuBlock> blks(cl);
    std::deque<EmuBarrier> bars;
    EmuBarrier all(cl * n);
    EmuCluster cluster{&all, cl, smem, {}};
    for (unsigned r = 0; r < cl; ++r) {
      cluster.smem[r] = mem[r].data();
      blks[r].block = &bars.emplace_back(n);
      for (unsigned w = 0; w < (n + 31) / 32; ++w)
        blks[r].warps[w] = &bars.emplace_back(std::min(32u, n - 32 * w));
    }
    std::vector<EmuFiber> fibers(cl * n);
    for (unsigned r = 0; r < cl; ++r)
      for (unsigned tx = 0; tx < n; ++tx) {
        EmuFiber& f = fibers[r * n + tx];
        f.tid = {tx, 0, 0};
        f.bid = {c0 + r, 0, 0};
        f.blk = &blks[r];
        f.cluster = &cluster;
        f.rank = r;
        f.smem = mem[r].data();
        f.body = [&] { k(args...); };
      }
    emu_run(fibers);
  }
}

struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  int id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*k)(P...), A&&... args) {
  unsigned cl = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& d = cfg->attrs[i].val.clusterDim;
      if (d.y != 1 || d.z != 1) return cudaErrorInvalidConfiguration;
      cl = d.x;
    }
  emu_launch_cluster(k, cfg->gridDim, cfg->blockDim.x,
                     cfg->dynamicSmemBytes, cl, P(args)...);
  return cudaSuccess;
}

template <typename F>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, F,
                                                  const cudaLaunchConfig_t*) {
  *n = 16;
  return cudaSuccess;
}
