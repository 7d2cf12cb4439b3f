// CPU emulation of the part of the CUDA runtime that the port's kernels
// use (see emulate.py): each CUDA thread is a host thread, the blocks of
// a grid run one after another, and a warp's collective operations
// (shuffles, ldmatrix, mma.sync) meet at a barrier of its 32 threads.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <stdexcept>
#include <thread>
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

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMultiProcessorCount = 16
};
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
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

// the rendezvous of one block: a barrier of all its threads, one of each
// warp, and exchange slots (16 words a lane)
struct EmuBlock {
  std::barrier<>* block;
  std::barrier<>* warps[32];
  uint64_t slots[32][32][16];
};
extern EmuBlock* g_blk;
// fills the kernel's shared memory with NaN before each block
extern void (*emu_poison)();

inline void __syncthreads() { g_blk->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_blk->warps[threadIdx.x >> 5]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  uint32_t u;
  std::memcpy(&u, &v, 4);
  g_blk->slots[w][l][0] = u;
  __syncwarp();
  const uint32_t r = (uint32_t)g_blk->slots[w][l ^ mask][0];
  __syncwarp();
  float f;
  std::memcpy(&f, &r, 4);
  return f;
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
    std::barrier<> bb(n);
    std::vector<std::barrier<>*> wb;
    for (unsigned w = 0; w < (n + 31) / 32; ++w)
      wb.push_back(new std::barrier<>(std::min(32u, n - 32 * w)));
    blk.block = &bb;
    for (unsigned w = 0; w < wb.size(); ++w) blk.warps[w] = wb[w];
    g_blk = &blk;
    emu_poison();
    std::vector<std::thread> th;
    for (unsigned tx = 0; tx < n; ++tx)
      th.emplace_back([&, tx, bx, by, bz] {
        threadIdx = {tx, 0, 0};
        blockIdx = {bx, by, bz};
        k(args...);
      });
    for (auto& t : th) t.join();
    for (auto* p : wb) delete p;
  }
}
