// CPU emulation of the thread-block cluster of cooperative_groups (see
// cuda_runtime.h's emu_launch_cluster): sync() is a barrier of every
// thread of the cluster, and map_shared_rank turns an address in the
// calling block's dynamic shared memory into the same offset in block
// `rank`'s.
#pragma once
#include <stdexcept>
#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { g_cluster->all->arrive_and_wait(); }
  unsigned block_rank() const { return g_rank; }
  unsigned num_blocks() const { return g_cluster->blocks; }
  template <typename T>
  T* map_shared_rank(T* addr, unsigned rank) const {
    const auto off = reinterpret_cast<const unsigned char*>(addr) - g_smem;
    if (rank >= g_cluster->blocks || off < 0 ||
        (size_t)off >= g_cluster->bytes)
      throw std::runtime_error("map_shared_rank outside shared memory");
    return reinterpret_cast<T*>(g_cluster->smem[rank] + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
