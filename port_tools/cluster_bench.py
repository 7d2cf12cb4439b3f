#!/usr/bin/env python3
"""Microbenchmark of what a reduction across a thread-block cluster costs
on the card: the cluster barrier, __syncthreads, one dependent load from
another block's shared memory, 32 loads from other blocks' (a pull), 32
from the block's own, and 8 stores into other blocks' followed by the
barrier (a push). K12 (csrc/sampling.cu) is designed on these numbers.

    python3 port_tools/cluster_bench.py

Builds the kernel below with nvcc into the git-ignored
deeplearning4j_tpu_torch/_build/, runs each case 1000 times in blocks of
128 threads, in clusters of 1, 2, 4 and 8 blocks and 4 and 32 clusters,
and prints the mean SM clock cycles an iteration (clock64, block 0's
thread 0 of each block averaged), beside the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void bench(long long* out, int iters, int mode) {
  __shared__ unsigned buf[2][4096];
  cg::cluster_group cl = cg::this_cluster();
  const int r = cl.block_rank(), n = cl.num_blocks();
  for (int i = threadIdx.x; i < 2 * 4096; i += blockDim.x)
    (&buf[0][0])[i] = i;
  cl.sync();
  unsigned acc = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      cl.sync();
    } else if (mode == 1) {
      __syncthreads();
    } else if (mode == 2) {  // one dependent load from the next block
      const unsigned* p = cl.map_shared_rank(&buf[0][0], (r + 1) % n);
      acc = p[(acc + threadIdx.x) & 1023];
    } else if (mode == 3 || mode == 4) {  // 32 loads, then their sum
      unsigned g[32];
#pragma unroll
      for (int w = 0; w < 32; ++w) {
        const unsigned* p = mode == 3
            ? cl.map_shared_rank(&buf[it & 1][0], (w / 4) % n)
            : &buf[it & 1][0];
        g[w] = p[(w * 32 + (threadIdx.x & 31) + acc) & 4095];
      }
#pragma unroll
      for (int w = 0; w < 32; ++w) acc += g[w];
    } else {  // 8 stores into the cluster's blocks, then the barrier
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (d < n)
          cl.map_shared_rank(&buf[it & 1][0], d)[(r * 128 + threadIdx.x) &
                                                 4095] = acc + it;
      cl.sync();
    }
  }
  const long long t1 = clock64();
  cl.sync();
  if (threadIdx.x == 0) {
    out[blockIdx.x * 2] = t1 - t0;
    out[blockIdx.x * 2 + 1] = acc;
  }
}
extern "C" int run(long long* out, int cluster, int iters, int mode,
                   int blocks) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(128);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = cluster;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, bench, out, iters, mode);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
"""

CASES = ("cluster.sync", "__syncthreads", "dependent remote load",
         "32 remote loads + sum", "32 local loads + sum",
         "8 remote stores + cluster.sync")


def main() -> int:
    import torch

    from deeplearning4j_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("cluster_bench: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "cluster_bench.cu"
    lib = cuda_build.BUILD_DIR / "libcluster_bench.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_build.nvcc(), *cuda_build.ARCH_FLAGS, "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    run = ctypes.CDLL(str(lib)).run
    run.restype = ctypes.c_int
    run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = torch.zeros(2 * 256, dtype=torch.int64, device="cuda")
    iters = 1000
    for cluster in (1, 2, 4, 8):
        for mode, name in enumerate(CASES):
            if mode == 2 and cluster == 1:
                continue
            for clusters in (4, 32):
                blocks = cluster * clusters
                rc = run(out.data_ptr(), cluster, iters, mode, blocks)
                if rc:
                    print(f"cluster_bench: launch failed ({rc})")
                    return 1
                cycles = float(out.view(-1, 2)[:blocks, 0].double().mean())
                print(f"cluster {cluster} x {clusters} clusters, {name}: "
                      f"{cycles / iters:.1f} cycles an iteration ({card})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
