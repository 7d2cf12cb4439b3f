#!/usr/bin/env python3
"""Microbenchmark of the two ways K11 (csrc/layernorm.cu) can sum its
per-block dgamma/dbeta partials on the card, each against blocks that
only write their partials:

  (a) a second kernel on the same stream: `lnv::colsum`, the one K11
      launches (this script includes csrc/layernorm.cu);
  (b) the last block to finish sums them: every block writes its
      partial, fences, and counts itself on a global counter; the block
      that finds the count complete reads all partials in block order and
      resets the counter.

    python3 port_tools/ln_reduce_bench.py

Builds the source below with nvcc into the git-ignored
deeplearning4j_tpu_torch/_build/, runs each way at the partials the
backward's vector kernel writes (264 blocks, 2 x C columns, C = 256 and
512) and at 132 blocks, checks both sums against torch's, and prints the
device time a call (torch.profiler, summed over the call's kernels) and
the CUDA-event time of back-to-back calls, with each way's tail over the
write-only blocks, beside the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "layernorm.cu"

namespace {

__device__ __forceinline__ void write_partial(float* part, int C2) {
  for (int j = threadIdx.x; j < C2; j += NTHREADS)
    part[(size_t)blockIdx.x * C2 + j] =
        (float)((blockIdx.x * 131 + j) % 97) * 0.01f;
}

__global__ void __launch_bounds__(NTHREADS) write_only(float* part, int C2) {
  write_partial(part, C2);
}

__global__ void __launch_bounds__(NTHREADS)
    write_last(float* part, float* out, unsigned* counter, int C2) {
  __shared__ int last;
  write_partial(part, C2);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < C2; j += NTHREADS) {
    float t = 0.f;
#pragma unroll 8
    for (int p = 0; p < (int)gridDim.x; ++p)
      t += __ldcg(part + (size_t)p * C2 + j);
    out[j] = t;
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace

// way 0: the partials only; 1: (a); 2: (b)
extern "C" int reduce_way(int way, float* part, float* out,
                          unsigned* counter, int blocks, int C,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (way == 2) {
    write_last<<<blocks, NTHREADS, 0, s>>>(part, out, counter, 2 * C);
    return (int)cudaGetLastError();
  }
  write_only<<<blocks, NTHREADS, 0, s>>>(part, 2 * C);
  const int err = (int)cudaGetLastError();
  if (err != 0 || way == 0) return err;
  return lnv::launch_colsum(part, out, blocks, C, s);
}
"""

WAYS = ("partials only", "(a) colsum kernel", "(b) last block")


def main() -> int:
    import torch

    import chip_smoke
    from deeplearning4j_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("ln_reduce_bench: no CUDA device", file=sys.stderr)
        return 2
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "ln_reduce_bench.cu"
    lib = cuda_build.BUILD_DIR / "libln_reduce_bench.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_build.nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC",
                    f"-I{cuda_build.SRC_DIR}", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).reduce_way
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    card = chip_smoke.nvidia_smi("name,power.limit")
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    failed = 0
    for blocks, C in ((264, 256), (264, 512), (132, 256)):
        part = torch.empty((blocks, 2 * C), device="cuda")
        out = torch.full((2 * C,), float("nan"), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(way):
            rc = fn(way, part.data_ptr(), out.data_ptr(),
                    counter.data_ptr(), blocks, C, stream)
            if rc:
                raise RuntimeError(f"launch failed ({rc})")

        times = []
        for way, name in enumerate(WAYS):
            out.fill_(float("nan"))
            call(way)
            torch.cuda.synchronize()
            if way:
                err = float((out - part.sum(0)).abs().max()
                            / part.sum(0).abs().max())
                ok = err <= 1e-5
                failed += not ok
            dev = chip_smoke.kernel_device_ms(torch, lambda: call(way),
                                              calls=50)
            ev = chip_smoke.time_ms(torch, lambda: call(way))
            times.append(dev)
            tail = (f", tail over the partials {dev - times[0]:.5f} ms"
                    if way and dev is not None and times[0] is not None
                    else "")
            check = (f", sum rel err {err:.2e} {'ok' if ok else 'FAIL'}"
                     if way else "")
            print(f"{blocks} partials of 2 x {C}: {name}: device "
                  f"{chip_smoke.fmt_ms(dev)} a call, event {ev:.5f} ms"
                  f"{tail}{check} ({card})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
