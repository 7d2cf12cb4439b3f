// Tensor-core building blocks shared by the bf16 kernels of
// flash_fwd.cu, flash_bwd.cu and softmax_xent.cu (sm_80 instructions,
// which sm_90a runs): cp.async copies into shared memory, ldmatrix
// fragment loads and the mma.sync m16n8k16 bf16 x bf16 -> f32 product.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same cols),
//            a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, same cols);
//   B 16x8:  b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8, 2t+9, col g);
//   C 16x8:  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same).
// So the C fragments of two neighbouring 8-column blocks are, packed to
// bf16 pairs, the A fragment of one 16-deep block: a tile computed by
// one product feeds the next from registers.
//
// Tiles in shared memory are row-major with rows of a multiple of 64
// bf16 (8 chunks of 16 bytes) and the chunk index XOR-ed with the row
// (`swz`): the eight row addresses of one ldmatrix matrix then fall in
// eight different bank groups, with no padding. A row of 32 bf16 has 4
// chunks and rows r and r + 1 share one 128-byte bank line, so there
// the chunk is XOR-ed with row / 2 within its 4: still a bijection
// within the row, and eight consecutive rows again hit eight groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, col) in a swizzled tile of `width` bf16 a row
// (width a multiple of 64, or 32)
__device__ __forceinline__ int swz(int row, int col, int width) {
  if (width == 32)
    return row * 32 + (((col >> 3) ^ (row >> 1)) & 3) * 8 + (col & 7);
  return row * width + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8 +
         (col & 7);
}

// Copy BYTES (16, 8 or 4) from global to shared memory without blocking;
// with `pred` false the destination is zero-filled and nothing is read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lane l gives the address of row (l % 8) of
// matrix (l / 8)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a @ b on one 16x8x16 tile, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded (to nearest even) to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 16-row block from the C fragments c[2k], c[2k+1]
// of its 8-column blocks (k = 0 .. KB-1), rounded to bf16.
template <int KB>
__device__ __forceinline__ void c_to_a(const float (&c)[2 * KB][4],
                                       uint32_t (&a)[KB][4]) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    a[k][0] = pack_bf16(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack_bf16(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack_bf16(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack_bf16(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// Addresses of one lane for the x4 loads of a 16x16 block at (r0, c0)
// of a swizzled tile:
//   a_rowmajor: the A fragment of a row-major [m][k] tile (non-trans);
//   b_nk: the B fragments of two 8-column blocks, n0 and n0 + 8, of a
//         tile stored [n][k] (non-trans; r0 = n0, c0 = k0);
//   b_kn: the same from a tile stored [k][n] (trans; r0 = k0, c0 = n0);
//   a_km: the A fragment of a tile stored [k][m] (trans; r0 = k0,
//         c0 = m0).
__device__ __forceinline__ int a_rowmajor(int r0, int c0, int width,
                                          int lane) {
  return swz(r0 + (lane & 15), c0 + (lane >> 4) * 8, width);
}
__device__ __forceinline__ int b_nk(int r0, int c0, int width, int lane) {
  return swz(r0 + (lane >> 4) * 8 + (lane & 7), c0 + ((lane >> 3) & 1) * 8,
             width);
}
__device__ __forceinline__ int b_kn(int r0, int c0, int width, int lane) {
  return swz(r0 + ((lane >> 3) & 1) * 8 + (lane & 7), c0 + (lane >> 4) * 8,
             width);
}
__device__ __forceinline__ int a_km(int r0, int c0, int width, int lane) {
  return swz(r0 + (lane >> 4) * 8 + (lane & 7), c0 + ((lane >> 3) & 1) * 8,
             width);
}

}  // namespace tc
