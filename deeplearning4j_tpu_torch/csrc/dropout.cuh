// The attention-dropout keep mask of the flash kernels (flash_fwd.cu,
// flash_bwd.cu): the counter hash of the JAX package's Pallas kernels,
// deeplearning4j_tpu/ops/flash_attention.py `_fmix32` and `_keep_mask`,
// bit for bit. Score element (bh, gq, gk), with bh = b*H + h and gq, gk
// the GLOBAL query and key positions (the call's window origin plus the
// row or column), is kept where
//
//   key = fmix32(seed + bh * 0x9E3779B9)
//   h   = key + gq * hash_t + gk
//   h  *= 0xCC9E2D51;  h ^= h >> 15;  h *= 0x1B873593;  h ^= h >> 13
//   keep = h < thr,    thr = min(floor((1 - rate) * 2^32), 2^32 - 1)
//
// all in wrapping u32 arithmetic; a kept element is scaled by
// 1 / (1 - rate) rounded to f32. Keying on global coordinates makes the
// mask the same whatever the tiling: every kernel of the forward and the
// backward, and every tile of the chunked tier, regenerates it from the
// seed alone. The seed is read from device memory, so a launch needs no
// host sync.
//
// A thread folds everything but its element's offset into one base per
// row: the per-element cost is an add, the two multiplies and
// xor-shifts of the tail and a compare.

#pragma once

#include <stdint.h>

namespace drop {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// the key of one (b*h) slice
__device__ __forceinline__ uint32_t slice_key(const int* seed, uint32_t bh) {
  return fmix32((uint32_t)*seed + bh * 0x9E3779B9u);
}

// whether the element whose linear coordinate key + gq*hash_t + gk is h
// is kept
__device__ __forceinline__ bool keep(uint32_t h, uint32_t thr) {
  h *= 0xCC9E2D51u;
  h ^= h >> 15;
  h *= 0x1B873593u;
  h ^= h >> 13;
  return h < thr;
}

}  // namespace drop
