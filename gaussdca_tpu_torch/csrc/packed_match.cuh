// Packed-token byte tests of kernel E (row_stats_asym.cu).
//
// Tokens (states 0..31, token 0 = padding that matches nothing, itself
// included) are packed 4 to a 32-bit word. Per word, one XOR, a
// carry-free byte-zero test, a mask of a's non-zero bytes and one
// popcount give the matches of four columns. A block of THREADS threads
// counts 64 x 64 tiles of row pairs, thread (ty, tx) = (threadIdx.x / 16,
// threadIdx.x % 16) keeping the 4 x 4 counts of rows ty + 16 i against
// rows tx + 16 j in registers. (Kernels A, C and D count on the int8
// tensor cores instead: onehot_wgmma.cuh.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gdca {

constexpr int TILE = 64;       // rows per tile side
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 pairs each

// high bit of each byte set iff that byte of x is non-zero (no carry
// crosses a byte: (x & 0x7F) + 0x7F <= 0xFE)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// high bit of each byte set iff x and y agree in that byte
__device__ __forceinline__ uint32_t equal_bytes(uint32_t x, uint32_t y) {
  return ~nonzero_bytes(x ^ y) & 0x80808080u;
}

}  // namespace gdca
