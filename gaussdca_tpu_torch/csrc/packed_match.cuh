// Packed-token match counting shared by the row-statistics kernels
// (row_stats.cu, row_stats_rect.cu).
//
// Tokens (states 0..31, token 0 = padding that matches nothing, itself
// included) are packed 4 to a 32-bit word. Per word, one XOR, a
// carry-free byte-zero test, a mask of a's non-zero bytes and one
// popcount give the matches of four columns. A block of THREADS threads
// counts the matches of a 64 x 64 tile of row pairs: it stages both
// 64-row token tiles in shared memory, KW words at a time, and thread
// (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16) keeps the 4 x 4 counts
// of rows a0 + ty + 16 i against rows b0 + tx + 16 j in registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gdca {

constexpr int TILE = 64;       // rows per tile side
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 pairs each
constexpr int KW = 16;         // words (4 tokens each) staged per step

// high bit of each byte set iff that byte of x is non-zero (no carry
// crosses a byte: (x & 0x7F) + 0x7F <= 0xFE)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// high bit of each byte set iff x and y agree in that byte
__device__ __forceinline__ uint32_t equal_bytes(uint32_t x, uint32_t y) {
  return ~nonzero_bytes(x ^ y) & 0x80808080u;
}

// cnt[i][j] = matches(A row a0 + ty + 16 i, B row b0 + tx + 16 j); rows
// past Ma / Mb read as token 0. A, B: row-major words, W of them a row
// (a multiple of KW). Every thread of the block must call it: it
// synchronizes the block.
__device__ __forceinline__ void tile_matches(
    const uint32_t* __restrict__ A, int Ma, int a0,
    const uint32_t* __restrict__ B, int Mb, int b0, int W,
    uint32_t (*sa)[KW + 1], uint32_t (*sb)[KW + 1], uint32_t cnt[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cnt[i][j] = 0;

  for (int k0 = 0; k0 < W; k0 += KW) {
    for (int i = threadIdx.x; i < TILE * KW; i += THREADS) {
      const int r = i / KW, w = i % KW;
      const int ga = a0 + r, gb = b0 + r;
      sa[r][w] = (ga < Ma) ? A[(size_t)ga * W + k0 + w] : 0u;
      sb[r][w] = (gb < Mb) ? B[(size_t)gb * W + k0 + w] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < KW; ++w) {
      uint32_t av[4], an[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sa[ty + 16 * i][w];
        an[i] = nonzero_bytes(av[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cnt[i][j] += __popc(equal_bytes(av[i], bv[j]) & an[i]);
    }
    __syncthreads();
  }
}

}  // namespace gdca
