// Kernel A: all-pairs sequence-identity row statistics.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_sym_pallas. For a token
// matrix Z [M, N] (states 0..31, token 0 = padding that matches nothing,
// itself included) and a threshold t, computes for every row a
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : N - matches(a, b) < t}
//
// over all b in [0, M), b = a included, where matches(a, b) counts the
// columns k with Z[a, k] == Z[b, k] != 0.
//
// Design. The TPU kernel expands one-hot planes and counts on the matrix
// unit; here tokens are packed 4 to a 32-bit word and compared bytewise
// (the reference's XOR/popcount idea): per word, one XOR, a carry-free
// byte-zero test, a mask of a's non-zero bytes and one popcount give the
// matches of four columns (packed_match.cuh, shared with the rectangular
// kernel row_stats_rect.cu). The work is O(M^2 N / 4) integer operations on
// O(M N) bytes, so the kernel is bound by integer throughput (popcount is
// the narrowest pipe), not by memory: each block stages two 64-row token
// tiles in shared memory, 16 words at a time, and each of its 256 threads
// keeps a 4 x 4 block of pair counts in registers. Only tiles (i <= j) of
// the M x M pair matrix run, on a flat 1-D grid (gridDim.y would cap M);
// an off-diagonal tile credits both its rows and its columns, a diagonal
// tile only its rows. Blocks run in no order, so per-row sums go to 64-bit
// integer accumulators by atomicAdd: exact, and the same on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_match.cuh"

namespace {

using gdca::KW;
using gdca::THREADS;
using gdca::TILE;

__global__ void __launch_bounds__(THREADS)
row_stats_kernel(const uint32_t* __restrict__ Z, int M, int W, int n_true,
                 float thresh, unsigned long long* __restrict__ rowsum,
                 unsigned long long* __restrict__ below) {
  __shared__ uint32_t sa[TILE][KW + 1];   // +1: conflict-free column reads
  __shared__ uint32_t sb[TILE][KW + 1];
  __shared__ unsigned int red[4][TILE];   // row sum, row below, col sum, col below

  // tile t of the upper triangle, column-major: t = tj (tj + 1) / 2 + ti
  const long long t = blockIdx.x;
  long long tj = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  while (tj * (tj + 1) / 2 > t) --tj;
  const long long ti = t - tj * (tj + 1) / 2;
  const int a0 = (int)(ti * TILE);
  const int b0 = (int)(tj * TILE);
  const bool diag = (ti == tj);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int i = threadIdx.x; i < 4 * TILE; i += THREADS) red[i / TILE][i % TILE] = 0;

  uint32_t cnt[4][4];
  gdca::tile_matches(Z, M, a0, Z, M, b0, W, sa, sb, cnt);

  unsigned int rs_row[4] = {0, 0, 0, 0}, bl_row[4] = {0, 0, 0, 0};
  unsigned int rs_col[4] = {0, 0, 0, 0}, bl_col[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + ty + 16 * i, b = b0 + tx + 16 * j;
      if (a < M && b < M) {
        const unsigned int m = cnt[i][j];
        const unsigned int nb = ((float)(n_true - (int)m) < thresh) ? 1u : 0u;
        rs_row[i] += m;
        bl_row[i] += nb;
        rs_col[j] += m;
        bl_col[j] += nb;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    atomicAdd(&red[0][ty + 16 * i], rs_row[i]);
    atomicAdd(&red[1][ty + 16 * i], bl_row[i]);
  }
  if (!diag) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      atomicAdd(&red[2][tx + 16 * j], rs_col[j]);
      atomicAdd(&red[3][tx + 16 * j], bl_col[j]);
    }
  }
  __syncthreads();

  if (threadIdx.x < TILE) {
    const int r = threadIdx.x;
    if (a0 + r < M) {
      atomicAdd(&rowsum[a0 + r], (unsigned long long)red[0][r]);
      atomicAdd(&below[a0 + r], (unsigned long long)red[1][r]);
    }
    if (!diag && b0 + r < M) {
      atomicAdd(&rowsum[b0 + r], (unsigned long long)red[2][r]);
      atomicAdd(&below[b0 + r], (unsigned long long)red[3][r]);
    }
  }
}

}  // namespace

// Z: [M, W] 32-bit words, row-major, 4 tokens per word, W a multiple of
// 16 (zero-padded columns never match); n_true: the unpadded token count
// N. rowsum, below: [M] 64-bit accumulators, zeroed by the caller.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gdca_row_stats(const void* Z, int M, int W, int n_true,
                              float thresh, void* rowsum, void* below,
                              void* stream) {
  if (M <= 0) return cudaSuccess;
  if (W <= 0 || W % KW != 0) return cudaErrorInvalidValue;
  const long long T = (M + TILE - 1) / TILE;
  const long long tiles = T * (T + 1) / 2;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  row_stats_kernel<<<(unsigned int)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(Z), M, W, n_true, thresh,
      static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
