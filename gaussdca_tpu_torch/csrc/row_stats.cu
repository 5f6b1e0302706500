// Kernel A: all-pairs sequence-identity row statistics.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_sym_pallas. For a token
// matrix Z [M, N] (token 0 = padding that matches nothing, itself
// included; states 1..q count, tokens above q match nothing) and a
// threshold t, computes for every row a
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : N - matches(a, b) < t}
//
// over all b in [0, M), b = a included, where matches(a, b) counts the
// columns k with Z[a, k] == Z[b, k] in 1..q.
//
// Bound. At M = 32768, N = 384, q = 21 the half grid of the TPU kernel's
// one-hot products is 8.66e12 int8 operations: 4.38 ms at the dense int8
// tensor-core rate (1,979 TOP/s). A packed compare (one popcount per four
// columns) cannot go below the popcount pipe's 12.3 ms for the same
// pairs, so this kernel counts on the
// int8 tensor cores, as the TPU kernel does on its matrix unit.
//
// Design. The int8 product over (32-column chunk, state) of one-hot
// operands built on chip from the packed token words, one
// wgmma.mma_async m64n128k32 a warpgroup and state: onehot_wgmma.cuh
// (count_tile), which kernels C and D share. A block owns one 128 x 128
// tile (ti <= tj) of the M x M count matrix: the upper triangle of tiles on
// a flat 1-D grid (gridDim.y would cap M).
//
// What bounds it now: per block and state, 128 clocks of tensor-core work
// against the byte compares, the proxy fence and the barrier. ptxas: 107
// registers, 10,240 bytes of shared memory, so two blocks share an SM and
// one's expansion overlaps the other's wgmma. Measured slower on an H100:
// mma.sync m16n8k32 with both fragments expanded into shared memory (~2
// wavefronts a mma.sync), wgmma with one block an SM (149 registers), and
// expanding two to four states a barrier.
//
// The epilogue turns the count tile into row and column partials of rowsum
// and below (strict <, f32 threshold): warp shuffles, then shared-memory
// atomics, then 64-bit global atomics; a diagonal tile counts toward its
// rows only. Exact, and the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

using onehot::BM;
using onehot::CW;
using onehot::MATCH_SHIFT;
using onehot::THREADS;

__global__ void __launch_bounds__(THREADS)
row_stats_kernel(const uint32_t* __restrict__ Z, int M, int W, int n_true,
                 float thresh, int q, unsigned long long* __restrict__ rowsum,
                 unsigned long long* __restrict__ below) {
  __shared__ unsigned int red[4][BM];    // row sum, row below, col sum, col below

  long long ti, tj;
  onehot::triangle_tile(blockIdx.x, ti, tj);
  const int a0 = (int)(ti * BM);
  const int b0 = (int)(tj * BM);
  const bool diag = (ti == tj);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q4 = lane & 3;   // fragment group / thread in it
  for (int i = threadIdx.x; i < 4 * BM; i += THREADS) red[i / BM][i % BM] = 0u;

  int d[64];
  onehot::count_tile(Z, M, a0, Z, M, b0, W, q, d);
  const int ra = a0 + 16 * warp + g;

  // epilogue: d[4 j + e] is row 16 warp + g + 8 (e / 2), column 8 j +
  // 2 q4 + (e % 2) of the tile; one 8-column block at a time, so that
  // only its partials are live
  unsigned int rs[2] = {0u, 0u}, rbl[2] = {0u, 0u};
  const bool row_ok[2] = {ra < M, ra + 8 < M};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lc = 8 * j + 2 * q4 + e;
      const bool col_ok = b0 + lc < M;
      unsigned int s = 0u, b = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row_ok[h] && col_ok) {
          const int m = d[4 * j + 2 * h + e] >> MATCH_SHIFT;
          const unsigned int nbl = ((float)(n_true - m) < thresh) ? 1u : 0u;
          rs[h] += (unsigned int)m;
          rbl[h] += nbl;
          s += (unsigned int)m;
          b += nbl;
        }
      }
      if (!diag) {
        // the eight groups of a warp hold the same columns
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
          b += __shfl_xor_sync(0xFFFFFFFFu, b, off);
        }
        if (g == 0) {
          atomicAdd(&red[2][lc], s);
          atomicAdd(&red[3][lc], b);
        }
      }
    }
  }
  // the four lanes of a group hold the same rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned int s = rs[h], b = rbl[h];
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
    b += __shfl_xor_sync(0xFFFFFFFFu, b, 1);
    b += __shfl_xor_sync(0xFFFFFFFFu, b, 2);
    if (q4 == 0) {
      atomicAdd(&red[0][16 * warp + g + 8 * h], s);
      atomicAdd(&red[1][16 * warp + g + 8 * h], b);
    }
  }
  __syncthreads();

  if (threadIdx.x < BM) {
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

// Z: [M, W] 32-bit words, row-major, 4 tokens per word (each token 0..q,
// tokens above q zeroed by the caller), W a multiple of 8 (zero-padded
// columns never match), 16-byte aligned rows; n_true: the unpadded token
// count N, below 2^17; q: the states 1..q that count, 1 <= q <= 127.
// rowsum, below: [M] 64-bit accumulators, zeroed by the caller. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int gdca_row_stats(const void* Z, int M, int W, int n_true,
                              float thresh, int q, void* rowsum, void* below,
                              void* stream) {
  if (M <= 0) return cudaSuccess;
  if (W <= 0 || W % CW != 0 || n_true >= (1 << (31 - MATCH_SHIFT)) ||
      q < 1 || q > 127)
    return cudaErrorInvalidValue;
  const long long T = (M + BM - 1) / BM;
  const long long tiles = T * (T + 1) / 2;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  row_stats_kernel<<<(unsigned int)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(Z), M, W, n_true, thresh, q,
      static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
