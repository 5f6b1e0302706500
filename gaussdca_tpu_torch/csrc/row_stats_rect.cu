// Kernel C: rectangular sequence-identity row statistics.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_rect_pallas (and, with
// A = B, row_stats_pallas). For token matrices A [Ma, N] and B [Mb, N]
// (states 0..31, token 0 = padding that matches nothing, itself included)
// and a threshold t, computes for every row a of A
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : n_true - matches(a, b) < t}
//
// over every row b of B, where matches(a, b) counts the columns k with
// A[a, k] == B[b, k] != 0. It is the per-shard reweighting kernel of the
// mesh path: shard d passes its row block as A and all rows as B.
//
// Design. The same packed compare as kernel A (packed_match.cuh: 4 tokens
// per 32-bit word, bytewise equality, one popcount per word), over the
// full Ma x Mb grid of 64 x 64 tiles: A != B in general, so there is no
// symmetry to halve it. The grid is flat and 1-D (tile t -> A tile t % Ta,
// B tile t / Ta), so Mb up to ~4e6 rows fits. Per-row sums go through
// shared memory, then to 64-bit integer accumulators by atomicAdd: exact,
// and the same on every run.
//
// Bound. Per tile pair, 64 x 64 x W words cost one popcount each; the
// data is O((Ma + Mb) N) bytes, read from L2 many times over, so the
// kernel is bound by integer throughput, not by memory. At one shard of
// the main path (Ma = 8192, Mb = 32768, N = 384, q = 21): counted as the
// JAX kernel counts it (2 Ma Mb N q = 4.3e12 int8 operations on the
// tensor cores at 1,979e12/s) the bound is 2.2 ms; counted in popcounts
// (Ma Mb N / 4 = 2.6e10 words, 16 a clock on each of 132 SMs at 1.98 GHz)
// it is 6.2 ms. The tensor-core reckoning is the lesser; this kernel runs
// on the popcount pipe. Making it fast (int8 mma over one-hot planes,
// more pairs a thread) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_match.cuh"

namespace {

using gdca::KW;
using gdca::THREADS;
using gdca::TILE;

__global__ void __launch_bounds__(THREADS)
row_stats_rect_kernel(const uint32_t* __restrict__ A, int Ma,
                      const uint32_t* __restrict__ B, int Mb, int W,
                      long long Ta, int n_true, float thresh,
                      unsigned long long* __restrict__ rowsum,
                      unsigned long long* __restrict__ below) {
  __shared__ uint32_t sa[TILE][KW + 1];   // +1: conflict-free column reads
  __shared__ uint32_t sb[TILE][KW + 1];
  __shared__ unsigned int red[2][TILE];   // row sum, row below

  const long long t = blockIdx.x;
  const int a0 = (int)((t % Ta) * TILE);
  const int b0 = (int)((t / Ta) * TILE);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int i = threadIdx.x; i < 2 * TILE; i += THREADS)
    red[i / TILE][i % TILE] = 0;

  uint32_t cnt[4][4];
  gdca::tile_matches(A, Ma, a0, B, Mb, b0, W, sa, sb, cnt);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned int rs = 0, bl = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (b0 + tx + 16 * j < Mb) {
        const unsigned int m = cnt[i][j];
        rs += m;
        bl += ((float)(n_true - (int)m) < thresh) ? 1u : 0u;
      }
    }
    atomicAdd(&red[0][ty + 16 * i], rs);
    atomicAdd(&red[1][ty + 16 * i], bl);
  }
  __syncthreads();

  if (threadIdx.x < TILE && a0 + (int)threadIdx.x < Ma) {
    const int r = threadIdx.x;
    atomicAdd(&rowsum[a0 + r], (unsigned long long)red[0][r]);
    atomicAdd(&below[a0 + r], (unsigned long long)red[1][r]);
  }
}

}  // namespace

// A: [Ma, W], B: [Mb, W] 32-bit words, row-major, 4 tokens per word, W a
// multiple of 16 (zero-padded columns never match); n_true: the token
// count N the hamming distance is taken over. rowsum, below: [Ma] 64-bit
// accumulators, zeroed by the caller. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gdca_row_stats_rect(const void* A, int Ma, const void* B,
                                   int Mb, int W, int n_true, float thresh,
                                   void* rowsum, void* below, void* stream) {
  if (Ma <= 0 || Mb <= 0) return cudaSuccess;
  if (W <= 0 || W % KW != 0) return cudaErrorInvalidValue;
  const long long Ta = (Ma + TILE - 1) / TILE;
  const long long Tb = (Mb + TILE - 1) / TILE;
  if (Ta * Tb > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  row_stats_rect_kernel<<<(unsigned int)(Ta * Tb), THREADS, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(A), Ma, static_cast<const uint32_t*>(B),
      Mb, W, Ta, n_true, thresh, static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
