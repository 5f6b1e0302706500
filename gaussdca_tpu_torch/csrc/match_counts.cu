// Kernel D: the dense all-pairs identity-count matrix.
//
// Replaces gaussdca_tpu/ops/distance.py::match_counts_pallas. For a token
// matrix Z [M, N] (states 0..31, token 0 = padding that matches nothing,
// itself included) it writes the int32 matrix
//
//   out[a, b] = matches(a, b) = #{k : Z[a, k] == Z[b, k] != 0}
//
// for every ordered pair (a, b), a = b included: the input of the dense
// reweighting path (stats/reweight.py::compute_weights).
//
// Design. Kernel A's packed compare (packed_match.cuh: 4 tokens per 32-bit
// word, bytewise equality, one popcount per word) over the full M x M grid
// of 64 x 64 tiles on a flat 1-D grid (tile t -> row tile t % T, column
// tile t / T); each block writes its count tile instead of reducing it.
// Thread (ty, tx) stores rows a0 + ty + 16 i, columns b0 + tx + 16 j, so a
// half-warp writes 64 consecutive bytes of one row. M^2 outgrows 32-bit
// offsets at M > 46,340: every output offset is 64-bit.
//
// Bound. The work is M^2 N / 4 popcounts on O(M N) input bytes, and the
// output is 4 M^2 bytes. At M = 32768, N = 384, q = 21: counted as the JAX
// kernel counts it (2 M^2 N q = 1.73e13 int8 operations at 1,979e12/s) the
// bound is 8.75 ms; the 4.3 GB output takes 1.3 ms at 3.35 TB/s; on the
// popcount pipe (16 a clock on each of 132 SMs at 1.98 GHz) the full grid
// takes 24.7 ms. This kernel runs on the popcount pipe and computes both
// halves of the symmetric matrix: halving the grid and writing each tile
// twice, or counting on the int8 tensor cores, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_match.cuh"

namespace {

using gdca::KW;
using gdca::THREADS;
using gdca::TILE;

__global__ void __launch_bounds__(THREADS)
match_counts_kernel(const uint32_t* __restrict__ Z, int M, int W,
                    long long T, int* __restrict__ out) {
  __shared__ uint32_t sa[TILE][KW + 1];   // +1: conflict-free column reads
  __shared__ uint32_t sb[TILE][KW + 1];

  const long long t = blockIdx.x;
  const int a0 = (int)((t % T) * TILE);
  const int b0 = (int)((t / T) * TILE);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  uint32_t cnt[4][4];
  gdca::tile_matches(Z, M, a0, Z, M, b0, W, sa, sb, cnt);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
    if (a >= M) continue;
    int* row = out + (size_t)a * (size_t)M;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      if (b < M) row[b] = (int)cnt[i][j];
    }
  }
}

}  // namespace

// Z: [M, W] 32-bit words, row-major, 4 tokens per word, W a multiple of
// 16 (zero-padded columns never match). out: [M, M] int32, every element
// written. Launches on `stream` and returns cudaGetLastError().
extern "C" int gdca_match_counts(const void* Z, int M, int W, void* out,
                                 void* stream) {
  if (M <= 0) return cudaSuccess;
  if (W <= 0 || W % KW != 0) return cudaErrorInvalidValue;
  const long long T = (M + TILE - 1) / TILE;
  if (T * T > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  match_counts_kernel<<<(unsigned int)(T * T), THREADS, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(Z), M, W, T, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
