// Kernel C: rectangular sequence-identity row statistics.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_rect_pallas (and, with
// A = B, row_stats_pallas). For token matrices A [Ma, N] and B [Mb, N]
// (token 0 = padding that matches nothing, itself included; states 1..q
// count, tokens above q match nothing) and a threshold t, computes for
// every row a of A
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : n_true - matches(a, b) < t}
//
// over every row b of B, where matches(a, b) counts the columns k with
// A[a, k] == B[b, k] in 1..q. It is the per-shard reweighting kernel of
// the mesh path: shard d passes its row block as A and all rows as B.
//
// Bound. At one shard of the main path (Ma = 8192, Mb = 32768, N = 384,
// q = 21) the TPU kernel's one-hot products are 2 Ma Mb N q = 4.3e12 int8
// operations: 2.2 ms at the dense int8 tensor-core rate (1,979 TOP/s). The
// tokens are O((Ma + Mb) N) bytes, read from L2 many times over.
//
// Design. Kernel A's tensor-core tile (onehot_wgmma.cuh: one-hot operands
// built on chip from the packed words, one wgmma m64n128k32 a warpgroup and
// state, states 1..q) over the full Ma x Mb grid of 128 x 128 tiles: A != B
// in general, so there is no symmetry to halve it, and no column partials.
// The grid is flat and 1-D (tile t -> A tile t % Ta, B tile t / Ta), so Mb
// is not capped by gridDim.y. Epilogue: A's row half only: d >> 14, the
// strict f32 test, shuffles across the four lanes that hold a row, then one
// 64-bit global atomic per row and statistic; rows past Ma and columns past
// Mb are masked (a B tile may be all padding when Mb < 128). Exact, and the
// same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

using onehot::BM;
using onehot::CW;
using onehot::MATCH_SHIFT;
using onehot::THREADS;

__global__ void __launch_bounds__(THREADS)
row_stats_rect_kernel(const uint32_t* __restrict__ A, int Ma,
                      const uint32_t* __restrict__ B, int Mb, int W,
                      long long Ta, int n_true, float thresh, int q,
                      unsigned long long* __restrict__ rowsum,
                      unsigned long long* __restrict__ below) {
  const long long t = blockIdx.x;
  const int a0 = (int)((t % Ta) * BM);
  const int b0 = (int)((t / Ta) * BM);

  int d[64];
  onehot::count_tile(A, Ma, a0, B, Mb, b0, W, q, d);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q4 = lane & 3;
  const int ra = a0 + 16 * warp + g;
  // d[4 j + e] is row ra + 8 (e / 2), column b0 + 8 j + 2 q4 + (e % 2)
  unsigned int rs[2] = {0u, 0u}, rbl[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (b0 + 8 * j + 2 * q4 + e >= Mb) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = d[4 * j + 2 * h + e] >> MATCH_SHIFT;
        rs[h] += (unsigned int)m;
        rbl[h] += ((float)(n_true - m) < thresh) ? 1u : 0u;
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
    const int r = ra + 8 * h;
    if (q4 == 0 && r < Ma) {
      atomicAdd(&rowsum[r], (unsigned long long)s);
      atomicAdd(&below[r], (unsigned long long)b);
    }
  }
}

}  // namespace

// A: [Ma, W], B: [Mb, W] 32-bit words, row-major, 4 tokens per word (each
// token 0..q, tokens above q zeroed by the caller), W a multiple of 8
// (zero-padded columns never match). B is read 16 bytes at a time: its
// base must be 16-byte aligned, and then so is every row (W is a multiple
// of 4), including B passed as a row slice of a larger packed matrix.
// n_true: the token count N the hamming distance is taken over, below
// 2^17; q: the states 1..q that count, 1 <= q <= 127. rowsum, below: [Ma]
// 64-bit accumulators, zeroed by the caller. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int gdca_row_stats_rect(const void* A, int Ma, const void* B,
                                   int Mb, int W, int n_true, float thresh,
                                   int q, void* rowsum, void* below,
                                   void* stream) {
  if (Ma <= 0 || Mb <= 0) return cudaSuccess;
  if (W <= 0 || W % CW != 0 || n_true >= (1 << (31 - MATCH_SHIFT)) ||
      q < 1 || q > 127 || reinterpret_cast<uintptr_t>(B) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long Ta = (Ma + BM - 1) / BM;
  const long long Tb = (Mb + BM - 1) / BM;
  if (Ta * Tb > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  row_stats_rect_kernel<<<(unsigned int)(Ta * Tb), THREADS, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(A), Ma, static_cast<const uint32_t*>(B),
      Mb, W, Ta, n_true, thresh, q, static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
