// Kernel D: the dense all-pairs identity-count matrix.
//
// Replaces gaussdca_tpu/ops/distance.py::match_counts_pallas. For a token
// matrix Z [M, N] (token 0 = padding that matches nothing, itself
// included; states 1..q count, tokens above q match nothing) it writes the
// int32 matrix
//
//   out[a, b] = matches(a, b) = #{k : Z[a, k] == Z[b, k] in 1..q}
//
// for every ordered pair (a, b), a = b included: the input of the dense
// reweighting path (stats/reweight.py::compute_weights).
//
// Bound. matches(a, b) = matches(b, a), so half the grid's products give
// every entry: at M = 32768, N = 384, q = 21 that is M^2 N q = 8.7e12 int8
// operations, 4.38 ms at the dense int8 tensor-core rate (1,979 TOP/s;
// the TPU kernel's full grid, 2 M^2 N q, 8.75 ms); the 4.3 GB output
// takes 1.28 ms at 3.35 TB/s.
//
// Design. Kernel A's tensor-core tile (onehot_wgmma.cuh: one-hot operands
// built on chip from the packed words, one wgmma m64n128k32 a warpgroup and
// state, states 1..q) over A's upper triangle of 128 x 128 tiles (ti <= tj,
// flat 1-D grid, A's numbering). A block writes its tile at (a0 + r, b0 +
// c) and, off the diagonal, its transpose at (b0 + c, a0 + r), so every
// entry is written exactly once and the tensor-core work is half the full
// grid's. The stores go straight from the accumulators: in the layout of
// count_tile, one store instruction of a warp writes, per row, the four
// lanes of a group at stride 8 bytes (two instructions fill a 32-byte
// sector), and, transposed, eight consecutive rows of one column as 32
// consecutive bytes, one sector each. Rows and columns past M are masked on
// both writes. M^2 outgrows 32-bit offsets at M > 46,340: every output
// offset is 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"

namespace {

using onehot::BM;
using onehot::CW;
using onehot::MATCH_SHIFT;
using onehot::THREADS;

__global__ void __launch_bounds__(THREADS)
match_counts_kernel(const uint32_t* __restrict__ Z, int M, int W, int q,
                    int* __restrict__ out) {
  long long ti, tj;
  onehot::triangle_tile(blockIdx.x, ti, tj);
  const int a0 = (int)(ti * BM);
  const int b0 = (int)(tj * BM);
  const bool diag = (ti == tj);

  int d[64];
  onehot::count_tile(Z, M, a0, Z, M, b0, W, q, d);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q4 = lane & 3;
  // d[4 j + e] is row a0 + 16 warp + g + 8 (e / 2), column b0 + 8 j + 2 q4
  // + (e % 2)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = a0 + 16 * warp + g + 8 * h;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = b0 + 8 * j + 2 * q4 + e;
        if (c >= M) continue;
        const int m = d[4 * j + 2 * h + e] >> MATCH_SHIFT;
        out[(size_t)r * (size_t)M + c] = m;
        if (!diag) out[(size_t)c * (size_t)M + r] = m;
      }
    }
  }
}

}  // namespace

// Z: [M, W] 32-bit words, row-major, 4 tokens per word (each token 0..q,
// tokens above q zeroed by the caller), W a multiple of 8 and at most 2^15
// (zero-padded columns never match; fewer than 2^17 of them hold a token),
// 16-byte aligned; q: the states 1..q that count, 1 <= q <= 127. out:
// [M, M] int32, every element written. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gdca_match_counts(const void* Z, int M, int W, int q,
                                 void* out, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (W <= 0 || W % CW != 0 || W > (1 << (29 - MATCH_SHIFT)) || q < 1 ||
      q > 127 || reinterpret_cast<uintptr_t>(Z) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long T = (M + BM - 1) / BM;
  const long long tiles = T * (T + 1) / 2;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  match_counts_kernel<<<(unsigned int)tiles, THREADS, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(Z), M, W, q, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
