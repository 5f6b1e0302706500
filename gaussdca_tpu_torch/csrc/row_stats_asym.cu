// Kernel E: grouped-row sequence-identity row statistics.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_asym_pallas, with kernel
// A's contract: for a token matrix Z [M, N] (states 0..31, token 0 =
// padding that matches nothing, itself included) and a threshold t, for
// every row a
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : n_true - matches(a, b) < t}
//
// over all b, b = a included.
//
// Design. The JAX kernel caches the one-hot planes of a group of k row
// tiles in VMEM and streams the B tiles of their circulant window past
// them along its sequential jp grid axis. Here a block holds the packed
// words (packed_match.cuh: 4 tokens a word) of k fine 64-row tiles in
// shared memory for its whole life and walks a chunk of the window's B
// tiles in a loop; each B tile is staged once and compared with all k
// resident tiles. The covering is the JAX one: T fine tiles, group g holds
// tiles alpha = g k + r (r < k), step jp reads B tile beta = (g k + jp) mod
// T, and sub-tile r counts the tile pair (alpha, beta) iff its offset
// d = jp - r lies in [0, T / 2] (for even T, d = T / 2 only when alpha <
// T / 2): every unordered tile pair once, the diagonal tile (d = 0) toward
// its rows only. The JAX kernel reads the offset mod T and so falls back
// to the square kernel when the window would wrap (T / 2 + k > T); the
// offset here is not wrapped, and no T needs the fallback. Row partials
// stay in registers for the whole walk and leave once through 64-bit
// integer atomics; column partials of a B tile are summed in shared
// memory over the k sub-tiles and leave through 64-bit atomics once per
// step. The window is split into a few chunks (gridDim.y) so that enough
// blocks fill the card; the counts are exact and the same on every run.
//
// Bound. The work is kernel A's: M^2 N / 8 popcounts (the half grid) on
// O(M N) input bytes. At M = 32768, N = 384, q = 21: 8.66e12 int8
// operations as the JAX kernel counts them, 4.38 ms on the tensor cores at
// 1,979e12/s; 12.3 ms on the popcount pipe (16 a clock on each of 132 SMs
// at 1.98 GHz), which this kernel runs on. What the grouping saves is
// staging: a B tile is read from L2 once for k tile pairs, and the k
// resident tiles are read from L2 once for the block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_match.cuh"

namespace {

using gdca::THREADS;
using gdca::TILE;

template <int K>
__global__ void __launch_bounds__(THREADS)
row_stats_asym_kernel(const uint32_t* __restrict__ Z, int M, int W,
                      int n_true, float thresh, int T, int J, int chunk,
                      unsigned long long* __restrict__ rowsum,
                      unsigned long long* __restrict__ below) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned int colred[2][TILE];   // column sum, column below
  const int S = W + 1;                       // odd stride: no bank conflicts
  uint32_t* sA = smem;                       // [K * TILE][S], resident
  uint32_t* sB = smem + K * TILE * S;        // [TILE][S], one B tile

  const int g = blockIdx.x;
  const int jp0 = blockIdx.y * chunk;
  const int jp1 = min(J, jp0 + chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = g * K * TILE;
  const int Dmax = T / 2;

  for (int i = threadIdx.x; i < K * TILE * W; i += THREADS) {
    const int r = i / W, w = i % W;
    const int ga = row0 + r;
    sA[r * S + w] = (ga < M) ? Z[(size_t)ga * W + w] : 0u;
  }

  unsigned int rs[K][4], bl[K][4];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) rs[r][i] = bl[r][i] = 0u;

  for (int jp = jp0; jp < jp1; ++jp) {
    const int b0 = ((g * K + jp) % T) * TILE;
    __syncthreads();   // sA is loaded; sB and colred are free again
    for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
      const int r = i / W, w = i % W;
      const int gb = b0 + r;
      sB[r * S + w] = (gb < M) ? Z[(size_t)gb * W + w] : 0u;
    }
    for (int i = threadIdx.x; i < 2 * TILE; i += THREADS)
      colred[i / TILE][i % TILE] = 0u;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < K; ++r) {
      // the same for every thread of the block: no divergence
      const int d = jp - r;
      const int alpha = g * K + r;
      if (d < 0 || d > Dmax || (2 * d == T && alpha >= T / 2)) continue;

      uint32_t cnt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[i][j] = 0u;
      const uint32_t* ar = sA + (r * TILE + ty) * S;
      const uint32_t* br = sB + tx * S;
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        uint32_t av[4], an[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = ar[16 * i * S + w];
          an[i] = gdca::nonzero_bytes(av[i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = br[16 * j * S + w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cnt[i][j] += __popc(gdca::equal_bytes(av[i], bv[j]) & an[i]);
      }

      unsigned int cs[4] = {0u, 0u, 0u, 0u}, cb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = alpha * TILE + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = b0 + tx + 16 * j;
          if (a < M && b < M) {
            const unsigned int m = cnt[i][j];
            const unsigned int nb =
                ((float)(n_true - (int)m) < thresh) ? 1u : 0u;
            rs[r][i] += m;
            bl[r][i] += nb;
            cs[j] += m;
            cb[j] += nb;
          }
        }
      }
      if (d != 0) {
        // lanes l and l ^ 16 hold the same columns (ty and ty + 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs[j] += __shfl_xor_sync(0xFFFFFFFFu, cs[j], 16);
          cb[j] += __shfl_xor_sync(0xFFFFFFFFu, cb[j], 16);
          if ((ty & 1) == 0) {
            atomicAdd(&colred[0][tx + 16 * j], cs[j]);
            atomicAdd(&colred[1][tx + 16 * j], cb[j]);
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < TILE && b0 + (int)threadIdx.x < M) {
      const int b = b0 + threadIdx.x;
      const unsigned int cs = colred[0][threadIdx.x];
      const unsigned int cb = colred[1][threadIdx.x];
      if (cs) atomicAdd(&rowsum[b], (unsigned long long)cs);
      if (cb) atomicAdd(&below[b], (unsigned long long)cb);
    }
  }

  // row partials: the 16 lanes of a half-warp share ty, hence the rows
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned int s = rs[r][i], b = bl[r][i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
        b += __shfl_xor_sync(0xFFFFFFFFu, b, off);
      }
      const int a = row0 + r * TILE + ty + 16 * i;
      if (tx == 0 && a < M) {
        if (s) atomicAdd(&rowsum[a], (unsigned long long)s);
        if (b) atomicAdd(&below[a], (unsigned long long)b);
      }
    }
  }
}

template <int K>
int launch(const uint32_t* Z, int M, int W, int n_true, float thresh,
           int chunks, unsigned long long* rowsum, unsigned long long* below,
           cudaStream_t stream) {
  const long long T = (M + (long long)K * TILE - 1) / ((long long)K * TILE) * K;
  if (T > 0x3FFFFFFFLL) return cudaErrorInvalidValue;
  const int J = (int)(T / 2) + K;
  // a row partial sums at most chunk tiles of TILE * N <= TILE * 4 W
  // matches: keep it inside 32 bits
  const long long cap = 0xFFFFFFFFLL / ((long long)TILE * 4 * W);
  long long chunk = (J + chunks - 1) / chunks;
  if (chunk > cap) chunk = cap;
  if (chunk < 1) return cudaErrorInvalidValue;
  const long long C = (J + chunk - 1) / chunk;
  if (C > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(K + 1) * TILE * (W + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      row_stats_asym_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(T / K), (unsigned int)C);
  row_stats_asym_kernel<K><<<grid, THREADS, smem, stream>>>(
      Z, M, W, n_true, thresh, (int)T, J, (int)chunk, rowsum, below);
  return (int)cudaGetLastError();
}

}  // namespace

// Z: [M, W] 32-bit words, row-major, 4 tokens per word (zero-padded columns
// never match); n_true: the token count N the hamming distance is taken
// over; k in {2, 3, 4}: row tiles a block holds (the caller's plan fits
// (k + 1) * 64 * (W + 1) words in shared memory); chunks: how many blocks
// share one group's window. rowsum, below: [M] 64-bit accumulators,
// zeroed by the caller. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gdca_row_stats_asym(const void* Z, int M, int W, int n_true,
                                   float thresh, int k, int chunks,
                                   void* rowsum, void* below, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (W <= 0 || chunks <= 0) return cudaErrorInvalidValue;
  const uint32_t* z = static_cast<const uint32_t*>(Z);
  auto* rs = static_cast<unsigned long long*>(rowsum);
  auto* bl = static_cast<unsigned long long*>(below);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 2: return launch<2>(z, M, W, n_true, thresh, chunks, rs, bl, s);
    case 3: return launch<3>(z, M, W, n_true, thresh, chunks, rs, bl, s);
    case 4: return launch<4>(z, M, W, n_true, thresh, chunks, rs, bl, s);
    default: return cudaErrorInvalidValue;
  }
}
