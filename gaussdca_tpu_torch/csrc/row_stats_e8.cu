// Kernel F: row statistics from one-hot planes on the int8 tensor cores.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_sym_e8_pallas, with
// kernel A's contract, over precomputed one-hot planes: E8 [M, K] int8
// with E8[a, n q + c - 1] = 1 iff Z[a, n] = c (c = 1..q; token 0 gives an
// all-zero row segment), K zero-padded to a multiple of 64. Then
// matches(a, b) = sum_k E8[a, k] E8[b, k], and for every row a
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : n_true - matches(a, b) < t}
//
// over all b, b = a included.
//
// Design. A block owns one 128 x 128 tile (ti <= tj) of the M x M count
// matrix: the upper triangle of tiles on a flat 1-D grid, as kernel A.
// Eight warps (2 x 4) each hold a 64 x 32 part of it as 16 int32
// accumulators of mma.sync.m16n8k32 s8 x s8 -> s32 (inline PTX; fragments
// are 32-bit loads from row-major planes, since the B operand in ".col"
// layout is a row of E8). The depth K is walked 64 bytes at a time through
// a two-stage cp.async ring in shared memory (rows padded to 80 bytes:
// conflict-free fragment loads); rows past M are zero-filled by the copy.
// The epilogue turns the count tile into row and column partials of rowsum
// and below (strict <, f32 threshold): warp shuffles, then shared-memory
// atomics, then 64-bit global atomics; a diagonal tile counts toward its
// rows only. Exact, and the same on every run.
//
// Bound. At M = 32768, N = 384, q = 21 the half grid is 8.66e12 int8
// operations: 4.38 ms at the dense int8 rate of 1,979e12/s (wgmma; the
// mma.sync used here reaches less). Each block reads 2 x 128 x K bytes; the
// 264 MB of planes do not fit the 50 MB L2, so a wave of blocks that moves
// to the next column tile re-reads its row tiles from device memory: about
// 33 GB, ~10 ms at 3.35 TB/s. Larger tiles, a tile order that keeps row
// tiles in L2, TMA and wgmma are the levers of a later redesign.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows per tile side
constexpr int BK = 64;           // plane bytes per stage
constexpr int THREADS = 256;     // 8 warps: 2 along rows x 4 along columns
constexpr int SROW = BK + 16;    // padded shared row, bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;   // 0 source bytes: 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
row_stats_e8_kernel(const int8_t* __restrict__ E, int M, int K, int n_true,
                    float thresh, unsigned long long* __restrict__ rowsum,
                    unsigned long long* __restrict__ below) {
  __shared__ __align__(16) int8_t sA[2][BM * SROW];
  __shared__ __align__(16) int8_t sB[2][BM * SROW];
  __shared__ unsigned int red[4][BM];   // row sum, row below, col sum, col below

  // tile t of the upper triangle, column-major: t = tj (tj + 1) / 2 + ti
  const long long t = blockIdx.x;
  long long tj = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  while (tj * (tj + 1) / 2 > t) --tj;
  const long long ti = t - tj * (tj + 1) / 2;
  const int a0 = (int)(ti * BM);
  const int b0 = (int)(tj * BM);
  const bool diag = (ti == tj);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;   // 64-row x 32-column part
  const int g = lane >> 2, q4 = lane & 3;   // fragment group / thread in it

  for (int i = threadIdx.x; i < 4 * BM; i += THREADS) red[i / BM][i % BM] = 0u;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // one stage: both 128 x 64-byte tiles, 16 bytes a copy, 4 copies a row
  auto load = [&](int stage, int k0) {
    for (int c = threadIdx.x; c < BM * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16), o = (c % (BK / 16)) * 16;
      const int ga = a0 + r, gb = b0 + r;
      cp_async16(&sA[stage][r * SROW + o],
                 E + (size_t)(ga < M ? ga : 0) * K + k0 + o, ga < M);
      cp_async16(&sB[stage][r * SROW + o],
                 E + (size_t)(gb < M ? gb : 0) * K + k0 + o, gb < M);
    }
    cp_async_commit();
  };

  const int nk = K / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = sA[kt & 1];
    const int8_t* B = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = A + (wm * 64 + mi * 16 + g) * SROW + kk + q4 * 4;
        af[mi][0] = ld32(p);
        af[mi][1] = ld32(p + 8 * SROW);
        af[mi][2] = ld32(p + 16);
        af[mi][3] = ld32(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = B + (wn * 32 + ni * 8 + g) * SROW + kk + q4 * 4;
        bf[ni][0] = ld32(p);
        bf[ni][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }

  // epilogue: accumulator e of (mi, ni) is row wm 64 + mi 16 + g + 8 (e / 2),
  // column wn 32 + ni 8 + 2 q4 + (e % 2) of the tile
  unsigned int cs[4][2], cb[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) cs[ni][0] = cs[ni][1] = cb[ni][0] = cb[ni][1] = 0u;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * 64 + mi * 16 + g + 8 * h;
      const bool row_ok = a0 + lr < M;
      unsigned int s = 0u, b = 0u;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = b0 + wn * 32 + ni * 8 + 2 * q4 + e;
          if (row_ok && col < M) {
            const int m = acc[mi][ni][2 * h + e];
            const unsigned int nb =
                ((float)(n_true - m) < thresh) ? 1u : 0u;
            s += (unsigned int)m;
            b += nb;
            cs[ni][e] += (unsigned int)m;
            cb[ni][e] += nb;
          }
        }
      }
      // the four lanes of a group hold the same row
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
      b += __shfl_xor_sync(0xFFFFFFFFu, b, 1);
      b += __shfl_xor_sync(0xFFFFFFFFu, b, 2);
      if (q4 == 0) {
        atomicAdd(&red[0][lr], s);
        atomicAdd(&red[1][lr], b);
      }
    }
  }
  if (!diag) {
    // the eight groups of a warp hold the same columns
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        unsigned int s = cs[ni][e], b = cb[ni][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
          b += __shfl_xor_sync(0xFFFFFFFFu, b, off);
        }
        if (g == 0) {
          const int lc = wn * 32 + ni * 8 + 2 * q4 + e;
          atomicAdd(&red[2][lc], s);
          atomicAdd(&red[3][lc], b);
        }
      }
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

// E: [M, K] int8 one-hot planes, row-major, K a multiple of 64 (zero
// padding matches nothing); n_true: the token count N the hamming distance
// is taken over. rowsum, below: [M] 64-bit accumulators, zeroed by the
// caller. Launches on `stream` and returns cudaGetLastError().
extern "C" int gdca_row_stats_e8(const void* E, int M, int K, int n_true,
                                 float thresh, void* rowsum, void* below,
                                 void* stream) {
  if (M <= 0) return cudaSuccess;
  if (K <= 0 || K % BK != 0) return cudaErrorInvalidValue;
  const long long T = (M + BM - 1) / BM;
  const long long tiles = T * (T + 1) / 2;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  row_stats_e8_kernel<<<(unsigned int)tiles, THREADS, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(E), M, K, n_true, thresh,
      static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
