// Kernel E: grouped-row sequence-identity row statistics.
//
// Replaces gaussdca_tpu/ops/distance.py::row_stats_asym_pallas, with kernel
// A's contract: for a token matrix Z [M, N] (token 0 = padding that matches
// nothing, itself included; states 1..q count, tokens above q are zeroed by
// the caller and match nothing) and a threshold t, for every row a
//
//   rowsum[a] = sum_b matches(a, b)
//   below[a]  = #{b : n_true - matches(a, b) < t}
//
// over all b, b = a included.
//
// Covering. The JAX one, on fine tiles of 128 rows: T fine tiles (a
// multiple of K = 2), group g holds tiles alpha = g K + r (r < K), step jp
// pairs them with B tile beta = (g K + jp) mod T, and sub-tile r counts the
// tile pair (alpha, beta) iff its offset d = jp - r lies in [0, T / 2] (for
// even T, d = T / 2 only when alpha < T / 2): every unordered tile pair
// once, the diagonal tile (d = 0) toward its rows only. The offset is not
// wrapped, so no T needs the JAX kernel's fallback to the square kernel. A
// block (gridDim.x = T / K groups, gridDim.y = chunks of the window) walks
// the steps jp of its chunk.
//
// Arithmetic. Kernel A's int8 product over (32-column chunk, state) of
// one-hot operands built on chip from the packed token words (the equal80
// compare and its 2^14 per match, onehot_wgmma.cuh). The lever is the JAX
// kernel's: one expansion of a B tile's operand per (chunk, state) feeds
// the wgmma of all K resident row tiles, so each expanded B byte serves
// 256 rows instead of kernel A's 128.
//
// Pipeline. Three warpgroups. Warpgroup 2, the producer (setmaxnreg down to
// 40 registers), holds one B row a thread and expands the B operand of each
// (step, chunk, state) into a ring of STAGES shared stages of SPS = 3
// states (4 KB a state: 128 columns x 32 K bytes as no-swizzle core
// matrices, kernel A's layout), publishing each stage with one
// fence.proxy.async and one arrival on its full barrier: three states a
// handshake, since one producer warp a scheduler is bound by the latency
// of each handshake, not by its instructions. Warpgroups 0 and 1, the
// consumers (setmaxnreg up to 232), each own one resident row tile of 128
// rows: its packed words sit in shared memory for the block's life (loaded
// once; the row stride is 4 mod 32 words, so a fragment read hits 32
// banks), and per state each builds its A fragments (two 64-row halves) in
// registers and issues two wgmma m64n128k32, keeps one stage's wgmma group
// in flight (wait_group 1; two fragment sets, by unrolling the stage loop
// twice) and releases the stage whose group has finished through its
// empty barrier.
// The consumers' main loop has no block-wide barrier and no branch: a
// sub-tile that is not live at a step runs its wgmma all the same and is
// masked in the epilogue ((K - 1) / J of the work, as in the JAX kernel),
// since a wgmma on a path the compiler takes as divergent is serialized.
//
// Epilogue. Row partials stay in registers for the whole walk and leave
// once through 64-bit integer atomics; the column partials of a step are
// summed over both tiles in shared memory (two named barriers among the
// consumers) and leave through 64-bit atomics. Exact, and the same on
// every run.
//
// Bound. At M = 32768, N = 384, q = 21 the half grid is 8.66e12 int8
// operations, 4.38 ms at the dense int8 rate of 1,979e12/s. Per state the
// tensor cores run 2 x 2 x 64 = 256 clocks; the producer's compare (8 words
// a thread) and each consumer's (8 words a thread) are what compete with
// them for issue slots. A state above q in a stage's last slots (q not a
// multiple of 3) compares to nothing and adds no matches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_wgmma.cuh"
#include "pipeline.cuh"

namespace {

using onehot::BM;            // 128: fine tile rows, B tile columns
using onehot::CW;            // 8 words (32 token columns) a chunk
using onehot::MATCH_SHIFT;
using onehot::equal80;

constexpr int K = 2;                      // resident row tiles a block
constexpr int SPS = 3;                    // states a stage (q = 21: 7 stages)
constexpr int STAGES = 6;                 // expanded B stages in the ring
constexpr int STATE_U4 = 2 * BM;          // uint4 of one state's B (4 KB)
constexpr int STAGE_U4 = SPS * STATE_U4;  // uint4 a stage (12 KB)
constexpr int THREADS = (K + 1) * 128;    // K consumer warpgroups, producer

// row stride of the resident words: W plus padding to 4 mod 32 words
__host__ __device__ constexpr int resident_stride(int W) {
  return W + ((4 - W) % 32 + 32) % 32;
}

__global__ void __launch_bounds__(THREADS, 1)
row_stats_asym_kernel(const uint32_t* __restrict__ Z, int M, int W,
                      int n_true, float thresh, int q, int T, int J,
                      int chunk, unsigned long long* __restrict__ rowsum,
                      unsigned long long* __restrict__ below) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ unsigned int colred[2][BM];   // column sum, column below

  // the stages need 128-byte alignment: round the dynamic base up
  uint8_t* base = smem_raw + ((128 - (pipe::smem_addr(smem_raw) & 127)) & 127);
  uint4* sB = reinterpret_cast<uint4*>(base);                // [STAGES][2 BM]
  uint32_t* sA = reinterpret_cast<uint32_t*>(base + STAGES * STAGE_U4 * 16);
  const int S = resident_stride(W);                          // [K BM][S]

  const int g = blockIdx.x;
  const int jp0 = blockIdx.y * chunk;
  const int jp1 = min(J, jp0 + chunk);
  const int row0 = g * K * BM;
  const int nchunks = W / CW;
  const int nst = (q + SPS - 1) / SPS;       // stages a chunk
  const int nsteps = nchunks * nst;          // stages a step jp

  for (int i = threadIdx.x; i < K * BM * W; i += THREADS) {
    const int r = i / W, w = i % W;
    const int ga = row0 + r;
    sA[r * S + w] = (ga < M) ? __ldg(Z + (size_t)ga * W + w) : 0u;
  }
  for (int i = threadIdx.x; i < 2 * BM; i += THREADS) colred[i / BM][i % BM] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pipe::mbar_init(&full[s], 128);    // every producer thread
      pipe::mbar_init(&empty[s], 4 * K); // lane 0 of every consumer warp
    }
    pipe::mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform as the compiler sees it, so that the wgmma of each role
  // are not taken to lie on a divergent path
  const int wg = __shfl_sync(0xFFFFFFFFu, (int)threadIdx.x / 128, 0);
  if (wg == K) {
    // ---- producer: one B row (product column) a thread ----
    pipe::regs_dec<40>();
    const int nb = threadIdx.x % 128;
    const int slot = 2 * (nb / 8) * 8 + nb % 8;   // K half 0; half 1 is +8
    int stage = 0;
    uint32_t phase = 0;
    for (int jp = jp0; jp < jp1; ++jp) {
      const int rb = ((g * K + jp) % T) * BM + nb;
      const uint4* src = reinterpret_cast<const uint4*>(Z + (size_t)rb * W);
      const bool ok = rb < M;
      uint4 cur0 = make_uint4(0u, 0u, 0u, 0u), cur1 = cur0;
      if (ok) {
        cur0 = __ldg(src);
        cur1 = __ldg(src + 1);
      }
      for (int c = 0; c < nchunks; ++c) {
        uint4 nxt0 = make_uint4(0u, 0u, 0u, 0u), nxt1 = nxt0;
        if (ok && c + 1 < nchunks) {
          nxt0 = __ldg(src + 2 * (c + 1));
          nxt1 = __ldg(src + 2 * (c + 1) + 1);
        }
        for (int st0 = 1; st0 <= q; st0 += SPS) {
          pipe::mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
          for (int u = 0; u < SPS; ++u) {
            // a state above q matches nothing: the tokens are 0..q
            const uint32_t cc = 0x01010101u * (uint32_t)(st0 + u);
            uint4* dst = sB + stage * STAGE_U4 + u * STATE_U4 + slot;
            dst[0] = make_uint4(equal80(cur0.x, cc), equal80(cur0.y, cc),
                                equal80(cur0.z, cc), equal80(cur0.w, cc));
            dst[8] = make_uint4(equal80(cur1.x, cc), equal80(cur1.y, cc),
                                equal80(cur1.z, cc), equal80(cur1.w, cc));
          }
          pipe::fence_async_shared();
          pipe::mbar_arrive(&full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        cur0 = nxt0;
        cur1 = nxt1;
      }
    }
  } else {
    // ---- consumers: warpgroup r owns resident tile alpha = g K + r ----
    pipe::regs_inc<232>();
    const int r = wg;
    const int alpha = g * K + r;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gq = lane >> 2, q4 = lane & 3;
    // half h of the tile: rows 64 h + 16 warp + gq (+ 8)
    const uint32_t* aw = sA + (r * BM + 16 * warp + gq) * S + q4;
    const int arow = row0 + r * BM + 16 * warp + gq;
    unsigned int rs[2][2] = {{0u, 0u}, {0u, 0u}};
    unsigned int rbl[2][2] = {{0u, 0u}, {0u, 0u}};
    int d[2][64];
    int stage = 0;
    uint32_t phase = 0;
    for (int jp = jp0; jp < jp1; ++jp) {
      const int dd = jp - r;
      const bool live =
          dd >= 0 && 2 * dd <= T && !(2 * dd == T && 2 * alpha >= T);
      const int b0 = ((g * K + jp) % T) * BM;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) d[h][i] = 0;
      uint32_t x[2][4];   // the chunk's fragment words, m16n8k32 A order
      int prev = -1;
      // stage it: chunk it / nst, states st0 .. st0 + SPS - 1; its A
      // fragments are built before the wait on its stage. Unrolled twice,
      // so that consecutive stages build their fragments in two register
      // sets and the set of the group still in flight is never redefined
      // (ptxas would serialize the wgmma otherwise).
#pragma unroll 2
      for (int it = 0; it < nsteps; ++it) {
        const int c = it / nst, st0 = 1 + SPS * (it - c * nst);
        if (st0 == 1) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t* p = aw + 64 * h * S + c * CW;
            x[h][0] = p[0];
            x[h][1] = p[8 * S];
            x[h][2] = p[4];
            x[h][3] = p[8 * S + 4];
          }
        }
        uint32_t a[SPS][2][4];
#pragma unroll
        for (int u = 0; u < SPS; ++u) {
          const uint32_t cc = 0x01010101u * (uint32_t)(st0 + u);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[u][h][i] = equal80(x[h][i], cc);
        }
        // pin the fragments and descriptors here: the compiler must not
        // sink their instructions between the wgmma of the stage (ptxas
        // then serializes them)
#pragma unroll
        for (int u = 0; u < SPS; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[u][h][i]));
        uint64_t desc[SPS];
#pragma unroll
        for (int u = 0; u < SPS; ++u) {
          desc[u] = onehot::b_desc(sB + stage * STAGE_U4 + u * STATE_U4);
          asm volatile("" : "+l"(desc[u]));
        }
        pipe::mbar_wait(&full[stage], phase);
        pipe::wgmma_fence();
#pragma unroll
        for (int u = 0; u < SPS; ++u) {
          onehot::wgmma_s8(d[0], a[u][0], desc[u]);
          onehot::wgmma_s8(d[1], a[u][1], desc[u]);
        }
        pipe::wgmma_commit();
        pipe::wgmma_wait<1>();
        // the group that read the previous stage has finished
        if (prev >= 0 && lane == 0) pipe::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      pipe::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[h][i])::"memory");
      if (prev >= 0 && lane == 0) pipe::mbar_arrive(&empty[prev]);

      if (live) {
        // d[h][4 j + e]: row 64 h + 16 warp + gq + 8 (e / 2), column 8 j +
        // 2 q4 + (e % 2) of the tile pair
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lc = 8 * j + 2 * q4 + e;
            const bool col_ok = b0 + lc < M;
            unsigned int s = 0u, b = 0u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                if (col_ok && arow + 64 * h + 8 * hh < M) {
                  const int m = d[h][4 * j + 2 * hh + e] >> MATCH_SHIFT;
                  const unsigned int nbl =
                      ((float)(n_true - m) < thresh) ? 1u : 0u;
                  rs[h][hh] += (unsigned int)m;
                  rbl[h][hh] += nbl;
                  s += (unsigned int)m;
                  b += nbl;
                }
              }
            }
            if (dd != 0) {
              // the eight groups of a warp hold the same columns
#pragma unroll
              for (int off = 4; off < 32; off <<= 1) {
                s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
                b += __shfl_xor_sync(0xFFFFFFFFu, b, off);
              }
              if (gq == 0) {
                if (s) atomicAdd(&colred[0][lc], s);
                if (b) atomicAdd(&colred[1][lc], b);
              }
            }
          }
        }
      }
      pipe::named_barrier<K * 128>(1);
      if (threadIdx.x < BM) {
        const int col = b0 + threadIdx.x;
        const unsigned int cs = colred[0][threadIdx.x];
        const unsigned int cb = colred[1][threadIdx.x];
        if (col < M) {
          if (cs) atomicAdd(&rowsum[col], (unsigned long long)cs);
          if (cb) atomicAdd(&below[col], (unsigned long long)cb);
        }
        colred[0][threadIdx.x] = 0u;
        colred[1][threadIdx.x] = 0u;
      }
      pipe::named_barrier<K * 128>(1);
    }

    // row partials: the four lanes of a group hold the same rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned int s = rs[h][hh], b = rbl[h][hh];
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
        b += __shfl_xor_sync(0xFFFFFFFFu, b, 1);
        b += __shfl_xor_sync(0xFFFFFFFFu, b, 2);
        const int a = arow + 64 * h + 8 * hh;
        if (q4 == 0 && a < M) {
          if (s) atomicAdd(&rowsum[a], (unsigned long long)s);
          if (b) atomicAdd(&below[a], (unsigned long long)b);
        }
      }
    }
  }
}

}  // namespace

// Z: [M, W] 32-bit words, row-major, 4 tokens per word (each token 0..q,
// tokens above q zeroed by the caller), W a multiple of 8 (zero-padded
// columns never match), 16-byte aligned rows; n_true: the unpadded token
// count N, below 2^17; q: the states 1..q that count, 1 <= q <= 127;
// chunks: how many blocks share one group's window (the caller's plan:
// 2 x 128 rows of words and the ring fit shared memory). rowsum, below:
// [M] 64-bit accumulators, zeroed by the caller. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int gdca_row_stats_asym(const void* Z, int M, int W, int n_true,
                                   float thresh, int q, int chunks,
                                   void* rowsum, void* below, void* stream) {
  if (M <= 0) return cudaSuccess;
  if (W <= 0 || W % CW != 0 || n_true >= (1 << (31 - MATCH_SHIFT)) ||
      q < 1 || q > 127 || chunks <= 0)
    return cudaErrorInvalidValue;
  const long long T = (M + (long long)K * BM - 1) / ((long long)K * BM) * K;
  const int J = (int)(T / 2) + K;
  // a row partial sums at most chunk tiles of BM * n_true matches: keep it
  // inside 32 bits
  const long long cap = 0xFFFFFFFFLL / ((long long)BM * (n_true + 1));
  long long chunk = (J + chunks - 1) / chunks;
  if (chunk > cap) chunk = cap;
  if (chunk < 1) return cudaErrorInvalidValue;
  const long long C = (J + chunk - 1) / chunk;
  if (C > 65535) return cudaErrorInvalidValue;
  const size_t smem = 128 + (size_t)STAGES * STAGE_U4 * 16 +
                      (size_t)K * BM * resident_stride(W) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      row_stats_asym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(T / K), (unsigned int)C);
  row_stats_asym_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(Z), M, W, n_true, thresh, q, (int)T, J,
      (int)chunk, static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
