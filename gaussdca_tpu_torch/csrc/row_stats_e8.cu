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
// Design: the Hopper GEMM on operands in device memory. A tile is BM = 128
// rows by BN = 256 columns of the count matrix. Its K is walked 128 bytes
// a stage: a TMA load of the tile's 128 A rows and two of its 256 B rows,
// each a box of 128 rows x 128 bytes through one 2-D tensor map with the
// 128-byte swizzle (rows past M and K past the planes land as zeros), into
// a ring of STAGES = 4 stages of 48 KB with full and empty mbarriers. A
// producer warp (setmaxnreg down to 40) issues the loads; two consumer
// warpgroups (setmaxnreg up to 232), 64 rows each, run four wgmma
// m64n256k32 s8 a stage with both operands read from shared memory
// (K-major, 128-byte swizzle descriptors), keep one wgmma group in flight
// (wait_group 1) and release a stage once the group that read it is done.
// The consumers' main loop has no block-wide barrier.
//
// Cover. Tile (i, j) spans rows 128 i.. and columns 256 j..; it is walked
// iff it reaches the upper triangle (i <= 2 j + 1), and inside it an entry
// (a, b) counts iff a <= b: a < b toward row a and column b, the diagonal
// a = b toward its row only, so every unordered pair counts once. Blocks
// are persistent (one an SM, 196 KB of shared memory) and walk a grouped
// order of the tiles: column tiles in groups of GROUP = 2, each group over
// the row tiles that reach its triangle, column fastest, so the ~132 tiles
// in flight share ~66 row panels and 2 column panels of the planes in the
// 50 MB L2 and each panel comes from device memory about once a group
// (groups of 2 measured faster than groups of 4, 8 or 16, and than none).
//
// Epilogue: row partials (shuffles over the four lanes of a row) leave
// through 64-bit integer atomics; column partials are summed over both
// warpgroups in shared memory (two named barriers among the consumers) and
// leave through 64-bit atomics. Exact, and the same on every run. The
// producer runs ahead into the next tile while the consumers finish one.
//
// Bound. At M = 32768, N = 384, q = 21 (K = 8064) the half grid is 8.66e12
// int8 operations: 4.38 ms at the dense int8 rate of 1,979e12/s. Per stage
// the tensor cores run 2 x 4 x 128 = 1,024 clocks on 48 KB: the grouped
// order brings the device-memory traffic to ~2.3 GB, ~0.7 ms at 3.35 TB/s.

#include <cuda.h>   // CUtensorMap (types only: no libcuda link, see encoder)
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

namespace {

constexpr int BM = 128;                      // tile rows (two warpgroups)
constexpr int BN = 256;                      // tile columns
constexpr int BK = 128;                      // K bytes a stage
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;             // 16 KB
constexpr int STAGE_BYTES = (BM + BN) * BK;  // 48 KB
constexpr int GROUP = 2;                     // column tiles a group
constexpr int THREADS = 384;                 // two consumer warpgroups, producer

// K-major operand tile with the 128-byte swizzle: 128-byte rows, 8-row
// groups 1,024 bytes apart (SBO); the leading offset is unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A (64 x 32 s8) * B (32 x 256 s8), both from shared memory
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[128], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127 "
      "}, %128, %129, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(pipe::smem_addr(dst)),
      "l"((uint64_t)map), "r"(k), "r"(row), "r"(pipe::smem_addr(bar))
      : "memory");
}

// tile t of the grouped order -> (i, j); false past the triangle
__device__ __forceinline__ bool tile_at(long long t, int Ta, int Tb, int& i,
                                        int& j) {
  for (int c = 0; c * GROUP < Tb; ++c) {
    const int j0 = c * GROUP, jend = min(Tb, j0 + GROUP), w = jend - j0;
    const long long rows = min(Ta, 2 * jend);
    if (t < rows * w) {
      i = (int)(t / w);
      j = j0 + (int)(t % w);
      return i <= 2 * j + 1;
    }
    t -= rows * w;
  }
  return false;
}

__global__ void __launch_bounds__(THREADS, 1)
row_stats_e8_kernel(const __grid_constant__ CUtensorMap map, int M, int K,
                    int n_true, float thresh, long long L,
                    unsigned long long* __restrict__ rowsum,
                    unsigned long long* __restrict__ below) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ unsigned int colred[2][BN];   // column sum, column below

  // the swizzled stages need 1,024-byte alignment: round the base up
  uint8_t* base =
      smem_raw + ((1024 - (pipe::smem_addr(smem_raw) & 1023)) & 1023);
  const int Ta = (M + BM - 1) / BM, Tb = (M + BN - 1) / BN;
  const int nk = (K + BK - 1) / BK;

  for (int i = threadIdx.x; i < 2 * BN; i += THREADS) colred[i / BN][i % BN] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      pipe::mbar_init(&full[s], 1);    // the producer's expect_tx arrival
      pipe::mbar_init(&empty[s], 8);   // lane 0 of every consumer warp
    }
    pipe::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    pipe::regs_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < L; t += gridDim.x) {
        int ti, tj;
        if (!tile_at(t, Ta, Tb, ti, tj)) continue;
        for (int kb = 0; kb < nk; ++kb) {
          pipe::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sA = base + stage * STAGE_BYTES;
          uint8_t* sB = sA + A_BYTES;
          pipe::mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(&map, sA, &full[stage], kb * BK, ti * BM);
          tma_load(&map, sB, &full[stage], kb * BK, tj * BN);
          tma_load(&map, sB + BM * BK, &full[stage], kb * BK, tj * BN + BM);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg.. of every tile ----
    pipe::regs_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gq = lane >> 2, q4 = lane & 3;
    int d[128];
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < L; t += gridDim.x) {
      int ti, tj;
      if (!tile_at(t, Ta, Tb, ti, tj)) continue;
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0;
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb) {
        pipe::mbar_wait(&full[stage], phase);
        const uint32_t sa =
            pipe::smem_addr(base + stage * STAGE_BYTES) + wg * 64 * BK;
        const uint32_t sb = pipe::smem_addr(base + stage * STAGE_BYTES) + A_BYTES;
        const uint64_t da = sw128_desc(sa), db = sw128_desc(sb);
        pipe::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8_ss(d, da + 2 * kk, db + 2 * kk);   // +32 bytes of K
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
      for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
      if (lane == 0) pipe::mbar_arrive(&empty[prev]);

      // d[4 j + e]: row 64 wg + 16 warp + gq + 8 (e / 2), column 8 j +
      // 2 q4 + (e % 2) of the tile
      const int a0 = ti * BM + 64 * wg + 16 * warp + gq;
      const int b0 = tj * BN;
      unsigned int rs[2] = {0u, 0u}, rbl[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lc = 8 * j + 2 * q4 + e;
          const int col = b0 + lc;
          unsigned int s = 0u, b = 0u;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = a0 + 8 * hh;
            if (row < M && col < M && row <= col) {
              const int m = d[4 * j + 2 * hh + e];
              const unsigned int nbl = ((float)(n_true - m) < thresh) ? 1u : 0u;
              rs[hh] += (unsigned int)m;
              rbl[hh] += nbl;
              if (row < col) {
                s += (unsigned int)m;
                b += nbl;
              }
            }
          }
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
      // the four lanes of a group hold the same rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned int s = rs[hh], b = rbl[hh];
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
        b += __shfl_xor_sync(0xFFFFFFFFu, b, 1);
        b += __shfl_xor_sync(0xFFFFFFFFu, b, 2);
        const int row = a0 + 8 * hh;
        if (q4 == 0 && row < M) {
          if (s) atomicAdd(&rowsum[row], (unsigned long long)s);
          if (b) atomicAdd(&below[row], (unsigned long long)b);
        }
      }
      pipe::named_barrier<256>(1);
      {
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
      pipe::named_barrier<256>(1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library links no libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// E: [M, K] int8 one-hot planes, row-major, 16-byte aligned, K a multiple of
// 64 (zero padding matches nothing); n_true: the token count N the hamming
// distance is taken over. rowsum, below: [M] 64-bit accumulators, zeroed by
// the caller. Launches on `stream` and returns cudaGetLastError() (or
// cudaErrorNotSupported without the driver's tensor-map encoder).
extern "C" int gdca_row_stats_e8(const void* E, int M, int K, int n_true,
                                 float thresh, void* rowsum, void* below,
                                 void* stream) {
  if (M <= 0) return cudaSuccess;
  if (K <= 0 || K % 64 != 0 || reinterpret_cast<uintptr_t>(E) % 16 != 0)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(E),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // tiles of the grouped order (tile_at), dead ones included
  const int Ta = (M + BM - 1) / BM, Tb = (M + BN - 1) / BN;
  long long L = 0;
  for (int j0 = 0; j0 < Tb; j0 += GROUP) {
    const int jend = j0 + GROUP < Tb ? j0 + GROUP : Tb;
    L += (long long)(Ta < 2 * jend ? Ta : 2 * jend) * (jend - j0);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 1024 + (size_t)STAGES * STAGE_BYTES;
  err = cudaFuncSetAttribute(row_stats_e8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned int grid = (unsigned int)(L < sms ? L : sms);
  row_stats_e8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      map, M, K, n_true, thresh, L, static_cast<unsigned long long*>(rowsum),
      static_cast<unsigned long long*>(below));
  return (int)cudaGetLastError();
}
