// The int8 tensor-core match tile shared by kernels A (row_stats.cu), C
// (row_stats_rect.cu) and D (match_counts.cu).
//
// matches(a, b) = sum over states c = 1..q and columns k of
// [A[a, k] = c] [B[b, k] = c]: one int8 product whose depth runs over
// (32-column chunk, state). The one-hot planes never exist in device
// memory: with K ordered as 32 token columns of one state, four
// consecutive K bytes of one row are one packed token word, so the operand
// of state c is a bytewise compare of that word with c * 0x01010101:
// x = w ^ cc has a zero byte exactly where the token is c, and since tokens
// and states are below 128 (the wrappers zero tokens above q), x +
// 0x7F7F7F7F carries out of no byte and leaves a byte's high bit clear
// exactly there. So ~(x + 0x7F7F7F7F) & 0x80808080 is 0x80 (-128 as s8) in
// each matching byte: three integer instructions a word, and (-128)(-128)
// = 2^14 per match, divided out by the caller (exact while N < 2^17).
//
// count_tile: a block of 256 threads counts one 128 x 128 tile of row
// pairs (A rows a0.., B rows b0..). Its two warpgroups each own 64 of the
// tile's rows and run, for every chunk and state, one wgmma.mma_async
// m64n128k32 s8 x s8 -> s32 with 64 accumulators a thread. A comes from
// registers: each thread compares the four words of its fragment (rows
// 16 warp + g and + 8, words q4 and q4 + 4 of the chunk: the m16n8k32 A
// layout), fetched from device memory a chunk ahead (the tokens stay in
// L2). B comes from shared memory: each thread compares 16 bytes of one B
// column (one row of B) and stores them, so each B value is expanded once
// a block, into a 4 KB tile of core matrices (8 columns x 16 K bytes, no
// swizzle: the two K halves of a column group 128 bytes apart, column
// groups 256 bytes apart, as the descriptor's leading and stride offsets
// say). A state is a shared store, fence.proxy.async (generic writes, then
// tensor-core reads), one barrier, wgmma.fence, the wgmma, commit and
// wait; two B stages alternate, so a stage is rewritten only after every
// warpgroup has waited on the wgmma that read it.
//
// The accumulator layout the callers' epilogues read: d[4 j + e] is row
// 16 warp + g + 8 (e / 2), column 8 j + 2 q4 + (e % 2) of the tile (warp =
// threadIdx.x / 32, g = lane / 4, q4 = lane % 4).
//
// What bounds it: the tensor-core work of a block and state (128 x 128 x
// 32 multiply-adds) takes 128 clocks of an SM at the dense rate; the byte
// compares (8 a thread and state, 24 integer instructions), the proxy
// fence and the barrier take the rest. Kernel A's build: 107 registers,
// 10,240 bytes of shared memory, so two blocks share an SM and one's
// expansion overlaps the other's wgmma.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace onehot {

constexpr int BM = 128;          // rows per tile side
constexpr int CW = 8;            // words (32 token columns) a chunk
constexpr int MATCH_SHIFT = 14;  // log2 of (-128)^2, one match's product
constexpr int THREADS = 256;     // two warpgroups of 64 rows
constexpr int STAGES = 2;        // B tiles in shared memory
constexpr int LBO = 128;         // bytes between K-adjacent core matrices
constexpr int SBO = 256;         // bytes between 8-column core matrices

// 0x80 in each byte of w equal to the matching byte of cc, else 0; every
// byte of w and cc is below 0x80, so the add carries across no byte
__device__ __forceinline__ uint32_t equal80(uint32_t w, uint32_t cc) {
  return ~((w ^ cc) + 0x7F7F7F7Fu) & 0x80808080u;
}

// tile t of the upper triangle of tiles, column-major: t = tj (tj + 1) / 2
// + ti, ti <= tj (kernels A and D)
__device__ __forceinline__ void triangle_tile(long long t, long long& ti,
                                              long long& tj) {
  tj = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  while (tj * (tj + 1) / 2 > t) --tj;
  ti = t - tj * (tj + 1) / 2;
}

// shared-memory matrix descriptor of a no-swizzle, K-major B tile
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32);
}

// d += a (64 x 32 s8, this warp's 16 rows in registers) * B (32 x 128 s8
// from the descriptor), s32 accumulators
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d = 2^14 x matches over states 1..q of A rows a0 + 16 warp + g (+ 8) and
// B rows b0 + the accumulator's columns (layout above); A rows past Ma and
// B rows past Mb read as token 0. A, B: row-major packed words, W of them a
// row (a multiple of CW); B's rows 16-byte aligned (its base too: W is a
// multiple of 4). Every thread of the block must call it: it synchronizes
// the block at every state.
__device__ __forceinline__ void count_tile(
    const uint32_t* __restrict__ A, int Ma, int a0,
    const uint32_t* __restrict__ B, int Mb, int b0, int W, int q,
    int (&d)[64]) {
  // B stage: core matrix (column group n / 8, K half) at uint4 index
  // (2 (n / 8) + half) 8, column n % 8 within it
  __shared__ __align__(128) uint4 sB[STAGES][2 * BM];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q4 = lane & 3;   // fragment group / thread in it
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  // A: this warp's rows ra and ra + 8; B: column nb, K half kb
  const int ra = a0 + 16 * warp + g;
  const int nb = threadIdx.x % BM, kb = threadIdx.x / BM;
  const int slot = (2 * (nb / 8) + kb) * 8 + nb % 8;
  auto word = [&](int r, int w) -> uint32_t {
    return r < Ma ? __ldg(A + (size_t)r * W + w) : 0u;
  };
  // x[0..3]: the A fragment's words in register order; x[4..7]: the
  // 16 B-column bytes; rows past Ma / Mb read 0
  auto fetch = [&](int w0, uint32_t (&x)[8]) {
    x[0] = word(ra, w0 + q4);
    x[1] = word(ra + 8, w0 + q4);
    x[2] = word(ra, w0 + q4 + 4);
    x[3] = word(ra + 8, w0 + q4 + 4);
    const int rb = b0 + nb;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rb < Mb)
      v = __ldg(reinterpret_cast<const uint4*>(B + (size_t)rb * W + w0 +
                                               4 * kb));
    x[4] = v.x;
    x[5] = v.y;
    x[6] = v.z;
    x[7] = v.w;
  };

  uint32_t cur[8];
  fetch(0, cur);
  int stage = 0;
  for (int w0 = 0; w0 < W; w0 += CW) {
    uint32_t nxt[8];
    if (w0 + CW < W) fetch(w0 + CW, nxt);
    for (int c = 1; c <= q; ++c) {
      const uint32_t cc = 0x01010101u * (uint32_t)c;
      sB[stage][slot] = make_uint4(equal80(cur[4], cc), equal80(cur[5], cc),
                                   equal80(cur[6], cc), equal80(cur[7], cc));
      const uint32_t af[4] = {equal80(cur[0], cc), equal80(cur[1], cc),
                              equal80(cur[2], cc), equal80(cur[3], cc)};
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_s8(d, af, b_desc(&sB[stage][0]));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      stage ^= 1;
    }
    if (w0 + CW < W) {
#pragma unroll
      for (int e = 0; e < 8; ++e) cur[e] = nxt[e];
    }
  }
  // the accumulators are read only after the last wait
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace onehot
