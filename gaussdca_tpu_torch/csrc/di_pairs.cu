// Kernel B: Gaussian direct information of position pairs.
//
// Replaces gaussdca_tpu/ops/di_kernel.py::ns_sqrtm_pallas together with
// the XLA-fused core around it, gaussdca_tpu/score/di.py::_di_pairs_bm_minor.
// For pair p = (i, j) = (iu[p], ju[p]) with s = q - 1, it reads the s x s
// coupling block J = mJ[(i-row0)*s:(i-row0+1)*s, j*s:(j+1)*s] (mJ may be
// the row slab of the sites from row0 on; row0 = 0 for the whole matrix)
// and the Cholesky factors
// Li = Lsite[i], Lj = Lsite[j] straight from their arrays (no [P, s, s]
// gathers), then, exactly as _di_pairs_bm_minor:
//
//   rho = Li^T J Lj,  G = 4 rho rho^T + I,
//   c = min(trace G, max absolute row sum of G),  Y0 = G / c,
//   coupled Newton-Schulz for `iters` steps (T = 1.5 I - 0.5 Z Y;
//   Y <- Y T; Z <- T Z), with the identity matmuls of step 1 and the
//   dead final Z update skipped (value-exact),
//   S = Y sqrt(c),  H = sym((S + I) / 2),
//   di = 1/2 sum_k log(pivot_k) by unpivoted elimination of H, each pivot
//   clamped below at 0.1.
//
// The elimination updates only the trailing block: the rows and columns
// that _di_pairs_bm_minor also updates never feed a later pivot.
//
// Bound. Per pair the work is 42 s x s products (rho, G and the trimmed
// Newton-Schulz steps) and one elimination, ~0.34 MFLOP at s = 20 on 3 s^2
// input values: the kernel is bound by f32 (f64) multiply-adds on the CUDA
// cores, not by device memory (3.38e11 FLOP at N = 1000, s = 20: 5.05 ms at
// 67 TFLOP/s). What keeps a kernel from that rate is what it issues beside
// the FMAs: shared-memory wavefronts (one a clock for the whole SM, against
// four FFMA warp instructions), idle lanes, FMA latency.
//
// Design. A warp runs PPW pairs, each on L lanes, with three S x S
// buffers in shared memory (row stride LD); S = s rounded up to a multiple
// of 4 is the template's size and the launch dispatches on it. In a
// product C = A B the pair's lanes form an (S/TM) x (S/TN) grid and each
// owns a TM x TN micro-tile of C, held as TM TN independent accumulators
// (no output is one chain of dependent FMAs). At every k a lane reads TM
// values of A's column k and TN values of B's row k as scalars, straight
// from the row-major buffers (or their transposes, for Li^T and rho^T):
// lanes of one grid row read the same A words and lanes of one grid column
// the same B words (broadcasts), and LD and the pairs' offset OFF (mod 32
// words) put the words that differ on distinct banks in all four reading
// patterns, so each load is one wavefront and no transposed copy is kept.
// At s = 20 a warp runs two pairs on 16 lanes each, 5 x 5 tiles: per k, 10
// loads (10 wavefronts) feed 25 FFMA warp instructions, 800 multiply-adds,
// with no lane idle. A product that replaces its own operand accumulates
// in registers, then the warp synchronizes and writes. The three buffers
// hold Y, Z and T (first J, Lj, Li; then X = J Lj, rho, G; at the end H).
// Measured slower on an H100: 4 x 4 tiles on 25 lanes, one pair a warp,
// with 128-bit loads (a 128-bit load costs a wavefront per eight lanes even
// when they broadcast) or scalar loads, and six buffers that kept every
// iterate in both layouts (twice the stores and half the pairs an SM).
// S (s): TM x TN, lanes a pair, pairs a warp, warps a block:
//
//   S =  4 (s 1-4):   2 x 2,  4 lanes, 8 pairs, 8 warps  (32 of 32 lanes)
//   S =  8 (s 5-8):   2 x 2, 16 lanes, 2 pairs, 8 warps  (32)
//   S = 12 (s 9-12):  4 x 4,  9 lanes, 3 pairs, 8 warps  (27)
//   S = 16 (s 13-16): 4 x 4, 16 lanes, 2 pairs, 8 warps  (32)
//   S = 20 (s 17-20): 5 x 5, 16 lanes, 2 pairs, 8 warps  (32)
//   S = 24 (s 21-24): 6 x 6, 16 lanes, 2 pairs, 4 warps  (32)
//   S = 28 (s 25-28): 7 x 7, 16 lanes, 2 pairs, 4 warps  (32)
//   S = 32 (s 29-30): 8 x 8, 16 lanes, 2 pairs, 4 warps  (32)
//
// A block runs consecutive pairs, which share Li and read neighbouring J
// blocks; at s = 20, 8 warps a block measured faster than 2, 4 or 6 and
// about as fast as 12 or 16. At S >= 24 the f64 buffers of 8 warps would
// not fit in a block's shared memory.
//
// Only the S = 20 row (proteins, q = 21) was chosen by timing on an H100.
// The other rows follow the same rules untimed: every lane busy, LD and
// OFF picked for distinct banks, 8 warps where the f64 buffers fit. Each
// is checked against the plain version on the card, whole and on a slab
// (chip_smoke.py), but another tile, LD or warp count may be faster there.
//
// Registers follow the micro-tile, not the largest s: ptxas gives 80 a
// thread at S = 20 in f32 (106 in f64), 40 at S = 4 and 168 at S = 32, and
// reports every instantiation in the build log (-Xptxas=-v). Shared memory a block is WARPS PPW 3 S LD
// values (plus the offset padding): 76,800 bytes at s = 20 in f32, two
// blocks (sixteen warps, thirty-two pairs) an SM, which shared memory
// limits.
//
// Zero padding is exact. Rows and columns s..S-1 of J, Li and Lj are zero,
// so rho's padding is zero and G = 4 rho rho^T + I is block-diagonal with
// the identity as its padded block. Products of block-diagonal matrices
// keep their off-diagonal blocks exactly zero (each padded term adds 0 * x
// to a sum), and the padded block stays finite (Newton-Schulz of 1/c, with
// c >= 1). The trace is taken over the first s diagonal entries only; the
// infinity norm needs no care (every row of G sums to >= 1, the padded
// rows to exactly 1); the logdet takes the first s pivots only. The real
// block is then computed by the same multiply-adds, in the same order, as
// without padding. Every lane of a pair follows one fixed schedule, so a
// pair's value does not depend on the other pairs of its launch (a row slab
// gives the whole matrix's values bit for bit).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXS = 30;      // s = q - 1 <= 30 (q <= 31)
constexpr int NBUF = 3;       // S x LD buffers a pair

__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// acc = A B over k < S for the micro-tile at (r0, c0) of row-major S x S
// matrices with row stride LD; LT / RT: read A / B as the transpose of
// what is stored. Operands are read as scalars: a 32-bit load whose lanes
// read one address or distinct banks is one shared-memory wavefront (a
// 128-bit load costs a wavefront for every eight lanes, broadcast or not),
// and LD and the pairs' offsets are chosen so that the lanes of a warp
// reading different words read different banks in all four patterns.
template <typename T, int S, int LD, int TM, int TN, bool LT, bool RT>
__device__ __forceinline__ void mm(const T* A, const T* B, int r0, int c0,
                                   T (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    T a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = LT ? A[k * LD + r0 + i] : A[(r0 + i) * LD + k];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = RT ? B[(c0 + j) * LD + k] : B[k * LD + c0 + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = dfma(a[i], b[j], acc[i][j]);
  }
}

// C[r][c] = epi(r, c, acc) for the micro-tile at (r0, c0)
template <typename T, int LD, int TM, int TN, typename Epi>
__device__ __forceinline__ void put(T* C, int r0, int c0,
                                    const T (&acc)[TM][TN], Epi epi) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      C[(r0 + i) * LD + c0 + j] = epi(r0 + i, c0 + j, acc[i][j]);
}

// values a pair: three S x LD buffers, padded so that the pairs of a warp
// start OFF words (mod 32) apart
template <int S, int LD, int OFF>
__host__ __device__ constexpr int pair_stride() {
  return NBUF * S * LD + ((OFF - NBUF * S * LD) % 32 + 32) % 32;
}

template <typename T, int S, int LD, int TM, int TN, int PPW, int WARPS,
          int OFF>
__global__ void __launch_bounds__(WARPS * 32)
di_pairs_kernel(const T* __restrict__ mJ, const T* __restrict__ Lsite,
                const int64_t* __restrict__ iu, const int64_t* __restrict__ ju,
                T* __restrict__ out, long long P, int s, long long Ns,
                long long row0, int iters) {
  constexpr int LC = S / TN;             // lane-grid columns
  constexpr int L = (S / TM) * LC;       // lanes a pair
  constexpr int SS = S * S;
  static_assert(S % 4 == 0 && S % TM == 0 && S % TN == 0, "tile");
  static_assert(L * PPW <= 32, "lanes");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane / L;
  const bool active = slot < PPW;        // lanes past L PPW only synchronize
  const int li = lane % L;
  long long p = ((long long)blockIdx.x * WARPS + warp) * PPW +
                (active ? slot : 0);
  const bool store = active && p < P;
  if (p >= P) p = P - 1;                 // a spare slot recomputes a pair

  T* base = reinterpret_cast<T*>(smem_raw) +
            (size_t)(warp * PPW + (active ? slot : 0)) *
                pair_stride<S, LD, OFF>();
  // three buffers; their roles rotate (the comments follow Y, Z and T)
  T* Yb = base;             // J, X = J Lj, G, Y
  T* Tb = base + S * LD;    // Lj, rho, scale partials, T, H
  T* Zb = base + 2 * S * LD;  // Li, Z
  const int r0 = (li / LC) * TM;
  const int c0 = (li % LC) * TN;
  T acc[TM][TN];

  const long long i = iu[p], j = ju[p];
  if (active) {
    for (int e = li; e < SS; e += L) {
      const int a = e / S, c = e % S;
      const bool in = a < s && c < s;
      Yb[a * LD + c] = in ? mJ[((i - row0) * s + a) * Ns + j * s + c] : T(0);
      Tb[a * LD + c] = in ? Lsite[(j * s + a) * s + c] : T(0);   // Lj
      Zb[a * LD + c] = in ? Lsite[(i * s + a) * s + c] : T(0);   // Li
    }
  }
  __syncwarp();

  auto plain = [](int, int, T v) { return v; };
  if (active) mm<T, S, LD, TM, TN, false, false>(Yb, Tb, r0, c0, acc);
  __syncwarp();                                             // X = J Lj
  if (active) put<T, LD, TM, TN>(Yb, r0, c0, acc, plain);
  __syncwarp();
  if (active) {                                             // rho = Li^T X
    mm<T, S, LD, TM, TN, true, false>(Zb, Yb, r0, c0, acc);
    put<T, LD, TM, TN>(Tb, r0, c0, acc, plain);
  }
  __syncwarp();
  if (active) {                                             // rho rho^T
    mm<T, S, LD, TM, TN, false, true>(Tb, Tb, r0, c0, acc);
    put<T, LD, TM, TN>(Yb, r0, c0, acc,                     // G (exactly
                       [](int r, int c, T v) {              // symmetric)
                         return T(4) * v + (r == c ? T(1) : T(0));
                       });
  }
  __syncwarp();

  // scale: the pair's lanes take G[r][r] and row r's absolute sum, r < s
  if (active) {
    for (int r = li; r < s; r += L) {
      T rabs = T(0);
      for (int k = 0; k < S; ++k) rabs += dabs(Yb[r * LD + k]);
      Tb[r] = Yb[r * LD + r];
      Tb[S + r] = rabs;
    }
  }
  __syncwarp();
  T tr = T(0), rmax = T(0);
  for (int r = 0; r < s; ++r) {
    tr += Tb[r];
    rmax = Tb[S + r] > rmax ? Tb[S + r] : rmax;
  }
  const T scale = tr < rmax ? tr : rmax;
  __syncwarp();

  if (active) {
    for (int e = li; e < SS; e += L) {
      const int r = e / S, c = e % S;
      const T y = Yb[r * LD + c] / scale;                    // Y0
      Yb[r * LD + c] = y;
      // step 1 has Z = I: T = 1.5 I - 0.5 Y0, into Z's buffer (Z <- T)
      Zb[r * LD + c] = (r == c ? T(1.5) : T(0)) - T(0.5) * y;
    }
  }
  __syncwarp();
  if (iters >= 1) {
    if (active) mm<T, S, LD, TM, TN, false, false>(Yb, Zb, r0, c0, acc);
    __syncwarp();                                            // Y T
    if (active) put<T, LD, TM, TN>(Yb, r0, c0, acc, plain);
    __syncwarp();
  }
  for (int it = 1; it < iters; ++it) {
    if (active) {
      mm<T, S, LD, TM, TN, false, false>(Zb, Yb, r0, c0, acc);  // T
      put<T, LD, TM, TN>(Tb, r0, c0, acc, [](int r, int c, T v) {
        return (r == c ? T(1.5) : T(0)) - T(0.5) * v;
      });
    }
    __syncwarp();
    if (active) mm<T, S, LD, TM, TN, false, false>(Yb, Tb, r0, c0, acc);
    __syncwarp();                                            // Y T
    if (active) put<T, LD, TM, TN>(Yb, r0, c0, acc, plain);
    __syncwarp();
    if (it == iters - 1) break;   // the last Z update feeds nothing
    if (active) mm<T, S, LD, TM, TN, false, false>(Tb, Zb, r0, c0, acc);
    __syncwarp();                                            // T Z
    if (active) put<T, LD, TM, TN>(Zb, r0, c0, acc, plain);
    __syncwarp();
  }

  // H = sym((Y sqrt(c) + I) / 2) into T's buffer
  const T sc = dsqrt(scale);
  if (active) {
    for (int e = li; e < SS; e += L) {
      const int r = e / S, c = e % S;
      const T d = (r == c ? T(1) : T(0));
      Tb[r * LD + c] = T(0.5) * (T(0.5) * (Yb[r * LD + c] * sc + d) +
                                 T(0.5) * (Yb[c * LD + r] * sc + d));
    }
  }
  __syncwarp();

  // column k is read by no later step, so it takes the multipliers
  // H[r][k] / pivot in place: s - k - 1 divisions a step, not (s - k - 1)^2;
  // a lane walks its trailing entries e = li, li + L, ... as (row, column)
  // offsets stepped by (L / n, L % n)
  T logdet = T(0);
  for (int k = 0; k < s; ++k) {
    const T hkk = Tb[k * LD + k];
    const T piv = hkk < T(0.1) ? T(0.1) : hkk;  // NaN stays NaN
    logdet += dlog(piv);
    const int n = s - k - 1;
    if (active)
      for (int r = k + 1 + li; r < s; r += L) Tb[r * LD + k] /= piv;
    __syncwarp();
    if (active && li < n * n) {
      const int dr = L / n, dc = L % n;
      int co = li % n;
      T* row = Tb + (k + 1 + li / n) * LD;
      const T* hk = Tb + k * LD + k + 1;
      for (int e = li; e < n * n; e += L) {
        row[k + 1 + co] -= row[k] * hk[co];
        co += dc;
        int down = dr;
        if (co >= n) {
          co -= n;
          ++down;
        }
        row += down * LD;
      }
    }
    __syncwarp();
  }
  if (store && li == 0) out[p] = T(0.5) * logdet;
}

template <typename T, int S, int LD, int TM, int TN, int PPW, int WARPS,
          int OFF>
int launch_s(const void* mJ, const void* Lsite, const void* iu,
             const void* ju, void* out, long long P, int s, long long Ns,
             long long row0, int iters, cudaStream_t stream) {
  auto kernel = di_pairs_kernel<T, S, LD, TM, TN, PPW, WARPS, OFF>;
  const size_t smem =
      (size_t)WARPS * PPW * pair_stride<S, LD, OFF>() * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per_block = (long long)WARPS * PPW;
  const long long blocks = (P + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned int)blocks, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(mJ), static_cast<const T*>(Lsite),
      static_cast<const int64_t*>(iu), static_cast<const int64_t*>(ju),
      static_cast<T*>(out), P, s, Ns, row0, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* mJ, const void* Lsite, const void* iu, const void* ju,
           void* out, long long P, int s, long long Ns, long long row0,
           int iters, void* stream) {
  if (P <= 0) return cudaSuccess;
  if (s < 1 || s > MAXS || iters < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define GDCA_DI_CASE(S, LD, TM, TN, PPW, WARPS, OFF)                        \
  case S:                                                                   \
    return launch_s<T, S, LD, TM, TN, PPW, WARPS, OFF>(                     \
        mJ, Lsite, iu, ju, out, P, s, Ns, row0, iters, st);
  switch ((s + 3) / 4 * 4) {
    //           S  LD TM TN PPW WARPS OFF
    GDCA_DI_CASE(4, 5, 2, 2, 8, 8, 4)
    GDCA_DI_CASE(8, 9, 2, 2, 2, 8, 1)
    GDCA_DI_CASE(12, 13, 4, 4, 3, 8, 1)
    GDCA_DI_CASE(16, 17, 4, 4, 2, 8, 16)
    GDCA_DI_CASE(20, 20, 5, 5, 2, 8, 16)
    GDCA_DI_CASE(24, 25, 6, 6, 2, 4, 1)
    GDCA_DI_CASE(28, 28, 7, 7, 2, 4, 16)
    GDCA_DI_CASE(32, 33, 8, 8, 2, 4, 4)
  }
#undef GDCA_DI_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// mJ: [rows s, Ns] row-major with Ns = N s, the rows of sites row0 ..
// row0 + rows - 1; Lsite: [N, s, s] row-major lower Cholesky factors of
// the diagonal blocks of C; iu, ju: [P] int64 site indices, iu in the
// slab's sites; out: [P]. Launches on `stream`, returns cudaGetLastError().
extern "C" int gdca_di_pairs_f32(const void* mJ, const void* Lsite,
                                 const void* iu, const void* ju, void* out,
                                 long long P, int s, long long Ns,
                                 long long row0, int iters, void* stream) {
  return launch<float>(mJ, Lsite, iu, ju, out, P, s, Ns, row0, iters, stream);
}

extern "C" int gdca_di_pairs_f64(const void* mJ, const void* Lsite,
                                 const void* iu, const void* ju, void* out,
                                 long long P, int s, long long Ns,
                                 long long row0, int iters, void* stream) {
  return launch<double>(mJ, Lsite, iu, ju, out, P, s, Ns, row0, iters,
                        stream);
}
