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
// Design. Per pair the work is ~(3 iters + 1) s x s matmuls (~0.34 MFLOP at
// s = 20, iters = 14) on 3 s^2 input values, so the kernel is bound by
// arithmetic and shared-memory loads, not by device memory. One warp owns
// one pair and keeps its s x s iterates in shared memory (5 buffers, at
// most 18 KB at s = 30 in f32). In a product C = A op(B) lane c < s owns
// output column c and holds column c of op(B) in registers, while A is
// read row by row as a broadcast (all lanes read the same word), so the
// shared-memory traffic is one conflict-free read per multiply-add. Any
// s from 1 to 30 runs through the same code (register arrays sized 30).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXS = 30;      // s = q - 1 <= 30 (q <= 31)
constexpr int WARPS = 4;      // pairs per block, one warp each
constexpr int NBUF = 5;       // s x s buffers per warp
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// C = A op(B) for s x s row-major matrices in shared memory, C distinct
// from A and B; C[r][c] = epi(r, c, sum_k A[r][k] op(B)[k][c]).
template <typename T, bool TRANS_B, typename Epi>
__device__ __forceinline__ void warp_mm(const T* A, const T* B, T* C, int s,
                                        int lane, Epi epi) {
  if (lane < s) {
    T b[MAXS];
#pragma unroll
    for (int k = 0; k < MAXS; ++k)
      if (k < s) b[k] = TRANS_B ? B[lane * s + k] : B[k * s + lane];
    for (int r = 0; r < s; ++r) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MAXS; ++k)
        if (k < s) acc = dfma(A[r * s + k], b[k], acc);
      C[r * s + lane] = epi(r, lane, acc);
    }
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
di_pairs_kernel(const T* __restrict__ mJ, const T* __restrict__ Lsite,
                const int64_t* __restrict__ iu, const int64_t* __restrict__ ju,
                T* __restrict__ out, long long P, int s, long long Ns,
                long long row0, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p = (long long)blockIdx.x * WARPS + warp;
  if (p >= P) return;  // warp-uniform: the whole warp leaves together

  const int s2 = s * s;
  T* buf[NBUF];
  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * NBUF * s2;
#pragma unroll
  for (int k = 0; k < NBUF; ++k) buf[k] = base + k * s2;

  const long long i = iu[p], j = ju[p];
  for (int e = lane; e < s2; e += 32) {
    const int a = e / s, c = e % s;
    buf[0][e] = mJ[((i - row0) * s + a) * Ns + j * s + c];   // J[a][c]
    buf[1][e] = Lsite[(i * s + c) * s + a];         // Li^T[a][c] = Li[c][a]
    buf[2][e] = Lsite[(j * s + a) * s + c];         // Lj[a][c]
  }
  __syncwarp();

  auto plain = [](int, int, T acc) { return acc; };
  auto ns_t = [](int r, int c, T acc) {
    return (r == c ? T(1.5) : T(0)) - T(0.5) * acc;   // 1.5 I - 0.5 Z Y
  };

  warp_mm<T, false>(buf[0], buf[2], buf[3], s, lane, plain);  // X = J Lj
  warp_mm<T, false>(buf[1], buf[3], buf[0], s, lane, plain);  // rho = Li^T X
  warp_mm<T, true>(buf[0], buf[0], buf[1], s, lane,           // G = 4 rho rho^T + I
                   [](int r, int c, T acc) {
                     return T(4) * acc + (r == c ? T(1) : T(0));
                   });

  // scale: lane c holds G[c][c] and the absolute sum of row c
  T tr = T(0), rabs = T(0);
  if (lane < s) {
    tr = buf[1][lane * s + lane];
    for (int k = 0; k < s; ++k) rabs += dabs(buf[1][lane * s + k]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    tr += __shfl_xor_sync(FULL, tr, o);
    const T other = __shfl_xor_sync(FULL, rabs, o);
    rabs = other > rabs ? other : rabs;
  }
  const T scale = tr < rabs ? tr : rabs;

  int iy = 2, iz = -1;
  for (int e = lane; e < s2; e += 32) buf[2][e] = buf[1][e] / scale;  // Y0
  __syncwarp();
  if (iters >= 1) {
    // step 1 has Z = I: T = 1.5 I - 0.5 Y, Y <- Y T, Z <- T
    for (int e = lane; e < s2; e += 32)
      buf[3][e] = (e / s == e % s ? T(1.5) : T(0)) - T(0.5) * buf[2][e];
    __syncwarp();
    warp_mm<T, false>(buf[2], buf[3], buf[4], s, lane, plain);
    iy = 4;
    iz = 3;
  }
  for (int it = 1; it < iters; ++it) {
    int f[3], nf = 0;
    for (int k = 0; k < NBUF; ++k)
      if (k != iy && k != iz) f[nf++] = k;
    warp_mm<T, false>(buf[iz], buf[iy], buf[f[0]], s, lane, ns_t);     // T
    warp_mm<T, false>(buf[iy], buf[f[0]], buf[f[1]], s, lane, plain);  // Y T
    if (it == iters - 1) {  // the last Z update feeds nothing
      iy = f[1];
      break;
    }
    warp_mm<T, false>(buf[f[0]], buf[iz], buf[f[2]], s, lane, plain);  // T Z
    iy = f[1];
    iz = f[2];
  }

  // H = sym((Y sqrt(c) + I) / 2), into a buffer other than Y
  T* Y = buf[iy];
  T* H = buf[iy == 0 ? 1 : 0];
  const T sc = dsqrt(scale);
  for (int e = lane; e < s2; e += 32)
    Y[e] = T(0.5) * (Y[e] * sc + (e / s == e % s ? T(1) : T(0)));
  __syncwarp();
  for (int e = lane; e < s2; e += 32) {
    const int r = e / s, c = e % s;
    H[e] = T(0.5) * (Y[r * s + c] + Y[c * s + r]);
  }
  __syncwarp();

  T acc = T(0);
  for (int k = 0; k < s; ++k) {
    const T hkk = H[k * s + k];
    const T piv = hkk < T(0.1) ? T(0.1) : hkk;  // NaN stays NaN
    acc += dlog(piv);
    for (int c = k + 1 + lane; c < s; c += 32)
      for (int r = k + 1; r < s; ++r)
        H[r * s + c] -= (H[r * s + k] / piv) * H[k * s + c];
    __syncwarp();
  }
  if (lane == 0) out[p] = T(0.5) * acc;
}

template <typename T>
int launch(const void* mJ, const void* Lsite, const void* iu, const void* ju,
           void* out, long long P, int s, long long Ns, long long row0,
           int iters, void* stream) {
  if (P <= 0) return cudaSuccess;
  if (s < 1 || s > MAXS || iters < 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * NBUF * s * s * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        di_pairs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (P + WARPS - 1) / WARPS;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  di_pairs_kernel<T><<<(unsigned int)blocks, WARPS * 32, smem,
                       (cudaStream_t)stream>>>(
      static_cast<const T*>(mJ), static_cast<const T*>(Lsite),
      static_cast<const int64_t*>(iu), static_cast<const int64_t*>(ju),
      static_cast<T*>(out), P, s, Ns, row0, iters);
  return (int)cudaGetLastError();
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
