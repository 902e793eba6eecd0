// Batched dense solve A X = B by Gauss-Jordan elimination with partial
// pivoting, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cadnip_tpu/ops/pallas_solve.py::_gj_kernel (the
// Pallas Gauss-Jordan solve inside every Newton iteration). Same algorithm
// (the elimination itself is in gj_core.cuh, shared with K2): for each pivot
// k, the row of largest |A[i,k]| over i >= k (lowest index on ties, as
// jax.lax.argmax), a row swap, elimination of column k from every other
// row; finally X = B / diag(A). It is not a tile-by-tile copy of the Pallas
// kernel: no lane padding to 128 and no identity pad rows.
//
// Two entries with one arithmetic, so they give the same bits:
//
// * gj_solve_warp_*: one warp per system, for n <= 32 and n + k <= 64,
//   the circuit-sized systems every path solves. WARPS systems per block,
//   the batch over the grid. A warp stages its system through shared memory
//   with coalesced loads (a system is 8-byte aligned only: at n = 19 it is
//   2888 bytes, so no TMA bulk copy), then holds row i in lane i's
//   registers: no block barrier at all. What bounds it: per pivot one warp
//   reduction for the pivot and n + k shuffles to broadcast the pivot row,
//   so the shuffle rate of the SM at a large batch and the chain of n
//   pivots' latencies for one system.
// * gj_solve_*: one thread block per system, the augmented block in shared
//   memory, four block barriers per pivot. It takes what the warp entry
//   does not: n > 32 or n + k > 64, up to one block's shared memory (about
//   n = 165 in f64 with k = 1).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, bound by ctypes)
// The elimination is written as an FMA; the plain PyTorch twin rounds the
// product first, so the two agree to rounding level, not bit for bit.

#include <cuda_runtime.h>

#include "gj_core.cuh"

namespace {

constexpr int WARPS = 4;   // systems per block of the warp entry

template <typename T>
__global__ void gj_kernel(const T* __restrict__ A, long long sab,
                          long long sar, long long sac,
                          const T* __restrict__ Bm, long long sbb,
                          long long sbr, long long sbc,
                          T* __restrict__ X, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  T* ab = reinterpret_cast<T*>(smem_raw);   // augmented block, [n][n + k]
  __shared__ gj::Scratch<T> scratch;

  const int m = n + k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const long long b = blockIdx.x;
  const T* Ab = A + b * sab;
  const T* Bb = Bm + b * sbb;

  for (int i = warp; i < n; i += nwarps) {
    for (int j = lane; j < m; j += 32) {
      ab[i * m + j] = j < n ? Ab[i * sar + j * sac]
                            : Bb[i * sbr + (j - n) * sbc];
    }
  }
  __syncthreads();
  gj::eliminate(ab, n, m, scratch);

  // ---- X = B-part / diag(A-part), contiguous [n][k] per system
  T* Xb = X + b * (long long)n * k;
  for (int i = warp; i < n; i += nwarps) {
    const T d = ab[i * m + i];
    for (int c = lane; c < k; c += 32) Xb[i * k + c] = ab[i * m + n + c] / d;
  }
}

// Row stride of a staged system: odd, so lanes reading one column of
// consecutive rows hit distinct banks.
__host__ __device__ inline int stage_ld(int m) { return m | 1; }

template <typename T, int MC>
__global__ void __launch_bounds__(WARPS * 32)
    gj_warp_kernel(const T* __restrict__ A, long long sab, long long sar,
                   long long sac, const T* __restrict__ Bm, long long sbb,
                   long long sbr, long long sbc, T* __restrict__ X,
                   long long batch, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  const int m = n + k, ld = stage_ld(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= batch) return;   // the ragged last block: whole warps retire
  T* st = reinterpret_cast<T*>(smem_raw) + (size_t)warp * n * ld;
  const T* Ab = A + b * sab;
  const T* Bb = Bm + b * sbb;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    st[i * ld + j] = Ab[i * sar + j * sac];
  }
  for (int e = lane; e < n * k; e += 32) {
    const int i = e / k, c = e - i * k;
    st[i * ld + n + c] = Bb[i * sbr + c * sbc];
  }
  __syncwarp();
  T a[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j)
    a[j] = (lane < n && j < m) ? st[lane * ld + j] : T(0);
  int r = lane;
  gj::eliminate_warp<T, MC>(a, r, n);
  if (lane >= n) return;
  const T d = gj::column(a, gj::rotated<MC>(r, n));
  T* Xr = X + b * (long long)n * k + (long long)r * k;
#pragma unroll
  for (int j = 0; j < MC; ++j)   // column n + j of the B part is in slot j
    if (j < k) Xr[j] = a[j] / d;
}

template <typename T>
int launch(const void* A, long long sab, long long sar, long long sac,
           const void* Bm, long long sbb, long long sbr, long long sbc,
           void* X, int batch, int n, int k, int threads, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  const size_t smem = sizeof(T) * (size_t)n * (size_t)(n + k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gj_kernel<T><<<batch, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(A), sab, sar, sac, static_cast<const T*>(Bm),
      sbb, sbr, sbc, static_cast<T*>(X), n, k);
  return (int)cudaGetLastError();
}

template <typename T, int MC>
int launch_warp_sized(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, int batch,
                      int n, int k, void* stream) {
  const size_t smem =
      sizeof(T) * (size_t)WARPS * (size_t)n * (size_t)stage_ld(n + k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gj_warp_kernel<T, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((batch + WARPS - 1) / WARPS);
  gj_warp_kernel<T, MC><<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(A), sab, sar, sac, static_cast<const T*>(Bm),
      sbb, sbr, sbc, static_cast<T*>(X), batch, n, k);
  return (int)cudaGetLastError();
}

// The column bound MC: n + k rounded up to 8.
template <typename T>
int launch_warp(const void* A, long long sab, long long sar, long long sac,
                const void* Bm, long long sbb, long long sbr, long long sbc,
                void* X, int batch, int n, int k, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  if (n > 32 || n + k > 64) return (int)cudaErrorInvalidValue;
#define GJ_WARP(MC)                                                      \
  case MC / 8:                                                           \
    return launch_warp_sized<T, MC>(A, sab, sar, sac, Bm, sbb, sbr, sbc, \
                                    X, batch, n, k, stream);
  switch ((n + k + 7) / 8) {
    GJ_WARP(8) GJ_WARP(16) GJ_WARP(24) GJ_WARP(32)
    GJ_WARP(40) GJ_WARP(48) GJ_WARP(56) GJ_WARP(64)
  }
#undef GJ_WARP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Pointers are device pointers; strides are in elements; stream is a
// cudaStream_t. Each returns the cudaError_t of the launch (0 on success).
int gj_solve_f64(const void* A, long long sab, long long sar, long long sac,
                 const void* Bm, long long sbb, long long sbr, long long sbc,
                 void* X, int batch, int n, int k, int threads,
                 void* stream) {
  return launch<double>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, batch, n, k,
                        threads, stream);
}

int gj_solve_f32(const void* A, long long sab, long long sar, long long sac,
                 const void* Bm, long long sbb, long long sbr, long long sbc,
                 void* X, int batch, int n, int k, int threads,
                 void* stream) {
  return launch<float>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, batch, n, k,
                       threads, stream);
}

// The warp entry: n <= 32 and n + k <= 64 (cudaErrorInvalidValue else).
int gj_solve_warp_f64(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, int batch,
                      int n, int k, void* stream) {
  return launch_warp<double>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, batch,
                             n, k, stream);
}

int gj_solve_warp_f32(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, int batch,
                      int n, int k, void* stream) {
  return launch_warp<float>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, batch,
                            n, k, stream);
}

}  // extern "C"
