// Batched dense solve A X = B by Gauss-Jordan elimination with partial
// pivoting, one thread block per system, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cadnip_tpu/ops/pallas_solve.py::_gj_kernel (the
// Pallas Gauss-Jordan solve inside every Newton iteration). Same algorithm
// (the elimination itself is gj::eliminate in gj_core.cuh, shared with K2):
// for each pivot k, the row of largest |A[i,k]| over i >= k (lowest index on
// ties, as jax.lax.argmax), a row swap, elimination of column k from every
// other row; finally X = B / diag(A). It is not a tile-by-tile copy of the
// Pallas kernel: no lane padding to 128 and no identity pad rows.
//
// What bounds it on the card: a single circuit-sized system (n = 19) is
// bound by latency -- n sequential pivots, each a block-wide argmax and two
// barriers, plus the launch. A large batch (4096 systems) is bound by
// shared-memory traffic, n * n * (n + k) reads and writes per system. The
// design keeps the whole augmented block [A | B] in shared memory from the
// first load to the last store, so device memory is touched once in each
// direction, and the batch maps onto the grid so independent systems fill
// the SMs.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, bound by ctypes)
// nvcc contracts a - f * b into an FMA; the plain PyTorch twin does not, so
// the two agree to rounding level, not bit for bit.

#include <cuda_runtime.h>

#include "gj_core.cuh"

namespace {

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

}  // namespace

extern "C" {

// Pointers are device pointers; strides are in elements; stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
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

}  // extern "C"
