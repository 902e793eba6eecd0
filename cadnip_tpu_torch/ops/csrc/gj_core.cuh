// Block-wide Gauss-Jordan elimination with partial pivoting on an augmented
// block [A | B] held in shared memory: the elimination of kernel K1
// (gj_solve.cu), shared with kernel K2 (vmem_tran.cu), which solves its
// equilibrated Newton system with it.
//
// For each pivot k: the row of largest |A[i,k]| over i >= k (lowest index on
// ties, NaN counts as the largest, as jax.lax.argmax), a row swap, then
// column k is eliminated from every other row, one warp per row with the
// pivot row read-only. Four block barriers per pivot. On return the block
// holds diag(A) on the left and the transformed B on the right: X = B / diag.
#pragma once

#include <cuda_runtime.h>

namespace gj {

// "v at row i" beats "best at row bi": larger magnitude, NaN counts as the
// largest (jax.lax.argmax semantics), lowest row index on ties.
template <typename T>
__device__ __forceinline__ bool beats(T v, int i, T best, int bi) {
  const bool vn = isnan(v), bn = isnan(best);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > best || (v == best && i < bi);
}

// Scratch the elimination needs besides the block: one slot per warp.
template <typename T>
struct Scratch {
  T red_v[32];
  int red_i[32];
  int piv_row;
};

// Eliminate the n x n left part of ab ([n][m] row-major, m >= n). Every
// thread of the block must call it, after a barrier that completes the
// writes of ab; it returns after a barrier.
template <typename T>
__device__ void eliminate(T* ab, int n, int m, Scratch<T>& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int kk = 0; kk < n; ++kk) {
    // ---- pivot: argmax |ab[i, kk]| over rows i >= kk
    T bv = T(-1);
    int bi = n;
    for (int i = kk + tid; i < n; i += blockDim.x) {
      const T v = fabs(ab[i * m + kk]);
      if (beats(v, i, bv, bi)) { bv = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { s.red_v[warp] = bv; s.red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s.red_v[lane] : T(-1);
      bi = lane < nwarps ? s.red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) s.piv_row = bi;
    }
    __syncthreads();

    // ---- swap rows kk and p
    const int p = s.piv_row;
    if (p != kk) {
      for (int j = tid; j < m; j += blockDim.x) {
        const T t = ab[kk * m + j];
        ab[kk * m + j] = ab[p * m + j];
        ab[p * m + j] = t;
      }
    }
    __syncthreads();

    // ---- eliminate column kk from every other row; the pivot row is only
    // read, so rows proceed independently, one warp per row
    const T piv = ab[kk * m + kk];
    for (int i = warp; i < n; i += nwarps) {
      if (i == kk) continue;
      const T f = ab[i * m + kk] / piv;
      __syncwarp();   // every lane holds f before column kk is overwritten
      for (int j = lane; j < m; j += 32) {
        ab[i * m + j] = ab[i * m + j] - f * ab[kk * m + j];
      }
    }
    __syncthreads();
  }
}

}  // namespace gj
