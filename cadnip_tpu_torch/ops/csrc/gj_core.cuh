// The warp form of the Gauss-Jordan elimination with partial pivoting on
// an augmented block [A | B]: the elimination of K1's warp variant
// (gj_solve.cu) and of K2's warp solve (vmem_tran.cu, n <= 32). The systems
// above 32 unknowns take the blocked form of gj_blocked.cuh.
//
// For each pivot k: the row of largest |A[i,k]| over i >= k (lowest index
// on ties, NaN counts as the largest, as jax.lax.argmax), a row swap, then
// for every other row i a[i][j] <- fma(-f_i, a[k][j], a[i][j]) with
// f_i = a[i][k] / a[k][k], over every column j. On return diag(A) is on the
// left and the transformed B on the right: X = B / diag.
//
// `eliminate_warp`: one warp, the block in registers, no block barrier.
// Lane i holds row i (n <= 32), so the pivot's factor is in-lane and the
// pivot search is one warp reduction; the swap is bookkeeping (each lane
// carries the logical index of the row it holds), and each pivot
// broadcasts its row to the warp by shuffles. The column bound is
// compile-time, so the row stays in registers.
#pragma once

#include <cuda_runtime.h>

namespace gj {

constexpr unsigned FULL = 0xffffffffu;

// The logical row of the pivot among the lanes that take part: the largest
// |v|, NaN the largest, the lowest logical row r on ties. Magnitudes order
// as their bit patterns (NaN folded to one pattern above infinity); a
// taking lane adds 1 to the high word, so it beats every other lane. Three
// warp reductions without a branch, so that they overlap other work.
__device__ __forceinline__ int pivot_row(double v, bool take, int r) {
  const double a = fabs(v);
  const unsigned long long key =
      isnan(a) ? 0x7FF8000000000000ull
               : static_cast<unsigned long long>(__double_as_longlong(a));
  const unsigned hi = take ? static_cast<unsigned>(key >> 32) + 1u : 0u;
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned mhi = __reduce_max_sync(FULL, hi);
  const unsigned mlo = __reduce_max_sync(FULL, hi == mhi ? lo : 0u);
  return __reduce_min_sync(FULL, hi == mhi && lo == mlo ? r : 0x7fffffff);
}

__device__ __forceinline__ int pivot_row(float v, bool take, int r) {
  const float a = fabsf(v);
  const unsigned key = isnan(a) ? 0x7FC00000u : __float_as_uint(a);
  const unsigned k1 = take ? key + 1u : 0u;
  const unsigned mk = __reduce_max_sync(FULL, k1);
  return __reduce_min_sync(FULL, k1 == mk ? r : 0x7fffffff);
}

// The bits of a value and back, for the exact selects below.
__device__ __forceinline__ unsigned long long to_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ double from_bits(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}
__device__ __forceinline__ float from_bits(unsigned b) {
  return __uint_as_float(b);
}

// Column c of a lane's row, for a runtime c < MC: the masked bit patterns
// OR-ed in a tree, so the row stays in registers and the select is a few
// levels deep rather than a chain of MC.
template <typename T, int MC>
__device__ __forceinline__ T column(const T (&a)[MC], int c) {
  decltype(to_bits(a[0])) b[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) b[j] = j == c ? to_bits(a[j]) : 0;
#pragma unroll
  for (int s = 1; s < MC; s *= 2) {
#pragma unroll
    for (int j = 0; j + s < MC; j += 2 * s) b[j] |= b[j + s];
  }
  return from_bits(b[0]);
}

// num / den, exactly as IEEE division, for a lane that needs it (`use`).
// The division's fast path hands a zero or tiny numerator to a slow
// subroutine, and one such lane stalls its whole warp; an MNA matrix has
// many zeros. So a zero numerator over a nonzero, non-NaN denominator takes
// its signed zero directly, and a lane that does not use the quotient
// divides den by itself.
template <typename T>
__device__ __forceinline__ T quotient(T num, T den, bool use) {
  const bool zero = num == T(0) && den == den && den != T(0);
  const T q = (use && !zero) ? num : den;
  const T f = q / den;
  // the signed zero: num is +-0, so its bits are its sign
  const auto bn = to_bits(num), bd = to_bits(den);
  const decltype(bn) sign = ~(~decltype(bn)(0) >> 1);
  return zero ? from_bits((bn ^ bd) & sign) : f;
}

// Eliminate the n x n left part of an [n][m] block held one row per lane:
// lane i < n holds row i in a[0..m) (n <= 32, m <= MC, MC a multiple of 8;
// the columns from m to MC hold zeros, and are updated but never read).
// Every lane of the warp calls it; r is the logical row the lane holds,
// its own lane index on entry, the row's place after the swaps on return.
//
// Each pivot rotates the row left by one slot, so pivot kk's column is
// always a[0] and every register index is static while the pivot loop stays
// a loop (its body is a few hundred instructions, which the instruction
// cache holds). On return column c is in slot rotated(c, n) =
// (c - n) mod MC: the B part [n, m) in slots 0 .. m - n - 1. The column
// loop is straight-line, eight shuffles then eight FMAs, so that the
// shuffles' latencies overlap.
template <typename T, int MC>
__device__ __forceinline__ void eliminate_warp(T (&a)[MC], int& r, int n) {
  static_assert(MC % 8 == 0, "columns in groups of eight");
  const int lane = threadIdx.x & 31;
  const bool live = lane < n;
  // the pivot search of the next column runs between the update of that
  // column (the first group) and the rest of the row, so its reductions
  // overlap the shuffles of the other groups
  int p = pivot_row(a[0], live, r);
#pragma unroll 1
  for (int kk = 0; kk < n; ++kk) {
    // the swap of rows kk and p: the two lanes trade logical indices
    const int lp = __ffs(__ballot_sync(FULL, r == p)) - 1;
    const int lk = __ffs(__ballot_sync(FULL, r == kk)) - 1;
    if (lane == lp) r = kk;
    else if (lane == lk) r = p;
    // broadcast the pivot row from lane lp and eliminate column kk
    const T akk = a[0];
    const T piv = __shfl_sync(FULL, akk, lp);
    const bool upd = live && lane != lp;
    const T f = quotient(akk, piv, upd);
#pragma unroll
    for (int j0 = 0; j0 < MC; j0 += 8) {
      T pr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) pr[j] = __shfl_sync(FULL, a[j0 + j], lp);
      if (upd) {
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j0 + j] = fma(-f, pr[j], a[j0 + j]);
      }
      // column kk + 1 is a[1]; after the last pivot the search is unused
      if (j0 == 0) p = pivot_row(a[1], live && r > kk, r);
    }
    const T first = a[0];
#pragma unroll
    for (int j = 0; j + 1 < MC; ++j) a[j] = a[j + 1];
    a[MC - 1] = first;
  }
}

// The slot of column c after eliminate_warp of n < MC pivots.
template <int MC>
__device__ __forceinline__ int rotated(int c, int n) {
  return (c - n + MC) % MC;
}

}  // namespace gj
