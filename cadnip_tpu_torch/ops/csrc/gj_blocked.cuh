// The blocked Gauss-Jordan elimination of K1's grid variant (gj_solve.cu):
// partial pivoting on [A | B], panel by panel, for the systems beyond one
// block's shared memory. Its plain twin is ops/gj_solve.py::
// gj_solve_blocked_plain (the same panel width, panel order and pivots).
//
// Rows stay in their slots: a row never moves in memory. Each slot carries
// the logical row index that the unblocked algorithm's swaps would give it
// (lg), so the pivot search (largest |a| among logical rows >= kk, the
// lowest logical index on ties, gj::beats) picks what gj_solve_plain picks,
// and the deferred swaps of the trailing columns cost nothing: the trailing
// update addresses the pivot rows by slot (ps[kk], the slot of step kk's
// pivot). For each panel J = [j0, j0 + nb), nb <= NB:
//
//   (a) panel: nb steps on the panel's columns only. Step kk: the pivot
//       slot sp, then every other slot s takes G[s] = a[s][kk] times the
//       pivot's reciprocal (kept in column kk) and the rank-1 update of the
//       panel's later columns; its logical index follows the swap. One
//       barrier per step: the pivot row is only read in its step, and each
//       slot's logical index is read and written only by the thread (or,
//       with the panel in L2, the half warp) that owns the slot.
//   (b) trailing update of every column c >= j0 + nb, [A | B] alike:
//       Z = (I + L)^-1 T_J, L[c][c'] = G[ps[j0 + c]][j0 + c'] (c' < c), the
//       pivot rows' trailing part T_J by forward substitution; then every
//       row, above the panel and below, T -= G Z, with G zero at each
//       pivot's own column (its diagonal is kept in dg). That product runs
//       on the f64 tensor cores (mma.sync m8n8k4 f64, sm_80 and later), in
//       f32 as FFMA (never TF32).
//   (c) X[j] = T[ps[j]][n..] / dg[j].
//
// Deterministic: no atomics, every sum in a fixed order.
#pragma once

#include <cuda_runtime.h>

#include "gj_core.cuh"

namespace gjb {

constexpr int NB = 16;           // panel width (PANEL of the twin)
constexpr int CW = 16;           // columns of a trailing tile

// A pivot candidate: its key, logical row and slot. The key orders as
// |v| (NaN above infinity, as gj::beats): the magnitude's bits, NaN folded
// to one pattern, plus one in the high word for a row that takes part, so
// that any candidate beats none (key 0). The larger key wins, then the
// lower logical row: gj::beats' order, in integers.
struct Cand {
  unsigned long long key;
  int lg;
  int slot;
};

__device__ __forceinline__ unsigned long long cand_key(double v) {
  const double a = fabs(v);
  return (isnan(a) ? 0x7FF8000000000000ull
                   : static_cast<unsigned long long>(__double_as_longlong(a))) +
         (1ull << 32);
}

__device__ __forceinline__ unsigned long long cand_key(float v) {
  const float a = fabsf(v);
  return (isnan(a) ? 0x7FC00000ull : (unsigned long long)__float_as_uint(a)) +
         1ull;
}

__device__ __forceinline__ Cand no_cand(int n) { return Cand{0ull, n, -1}; }

__device__ __forceinline__ void better(Cand& a, unsigned long long key, int lg,
                                       int slot) {
  if (key > a.key || (key == a.key && lg < a.lg)) {
    a.key = key;
    a.lg = lg;
    a.slot = slot;
  }
}

// The best candidate of the warp, in every lane: three integer warp
// reductions, a ballot and a shuffle.
__device__ __forceinline__ Cand warp_best(Cand c) {
  const unsigned hi = static_cast<unsigned>(c.key >> 32);
  const unsigned lo = static_cast<unsigned>(c.key);
  const unsigned mhi = __reduce_max_sync(gj::FULL, hi);
  const unsigned mlo = __reduce_max_sync(gj::FULL, hi == mhi ? lo : 0u);
  const bool top = hi == mhi && lo == mlo;
  const int mlg = __reduce_min_sync(gj::FULL, top ? c.lg : 0x7fffffff);
  const int src = __ffs(__ballot_sync(gj::FULL, top && c.lg == mlg)) - 1;
  return Cand{(static_cast<unsigned long long>(mhi) << 32) | mlo, mlg,
              __shfl_sync(gj::FULL, c.slot, src)};
}

// The best of k <= 32 candidates in shared memory, in every lane of the
// calling warp.
__device__ __forceinline__ Cand best_of(const Cand* c, int k, int n) {
  const int lane = threadIdx.x & 31;
  return warp_best(lane < k ? c[lane] : no_cand(n));
}

// d += a * b on the tensor cores for an 8 x 8 tile and a depth of 4: lane l
// holds a = A[l / 4][l % 4], b = B[l % 4][l / 4] and d = D[l / 4][2 (l % 4)
// + {0, 1}] (the m8n8k4 f64 fragments).
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};\n"
      : "=d"(d[0]), "=d"(d[1])
      : "d"(a), "d"(b), "d"(d[0]), "d"(d[1]));
}

// The rank-NB update of R 8-row tiles by NT 8-column tiles held by one
// warp: D[r][j] = C[r][j] + sum_c a(r, c) b(c, j) over c < NB, with
// a(r, c) = -G, b(c, j) = Z. The accessors take (tile, row in tile,
// column): lda and ldb return 0 out of range; ldc(i, r, j, x0, x1) loads
// the pair C[r][j], C[r][j + 1] (j even; 0 out of range) and stc stores it
// (skipping what is out of range). The C loads of all R tiles are issued
// first, so that their latencies overlap; A and B are read per depth step
// (from shared memory where the caller has them there). f64: the tensor
// cores, 4 steps of depth 4; f32: FFMA in the fragment layout, in column
// order.
template <int R, int NT, class LdA, class LdB, class LdC, class StC>
__device__ __forceinline__ void rank_update(double, LdA lda, LdB ldb,
                                            LdC ldc, StC stc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double acc[R][NT][2];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      ldc(i, g, q * 8 + 2 * t, acc[i][q][0], acc[i][q][1]);
#pragma unroll
  for (int s = 0; s < NB / 4; ++s) {
    double a[R], b[NT];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = lda(i, g, 4 * s + t);
#pragma unroll
    for (int q = 0; q < NT; ++q) b[q] = ldb(4 * s + t, q * 8 + g);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < NT; ++q) dmma(acc[i][q], a[i], b[q]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      stc(i, g, q * 8 + 2 * t, acc[i][q][0], acc[i][q][1]);
}

template <int R, int NT, class LdA, class LdB, class LdC, class StC>
__device__ __forceinline__ void rank_update(float, LdA lda, LdB ldb, LdC ldc,
                                            StC stc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[R][NT][2], a[R][NB];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int q = 0; q < NT; ++q)
      ldc(i, g, q * 8 + 2 * t, acc[i][q][0], acc[i][q][1]);
#pragma unroll
    for (int c = 0; c < NB; ++c) a[i][c] = lda(i, g, c);
  }
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = q * 8 + 2 * t + e;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const float bz = ldb(c, j);
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i][q][e] = fmaf(a[i][c], bz, acc[i][q][e]);
      }
    }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < NT; ++q)
      stc(i, g, q * 8 + 2 * t, acc[i][q][0], acc[i][q][1]);
}

// A pair of neighbouring elements through L2, as one 2-vector where the
// pair is aligned to it.
__device__ __forceinline__ void ldcg2(const double* p, double& a, double& b) {
  if (reinterpret_cast<size_t>(p) & 15) {
    a = __ldcg(p);
    b = __ldcg(p + 1);
  } else {
    const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
    a = v.x;
    b = v.y;
  }
}
__device__ __forceinline__ void ldcg2(const float* p, float& a, float& b) {
  if (reinterpret_cast<size_t>(p) & 7) {
    a = __ldcg(p);
    b = __ldcg(p + 1);
  } else {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    a = v.x;
    b = v.y;
  }
}
__device__ __forceinline__ void stcg2(double* p, double a, double b) {
  if (reinterpret_cast<size_t>(p) & 15) {
    __stcg(p, a);
    __stcg(p + 1, b);
  } else {
    __stcg(reinterpret_cast<double2*>(p), make_double2(a, b));
  }
}
__device__ __forceinline__ void stcg2(float* p, float a, float b) {
  if (reinterpret_cast<size_t>(p) & 7) {
    __stcg(p, a);
    __stcg(p + 1, b);
  } else {
    __stcg(reinterpret_cast<float2*>(p), make_float2(a, b));
  }
}

// Forward substitution of one column held in registers: z[c] -= sum over
// c' < c of L(c, c') z[c'], c < nb, in order of c'.
template <typename T, class LdL>
__device__ __forceinline__ void forward_subst(T (&z)[NB], int nb, LdL ldl) {
#pragma unroll
  for (int c = 1; c < NB; ++c) {
    if (c < nb) {
#pragma unroll
      for (int cp = 0; cp < c; ++cp) z[c] = fma(-ldl(c, cp), z[cp], z[c]);
    }
  }
}

// 1 / v, correctly rounded (an infinity for 0: a singular system's
// output is not finite, as the other variants').
__device__ __forceinline__ double reciprocal(double v) { return __drcp_rn(v); }
__device__ __forceinline__ float reciprocal(float v) { return __frcp_rn(v); }

// ---- the grid entry's panel ------------------------------------------------

// Where the panel owner keeps the panel's columns: in shared memory (SM,
// the panel copied in with row stride ld) or, for systems whose panel does
// not fit there, in place in the work area through L2 (p the panel's first
// column, ld = the work area's row stride). The slots' logical indices lg
// are in shared memory either way.
template <typename T, bool SM>
struct Panel {
  T* p;
  int ld;
  int* lg;
  __device__ __forceinline__ T get(int s, int c) const {
    if (SM) return p[(size_t)s * ld + c];
    return __ldcg(p + (long long)s * ld + c);
  }
  __device__ __forceinline__ void set(int s, int c, T v) const {
    if (SM) p[(size_t)s * ld + c] = v;
    else __stcg(p + (long long)s * ld + c, v);
  }
};

// Step (a) for panel [j0, j0 + nb) by one block of NTH threads: pivot
// slots into ps[j0..] and the pivots into dg[j0..] (device memory, for the
// other blocks), and into psl[0..nb) (shared). wc: two rounds of per-warp
// candidates. Every thread of the block calls it; it returns after a
// barrier. The factors are products with the pivot's reciprocal. Per
// step: one barrier, the block's best of its warps' candidates (integer
// warp reductions), the rank-1 update of the panel's later columns.
template <int NTH, typename T, bool SM>
__device__ void factor_panel(const Panel<T, SM>& P, int n, int j0, int nb,
                             int* ps, T* dg, int* psl, Cand (*wc)[NTH / 32]) {
  constexpr int WARPS = NTH / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Cand cd = no_cand(n);
  for (int s = tid; s < n; s += NTH) {
    const int l = P.lg[s];
    if (l >= j0) better(cd, cand_key(P.get(s, 0)), l, s);
  }
  cd = warp_best(cd);
  if (lane == 0) wc[0][warp] = cd;
  __syncthreads();
#pragma unroll 1
  for (int c = 0; c < nb; ++c) {
    const int kk = j0 + c;
    const Cand best = best_of(wc[c & 1], WARPS, n);
    const int sp = best.slot, pl = best.lg;
    const T pv = P.get(sp, c), rp = reciprocal(pv);
    if (tid == 0) {
      psl[c] = sp;
      __stcg(ps + kk, sp);
      __stcg(dg + kk, pv);
    }
    Cand nx = no_cand(n);
    if constexpr (SM) {
      for (int s = tid; s < n; s += NTH) {
        int l = P.lg[s];
        if (s == sp) {
          P.lg[s] = kk;
          continue;
        }
        if (l == kk) P.lg[s] = l = pl;   // the row at kk moves to pl
        const T f = P.get(s, c) * rp;
#pragma unroll 4
        for (int jj = c + 1; jj < nb; ++jj)
          P.set(s, jj, fma(-f, P.get(sp, jj), P.get(s, jj)));
        P.set(s, c, f);
        if (c + 1 < nb && l > kk)
          better(nx, cand_key(P.get(s, c + 1)), l, s);
      }
    } else {
      // in L2: half a warp per row, a lane per panel column, so that a
      // row's segment is one coalesced access; LR rows' loads at once
      constexpr int LR = 4;
      const int h = lane >> 4, col = lane & 15;
      const T pj = (col > c && col < nb) ? P.get(sp, col) : T(0);
      for (int g = 2 * warp; g < n; g += 2 * WARPS * LR) {
        int sr[LR], l[LR];
        bool take[LR];
        T x[LR];
#pragma unroll
        for (int u = 0; u < LR; ++u) {
          sr[u] = g + u * 2 * WARPS + h;
          const bool in = sr[u] < n;
          l[u] = in ? P.lg[sr[u]] : -1;
          take[u] = in && sr[u] != sp;
          x[u] = (take[u] && col >= c && col < nb) ? P.get(sr[u], col) : T(0);
        }
#pragma unroll
        for (int u = 0; u < LR; ++u) {
          const T f = __shfl_sync(gj::FULL, x[u], c, 16) * rp;
          T y = x[u];
          if (take[u] && col > c && col < nb) P.set(sr[u], col, y = fma(-f, pj, y));
          if (take[u] && col == c) P.set(sr[u], c, f);
          const T next = __shfl_sync(gj::FULL, y, c + 1 < 16 ? c + 1 : 15, 16);
          if (col == 0 && sr[u] < n) {
            if (sr[u] == sp) P.lg[sr[u]] = kk;
            else if (l[u] == kk) P.lg[sr[u]] = l[u] = pl;
            if (take[u] && c + 1 < nb && l[u] > kk)
              better(nx, cand_key(next), l[u], sr[u]);
          }
        }
      }
    }
    nx = warp_best(nx);
    if (lane == 0) wc[(c + 1) & 1][warp] = nx;
    __syncthreads();
  }
}

}  // namespace gjb
