// The blocked Gauss-Jordan elimination with partial pivoting on [A | B],
// panel by panel: the form of K1's block and grid variants (gj_solve.cu) and
// of K2's block solve (vmem_tran.cu, n > 32). Its plain twin is
// ops/gj_solve.py::gj_solve_blocked_plain (the same panel width, panel
// order and pivots).
//
// Rows stay in their slots: a row never moves in memory. Each slot carries
// the logical row index that the unblocked algorithm's swaps would give it
// (lg), so the pivot search (largest |a| among logical rows >= kk, NaN the
// largest, the lowest logical index on ties, as jax.lax.argmax) picks what
// gj_solve_plain picks, and the deferred swaps of the trailing columns cost
// nothing: the trailing update addresses the pivot rows by slot (ps[kk],
// the slot of step kk's pivot). For each panel J = [j0, j0 + nb), nb <= NB:
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
// Two homes for the work: `eliminate_smem`, the whole system in one block's
// shared memory (K1's block variant, K2), and the grid entry of
// gj_solve.cu, [A | B] in device memory with a team of blocks per system
// and the panel factored by one of them (`factor_panel`, shared by both).
// Deterministic: no atomics, every sum in a fixed order.
#pragma once

#include <cfloat>

#include <cuda_runtime.h>

#include "gj_core.cuh"

namespace gjb {

constexpr int NB = 16;           // panel width (PANEL of the twin)
constexpr int CW = 16;           // columns of a trailing tile

// A pivot candidate: its key, logical row and slot, its value v and the
// value's reciprocal r (computed before the reductions, so that the step
// that takes it as its pivot finds its reciprocal ready). The key orders
// as |v| (NaN above infinity): the magnitude's bits, NaN folded to one
// pattern, plus one in the high word for a row that takes part, so that
// any candidate beats none (key 0). The larger key wins, then the lower
// logical row: jax.lax.argmax's order, in integers.
template <typename T>
struct Cand {
  unsigned long long key;
  int lg;
  int slot;
  T v;
  T r;
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

template <typename T>
__device__ __forceinline__ Cand<T> no_cand(int n) {
  return Cand<T>{0ull, n, -1, T(0), T(0)};
}

template <typename T>
__device__ __forceinline__ void better(Cand<T>& a, T v, int lg, int slot) {
  const unsigned long long key = cand_key(v);
  if (key > a.key || (key == a.key && lg < a.lg)) {
    a.key = key;
    a.lg = lg;
    a.slot = slot;
    a.v = v;
  }
}

// The lane of the warp's best candidate: the largest high word of the key
// by one integer warp reduction; where lanes tie on it (rare but for lanes
// without a candidate), the low word, then the logical row.
template <typename T>
__device__ __forceinline__ int warp_winner(const Cand<T>& c) {
  const int lane = threadIdx.x & 31;
  const unsigned hi = static_cast<unsigned>(c.key >> 32);
  const unsigned lo = static_cast<unsigned>(c.key);
  const unsigned mhi = __reduce_max_sync(gj::FULL, hi);
  unsigned top = __ballot_sync(gj::FULL, hi == mhi);
  if (__popc(top) > 1) {
    const bool in = (top >> lane) & 1u;
    const unsigned mlo = __reduce_max_sync(gj::FULL, in ? lo : 0u);
    top = __ballot_sync(gj::FULL, in && lo == mlo);
    if (__popc(top) > 1) {
      const bool tied = (top >> lane) & 1u;
      const int mlg = __reduce_min_sync(gj::FULL, tied ? c.lg : 0x7fffffff);
      top = __ballot_sync(gj::FULL, tied && c.lg == mlg);
    }
  }
  return __ffs(top) - 1;
}

// The best of the k <= 32 per-warp winners in shared memory, in every lane
// of the calling warp: one candidate a lane, then the winner read again (a
// broadcast; a row remains at every step, so the winner is one of the k).
template <typename T>
__device__ __forceinline__ Cand<T> best_of(const Cand<T>* c, int k, int n) {
  const int lane = threadIdx.x & 31;
  const int src = warp_winner(lane < k ? c[lane] : no_cand<T>(n));
  return c[src < k ? src : k - 1];
}

// A barrier of the first `warps` warps of the block (named barrier 1), or
// of the whole block.
__device__ __forceinline__ void sync_warps(int warps, int all) {
  if (warps == all) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(warps * 32) : "memory");
  }
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
// c' < c of L(c, c') z[c'], c < nb, in order of c'. Without a branch, so
// that the loads of L overlap: z[c] for c >= nb comes back 0 whatever ldl
// returns there.
template <typename T, class LdL>
__device__ __forceinline__ void forward_subst(T (&z)[NB], int nb, LdL ldl) {
#pragma unroll
  for (int c = 1; c < NB; ++c) {
#pragma unroll
    for (int cp = 0; cp < c; ++cp) z[c] = fma(-ldl(c, cp), z[cp], z[c]);
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) z[c] = c < nb ? z[c] : T(0);
}

// 1 / v to an ulp (an infinity for 0: a singular system's output is not
// finite, as the other variants'). The correctly rounded reciprocal is a
// long sequence with a slow subroutine for zero, infinite, NaN, subnormal
// or huge operands, and zeros are common here (an MNA column below its
// pivot, a thread without a candidate): a normal operand takes the
// hardware's approximation and two Newton steps, the specials their exact
// results by selects, and only a subnormal or huge operand the rounded
// reciprocal.
__device__ __forceinline__ double reciprocal(double v) {
  const double a = fabs(v);
  const bool normal = a >= 0x1p-1021 && a <= 0x1p+1021;
  const double u = normal ? v : 1.0;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(u));
  r = fma(r, fma(-u, r, 1.0), r);
  r = fma(r, fma(-u, r, 1.0), r);
  // 0 -> +-inf, inf -> +-0, NaN -> NaN
  const double sp = a == 0.0 ? __longlong_as_double(0x7FF0000000000000ll)
                             : (a > DBL_MAX ? 0.0 : a);
  r = normal ? r : copysign(sp, v);
  if (!normal && a != 0.0 && a <= DBL_MAX) r = __drcp_rn(v);
  return r;
}
__device__ __forceinline__ float reciprocal(float v) {
  const float a = fabsf(v);
  const bool normal = a >= 0x1p-125f && a <= 0x1p+125f;
  const float u = normal ? v : 1.0f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(u));
  r = fmaf(r, fmaf(-u, r, 1.0f), r);
  const float sp = a == 0.0f ? __int_as_float(0x7F800000)
                             : (a > FLT_MAX ? 0.0f : a);
  r = normal ? r : copysignf(sp, v);
  if (!normal && a != 0.0f && a <= FLT_MAX) r = __frcp_rn(v);
  return r;
}

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

// Step (a) for panel [j0, j0 + nb) by one block of NTH threads: the pivot
// slot of step j0 + c into psl[c] (shared memory), and rec(kk, slot, pivot)
// called by thread 0 for every step kk (the grid entry publishes them to
// device memory for the other blocks). wc: two rounds of per-warp
// candidates. Every thread of the block calls it; it returns after a
// barrier. The factors are products with the pivot's reciprocal, which the
// candidate carries. Per step: one barrier of the warps that hold a slot,
// the best of their winners (a warp reduction), the rank-1 update of the
// panel's later columns, the slot's candidate for the next column and its
// reciprocal, the warp's winner (an integer warp reduction) written by its
// own lane. The panel's rows must be readable to column NB - 1 (past the
// panel's last column, where nb < NB; what is read there is not used).
template <int NTH, typename T, bool SM, class Rec>
__device__ void factor_panel(const Panel<T, SM>& P, int n, int j0, int nb,
                             int* psl, Rec rec, Cand<T> (*wc)[NTH / 32]) {
  constexpr int WARPS = NTH / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // on chip the warps that hold a slot take part (the others wait at the
  // closing barrier), in L2 all
  const int fw = SM ? min(WARPS, (n + 31) / 32) : WARPS, fth = fw * 32;
  if (warp < fw) {
    // the warp's best candidate into wc[round][warp], from its own lane;
    // the reciprocal after the reduction is issued, so that the two overlap
    auto publish = [&](Cand<T>& cd, int round) {
      const int src = warp_winner(cd);
      cd.r = reciprocal(cd.v);
      if (lane == src) wc[round][warp] = cd;
    };
    Cand<T> cd = no_cand<T>(n);
    for (int s = tid; s < n; s += fth) {
      const int l = P.lg[s];
      if (l >= j0) better(cd, P.get(s, 0), l, s);
    }
    publish(cd, 0);
    // on chip with a slot a thread (the block variant, and the grid's owner
    // up to its thread count), the slot's panel row lives in registers
    // through the panel: each step reads only the pivot row from shared
    // memory, and stores the slot's new values for a later step's pivot
    const bool one = SM && n <= fth;
    T row[NB];
    if (one && tid < n) {
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) row[jj] = P.get(tid, jj);
    }
    sync_warps(fw, WARPS);
#pragma unroll 1
    for (int c = 0; c < nb; ++c) {
      const int kk = j0 + c;
      const Cand<T> best = best_of(wc[c & 1], fw, n);
      const int sp = best.slot, pl = best.lg;
      const T rp = best.r;
      if (tid == 0) {
        psl[c] = sp;
        rec(kk, sp, best.v);
      }
      Cand<T> nx = no_cand<T>(n);
      if (one) {
        const int s = tid;
        if (s < n) {
          int l = P.lg[s];
          // the slot's columns c and c + 1 as it stored them (its
          // registers' values), the pivot row's; past the panel the reads
          // stay in the work area and are not written back
          const T a = P.get(s, c), an = P.get(s, c + 1);
          const T pn = P.get(sp, c + 1);
          T pv[NB];
#pragma unroll
          for (int jj = 0; jj < NB; ++jj) pv[jj] = P.get(sp, jj);
          if (s == sp) {
            P.lg[s] = kk;
          } else {
            if (l == kk) P.lg[s] = l = pl;   // the row at kk moves to pl
            const T f = a * rp;
            const T next = fma(-f, pn, an);
            if (c + 1 < nb && l > kk) better(nx, next, l, s);
#pragma unroll
            for (int jj = 0; jj < NB; ++jj) {
              row[jj] = fma(-f, pv[jj], row[jj]);
              if (jj > c && jj < nb) P.set(s, jj, row[jj]);
            }
            P.set(s, c, f);
          }
        }
      } else if constexpr (SM) {
        // several slots a thread (the grid's owner beyond its thread
        // count): each slot's later columns from shared memory, one after
        // another
        for (int s = tid; s < n; s += fth) {
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
          if (c + 1 < nb && l > kk) better(nx, P.get(s, c + 1), l, s);
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
            x[u] = (take[u] && col >= c && col < nb) ? P.get(sr[u], col)
                                                     : T(0);
          }
#pragma unroll
          for (int u = 0; u < LR; ++u) {
            const T f = __shfl_sync(gj::FULL, x[u], c, 16) * rp;
            T y = x[u];
            if (take[u] && col > c && col < nb)
              P.set(sr[u], col, y = fma(-f, pj, y));
            if (take[u] && col == c) P.set(sr[u], c, f);
            const T next =
                __shfl_sync(gj::FULL, y, c + 1 < 16 ? c + 1 : 15, 16);
            if (col == 0 && sr[u] < n) {
              if (sr[u] == sp) P.lg[sr[u]] = kk;
              else if (l[u] == kk) P.lg[sr[u]] = l[u] = pl;
              if (take[u] && c + 1 < nb && l[u] > kk)
                better(nx, next, l[u], sr[u]);
            }
          }
        }
      }
      publish(nx, (c + 1) & 1);
      sync_warps(fw, WARPS);
    }
  }
  __syncthreads();
}

// ---- the whole system in one block's shared memory -------------------------

// Row stride of a system in shared memory: odd, so that the panel's column
// accesses (a thread per slot, each step) reach distinct banks. The tensor
// core fragments then meet two-way conflicts at most.
__host__ __device__ constexpr int smem_ld(int m) { return m | 1; }

constexpr int ZPAD = 4;          // Z's row stride is zw + ZPAD (zw % 16 == 0)
constexpr int MAX_WARPS = 8;     // candidates reserved: up to 256 threads

// The work area of eliminate_smem beside the system, in shared memory:
// the candidates, Z of zw trailing columns ([NB][zw + ZPAD]), the pivots dg
// [n], the slots' logical indices lg [n] and the pivot slots ps [n]. Its
// bytes for n unknowns and zw columns of Z.
template <typename T>
__host__ __device__ constexpr size_t smem_work_bytes(int n, int zw) {
  return sizeof(Cand<T>) * 2 * MAX_WARPS +
         sizeof(T) * ((size_t)NB * (zw + ZPAD) + n) + sizeof(int) * 2 * n;
}

template <typename T>
struct SmemWork {
  Cand<T>* wc;
  T* zs;
  T* dg;
  int* lg;
  int* ps;
  int zw;
};

// The work area at `base` (8-byte aligned), laid out as smem_work_bytes
// counts it.
template <typename T>
__device__ __forceinline__ SmemWork<T> smem_work(void* base, int n, int zw) {
  SmemWork<T> w;
  w.wc = reinterpret_cast<Cand<T>*>(base);
  w.zs = reinterpret_cast<T*>(w.wc + 2 * MAX_WARPS);
  w.dg = w.zs + (size_t)NB * (zw + ZPAD);
  w.lg = reinterpret_cast<int*>(w.dg + n);
  w.ps = w.lg + n;
  w.zw = zw;
  return w;
}

// Z of the trailing columns [c0, c1) of panel [j0, j0 + nb) (pivot slots
// ps), by a block of NTH threads: a thread per column, forward
// substitution down the pivot rows, stored as -Z in zs[c][col - c0] (row
// stride zld), so that the product reads G as it is.
template <int NTH, typename T>
__device__ __forceinline__ void z_columns(const T* ab, int ld, const int* ps,
                                          int j0, int nb, int c0, int c1,
                                          T* zs, int zld) {
  for (int j = threadIdx.x; j < c1 - c0; j += NTH) {
    // the pivot rows, clamped to the panel's last (loads without a branch;
    // forward_subst zeroes z past it)
    int pc[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) pc[c] = ps[c < nb ? c : nb - 1] * ld;
    T z[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) z[c] = ab[pc[c] + c0 + j];
    // past the panel (c >= nb) L is read from the last pivot row, in the
    // work area, and its products are dropped
    forward_subst(z, nb, [&](int c, int cp) { return ab[pc[c] + j0 + cp]; });
#pragma unroll
    for (int c = 0; c < NB; ++c) zs[c * zld + j] = -z[c];
  }
}

// T -= G Z of panel [j0, j0 + nb) over every row and the columns [c0, c1)
// (Z's column c0 in zs column 0), by a block of NTH threads: tiles of
// RT x CT 8 x 8 tiles, each taken by one warp, on the tensor cores
// (rank_update).
template <int NTH, int RT, int CT, typename T>
__device__ __forceinline__ void product(T* ab, int ld, int n, int j0, int nb,
                                        int c0, int c1, const T* zs,
                                        int zld) {
  constexpr int TW = CT * 8;   // columns of a warp's tile
  const int ntl = (c1 - c0 + TW - 1) / TW, nrg = (n + 8 * RT - 1) / (8 * RT);
  for (int it = threadIdx.x >> 5; it < nrg * ntl; it += NTH / 32) {
    const int r0 = (it / ntl) * RT * 8, q = it - (it / ntl) * ntl;
    const int cq = c0 + q * TW, zq = q * TW;
    rank_update<RT, CT>(
        T(0),
        [&](int i, int rr, int c) -> T {
          const int row = r0 + i * 8 + rr;
          return (row < n && c < nb) ? ab[row * ld + j0 + c] : T(0);
        },
        // past Z's columns (a last tile wider than what is left) the reads
        // fall in the work area; those columns are not stored
        [&](int c, int j) -> T { return zs[c * zld + zq + j]; },
        [&](int i, int rr, int j, T& x0, T& x1) {
          const int row = r0 + i * 8 + rr, col = cq + j;
          const bool in = row < n;
          x0 = in && col < c1 ? ab[row * ld + col] : T(0);
          x1 = in && col + 1 < c1 ? ab[row * ld + col + 1] : T(0);
        },
        [&](int i, int rr, int j, T x0, T x1) {
          const int row = r0 + i * 8 + rr, col = cq + j;
          if (row >= n) return;
          if (col < c1) ab[row * ld + col] = x0;
          if (col + 1 < c1) ab[row * ld + col + 1] = x1;
        });
  }
}

// The blocked elimination of the n x n left part of ab ([n][ld] in shared
// memory, ld >= m = n + the right-hand sides, readable NB elements past
// its last row) by one block of NTH threads. Every thread of the block
// calls it, after a barrier that completes the writes of ab; it returns
// after a barrier, with the pivot slot of step j in w.ps[j], its pivot in
// w.dg[j] and X[j] = ab[w.ps[j]][n..] / w.dg[j]. The panel's columns end
// up holding G (dead after their panel). Per panel: the nb steps of
// factor_panel (one barrier each); then, zw trailing columns at a time, Z
// by forward substitution into w.zs, a barrier, the tensor-core product
// T -= G Z over every row, a barrier.
template <int NTH, typename T>
__device__ void eliminate_smem(T* ab, int n, int m, int ld,
                               const SmemWork<T>& w) {
  static_assert(NTH % 32 == 0 && NTH / 32 <= MAX_WARPS, "whole warps");
  constexpr int WARPS = NTH / 32;
  // a warp's tile of the product: RT 8-row tiles by CT 8-column tiles; the
  // larger tile reads shared memory half as often per product, with more
  // registers (a block of 256 threads has them)
  constexpr int RT = NTH >= 256 ? 4 : 2, CT = RT;
  const int tid = threadIdx.x;
  auto* wc = reinterpret_cast<Cand<T>(*)[WARPS]>(w.wc);
  const int zld = w.zw + ZPAD;
  for (int s = tid; s < n; s += NTH) w.lg[s] = s;
  __syncthreads();
  Panel<T, true> P{ab, ld, w.lg};
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int nb = min(NB, n - j0), j1 = j0 + nb;
    const int* ps = w.ps + j0;
    P.p = ab + j0;
    factor_panel<NTH>(P, n, j0, nb, w.ps + j0,
                      [&](int kk, int, T pv) { w.dg[kk] = pv; }, wc);
    // G zero at each pivot's own column (its diagonal is in dg); read by
    // the product only, after the next barrier
    if (tid < nb) ab[ps[tid] * ld + j0 + tid] = T(0);
#pragma unroll 1
    for (int c0 = j1; c0 < m; c0 += w.zw) {
      const int c1 = min(c0 + w.zw, m);
      z_columns<NTH>(ab, ld, ps, j0, nb, c0, c1, w.zs, zld);
      __syncthreads();
      product<NTH, RT, CT>(ab, ld, n, j0, nb, c0, c1, w.zs, zld);
      __syncthreads();
    }
  }
}

}  // namespace gjb
