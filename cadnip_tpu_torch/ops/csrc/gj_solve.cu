// Batched dense solve A X = B by Gauss-Jordan elimination with partial
// pivoting, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cadnip_tpu/ops/pallas_solve.py::_gj_kernel (the
// Pallas Gauss-Jordan solve inside every Newton iteration). Same algorithm:
// for each pivot k, the row of largest |A[i,k]| over i >= k (lowest index
// on ties, as jax.lax.argmax), a row swap, elimination of column k from
// every other row; finally X = B / diag(A). It is not a tile-by-tile copy
// of the Pallas kernel: no lane padding to 128 and no identity pad rows.
//
// Three variants, in two forms: the warp form of gj_core.cuh (shared with
// K2's warp solve) and the blocked form of gj_blocked.cuh (panels of NB =
// 16 columns, shared with K2's block solve). All take the same pivots; the
// blocked form's X agrees with the warp form's to rounding, not bit for
// bit (a blocked product sums in another order).
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
// * gj_solve_*: the block variant, one thread block per system (the plan:
//   64 to 256 threads by n; as many systems per SM as shared memory and
//   threads allow), [A | B] in shared memory, up to what one block holds
//   (n = 167 in f64 with k = 1), by gjb::eliminate_smem: per panel, the
//   panel's pivot chain with one block barrier per pivot (rows never move,
//   the factors are products with the pivot's reciprocal), then the
//   trailing update T -= G Z over every row on the f64 tensor cores from
//   shared memory (mma.sync m8n8k4; FFMA in f32). It takes the systems the
//   warp entry does not (n > 32 or n + k > 64): the AC and noise sweeps of
//   the DFF-sized circuits ([801, 38, 39]), the nested BBD level's block
//   solves ([10, 104, 190]). What bounds it: the n-step pivot chain (a
//   barrier, two warp reductions and a reciprocal per pivot), not the
//   bytes or the 2n^3/3 operations of the bound.
// * gj_solve_grid_*: the systems that one block's shared memory does not
//   hold, and small batches of wide systems where it measured faster
//   (ops/gj_solve.py::variant), by the same blocked Gauss-Jordan with [A |
//   B] in device memory. It replaces the large-n use of the TPU kernel
//   (method gjpl32ir, cadnip_tpu/ops/linalg.py:138-142, 170-176, whose VMEM
//   held systems up to n = 1024), and takes the Schur complement of the
//   block-bordered-diagonal solve, the AC and noise sweeps of circuits above
//   about 84 unknowns and tran_pit's window systems above n = 120.
//   Gauss-Jordan rather than a blocked LU with two triangular solves: it
//   keeps the pivots and the one- pass form of the other variants and of the
//   JAX kernel, and its trailing update is one product over all rows. One
//   launch per call, cooperative: a team of co-resident blocks per system
//   (one block per system in rounds where the batch covers the card), [A |
//   B] in device memory (L2 holds it: n = 1536, k = 1 is 18.9 MB of the 50
//   MB). The n-step pivot chain, which partial pivoting needs, stays inside
//   one SM: the team's owner block factors each [n, 16] panel in its shared
//   memory with one block barrier per pivot (rows never move: each slot
//   carries its logical row, so the deferred swaps cost nothing). The O(n^3)
//   work is the trailing update, T -= G Z over every row and trailing
//   column, on the f64 tensor cores (mma.sync m8n8k4; FFMA in f32), tiled
//   over the team's blocks, the panel's G staged once per block. Barriers:
//   one team barrier per panel, with look-ahead (the owner updates and
//   factors panel p + 1 while the others apply panel p), n / 16 + 3 per
//   solve instead of the 2n of the unblocked grid kernel; the matrix goes
//   through L2 once per panel instead of once per pivot. What bounds it now:
//   the pivot chain's latency at b = 1 (a few thousand cycles per pivot in
//   the owner block), not the 2n^3/3 operations of the bound. A batch of
//   mid-size systems (the ladder's AC sweep, [801, 254, 255]) takes one
//   block per system in rounds, not a thread-block cluster per system: a
//   cluster entry, each system in the cluster's distributed shared memory
//   with one cluster barrier per pivot, measured 1.9-3.0x slower on the H100
//   (PERF.md).
//
// * gj_rule_warp_* and gj_rule_*: K1's derivative rules (ops/gj_solve.py::
//   GJSolve), one launch each, in the warp and the block form. The tangent
//   (mode 1) forms R = dB - dA X while it stages the right-hand side (the
//   warp form one element per lane in shared memory, the block form one per
//   thread), then eliminates [A | R] and writes dX. The adjoint (mode 2)
//   reads A by the transposed strides the caller passes (no copy of A^T),
//   solves A^T gB = gX, writes gB and, in its epilogue, gA = -gB X^T from
//   gB in shared memory. The grid variant's rules form R and gA with torch
//   products around its solve (ops/gj_solve.py). What bounds them is the
//   solve's: R and gA add n^2 k multiply-adds per system, and n^2 outputs
//   (gA) beside the solve's n k.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, bound by ctypes)
// The elimination is written as an FMA; the plain PyTorch twins round the
// product first, so kernel and twin agree to rounding level, not bit for
// bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gj_blocked.cuh"

namespace {

constexpr int WARPS = 4;   // systems per block of the warp entry

// The derivative rules' modes (ops/gj_solve.py: TANGENT, ADJOINT).
enum RuleMode { SOLVE = 0, TANGENT = 1, ADJOINT = 2 };

// A rule's operands beside [A | B]: the forward solution X [n][k] of each
// system and, for the tangent, A's tangent dA [n][n] (strides in elements,
// batch first); for the adjoint, gA [n][n] per system, contiguous, or null
// where A's cotangent is not wanted. The tangent's B is dB, which may be
// null (no tangent of B); the adjoint's B is gX and its A comes by A's
// transposed strides.
template <typename T>
struct Rule {
  int mode;
  const T* X;
  long long sxb, sxr, sxc;
  const T* dA;
  long long sdb, sdr, sdc;
  T* gA;
};

// The tangent's right-hand side of system b, element (i, c):
// dB[i][c] - sum_j dA[i][j] X[j][c], the sum in order j = 0, 1, ... as
// fused multiply-adds.
template <typename T>
__device__ __forceinline__ T tangent_rhs(const Rule<T>& rule, long long b,
                                         const T* Bb, long long sbr,
                                         long long sbc, int n, int i, int c) {
  T v = Bb != nullptr ? Bb[i * sbr + c * sbc] : T(0);
  const T* dAi = rule.dA + b * rule.sdb + i * rule.sdr;
  const T* Xc = rule.X + b * rule.sxb + c * rule.sxc;
  for (int j = 0; j < n; ++j) v = fma(-dAi[j * rule.sdc], Xc[j * rule.sxr], v);
  return v;
}

// The adjoint's epilogue for system b: gA[i][j] = -sum_c gB[i][c] X[j][c],
// gB[i][c] at gb[gslot(i) * ld + c] (shared memory), over threads
// t0, t0 + nt, ... of the caller; row-major, so the writes coalesce.
template <typename T, typename Slot>
__device__ __forceinline__ void adjoint_ga(const Rule<T>& rule, long long b,
                                           const T* gb, int ld, Slot gslot,
                                           int n, int k, int t0, int nt) {
  T* gAb = rule.gA + b * (long long)n * n;
  const T* Xb = rule.X + b * rule.sxb;
  for (int e = t0; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    const T* g = gb + gslot(i) * ld;
    T s = T(0);
    for (int c = 0; c < k; ++c) s = fma(g[c], Xb[j * rule.sxr + c * rule.sxc], s);
    gAb[e] = -s;
  }
}

// The block variant: one block of NTH threads per system, the batch over
// the grid; the system [n][ld] (ld = gjb::smem_ld(n + k)) and the work
// area of gjb::eliminate_smem in dynamic shared memory, the work area
// first. Below 256 threads, registers for 512 threads an SM at least, so
// that a batch's systems share an SM.
template <typename T, int NTH, bool RULE>
__global__ void __launch_bounds__(NTH, NTH < 256 ? 512 / NTH : 1)
    gj_block_kernel(const T* __restrict__ A, long long sab, long long sar,
                    long long sac, const T* __restrict__ Bm, long long sbb,
                    long long sbr, long long sbc, T* __restrict__ X, int n,
                    int k, int zw, Rule<T> rule) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = n + k, ld = gjb::smem_ld(m);
  const gjb::SmemWork<T> w = gjb::smem_work<T>(smem_raw, n, zw);
  T* ab = reinterpret_cast<T*>(smem_raw + gjb::smem_work_bytes<T>(n, zw));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const T* Ab = A + b * sab;
  const T* Bb = Bm == nullptr ? nullptr : Bm + b * sbb;
  const bool tangent = RULE && rule.mode == TANGENT;
  for (int i = warp; i < n; i += NTH / 32) {
    for (int j = lane; j < (tangent ? n : m); j += 32) {
      ab[i * ld + j] = j < n ? Ab[i * sar + j * sac]
                             : Bb[i * sbr + (j - n) * sbc];
    }
  }
  if (tangent) {
    // R = dB - dA X, one element per thread
    for (int e = tid; e < n * k; e += NTH) {
      const int i = e / k, c = e - i * k;
      ab[i * ld + n + c] = tangent_rhs(rule, b, Bb, sbr, sbc, n, i, c);
    }
  }
  __syncthreads();
  gjb::eliminate_smem<NTH>(ab, n, m, ld, w);
  // X[j] = the B part of step j's pivot row / its pivot, [n][k] per system
  T* Xb = X + b * (long long)n * k;
  const bool ga = RULE && rule.mode == ADJOINT && rule.gA != nullptr;
  for (int j = warp; j < n; j += NTH / 32) {
    T* row = ab + w.ps[j] * ld + n;
    const T d = w.dg[j];
    for (int c = lane; c < k; c += 32) {
      const T q = row[c] / d;
      Xb[j * k + c] = q;
      if (ga) row[c] = q;   // gB in place, for gA
    }
  }
  if (ga) {
    __syncthreads();
    adjoint_ga(rule, b, ab + n, ld, [&](int i) { return w.ps[i]; }, n, k, tid,
               NTH);
  }
}

// Row stride of a staged system: odd, so lanes reading one column of
// consecutive rows hit distinct banks.
__host__ __device__ inline int stage_ld(int m) { return m | 1; }

template <typename T, int MC, bool RULE>
__global__ void __launch_bounds__(WARPS * 32)
    gj_warp_kernel(const T* __restrict__ A, long long sab, long long sar,
                   long long sac, const T* __restrict__ Bm, long long sbb,
                   long long sbr, long long sbc, T* __restrict__ X,
                   long long batch, int n, int k, Rule<T> rule) {
  extern __shared__ unsigned char smem_raw[];
  const int m = n + k, ld = stage_ld(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= batch) return;   // the ragged last block: whole warps retire
  T* st = reinterpret_cast<T*>(smem_raw) + (size_t)warp * n * ld;
  const T* Ab = A + b * sab;
  const T* Bb = Bm == nullptr ? nullptr : Bm + b * sbb;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    st[i * ld + j] = Ab[i * sar + j * sac];
  }
  for (int e = lane; e < n * k; e += 32) {
    const int i = e / k, c = e - i * k;
    st[i * ld + n + c] =
        RULE && rule.mode == TANGENT
            ? tangent_rhs(rule, b, Bb, sbr, sbc, n, i, c)
            : Bb[i * sbr + c * sbc];
  }
  __syncwarp();
  T a[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j)
    a[j] = (lane < n && j < m) ? st[lane * ld + j] : T(0);
  int r = lane;
  gj::eliminate_warp<T, MC>(a, r, n);
  const bool ga = RULE && rule.mode == ADJOINT && rule.gA != nullptr;
  if (lane < n) {
    const T d = gj::column(a, gj::rotated<MC>(r, n));
    T* Xr = X + b * (long long)n * k + (long long)r * k;
    // column n + j of the B part is in slot j; gB's row r to the staging
    // area (read before the elimination) for gA
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      if (j < k) {
        const T q = a[j] / d;
        Xr[j] = q;
        if (ga) st[r * ld + j] = q;
      }
    }
  }
  if (ga) {
    __syncwarp();
    adjoint_ga(rule, b, st, ld, [](int i) { return i; }, n, k, lane, 32);
  }
}

template <typename T, bool RULE>
const void* block_kernel(int threads) {
  switch (threads) {
    case 64: return (const void*)gj_block_kernel<T, 64, RULE>;
    case 128: return (const void*)gj_block_kernel<T, 128, RULE>;
    case 256: return (const void*)gj_block_kernel<T, 256, RULE>;
  }
  return nullptr;
}

// Shared memory of a block of the block variant, in bytes: the work area
// of zw columns and the system, with NB elements after it (the panel
// update reads its rows to the panel's sixteenth column).
template <typename T>
size_t block_smem(int n, int k, int zw) {
  return gjb::smem_work_bytes<T>(n, zw) +
         sizeof(T) * ((size_t)n * gjb::smem_ld(n + k) + gjb::NB);
}

// The block variant's plan, fixed by the shape and the card: *zw trailing
// columns per product (every trailing column of the first panel where
// shared memory holds their Z, else fewer, at least CW), the *smem bytes
// per block, *threads per block and the blocks (systems) an SM holds at
// once (*per_sm). Threads: the most of 64, 128 and 256 that runs as many
// systems at once on an SM as 64 threads do (the batch over the SMs, at
// most what its shared memory holds) within 1024 threads of it: a batch
// that covers the card runs more systems per SM with fewer threads each, a
// small batch gives each system more warps for its trailing product (and
// a slot per thread in the pivot chain). `want` > 0 forces 64, 128 or 256
// (the tests). A system whose work area with zw = CW does not fit
// one block's shared memory returns cudaErrorInvalidValue: the grid
// variant takes it (ops/gj_solve.py::block_bytes mirrors the count). The
// rule entries plan with their own kernel (RULE).
template <typename T, bool RULE = false>
int block_plan(long long batch, int n, int k, int want, int* threads,
               int* zw, size_t* smem, int* per_sm) {
  constexpr int CW = gjb::CW, NB = gjb::NB;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (block_smem<T>(n, k, CW) > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  const int m = n + k;
  const int wmax = (m - (n < NB ? n : NB) + CW - 1) / CW * CW;
  int cols = CW;
  while (cols + CW <= wmax && block_smem<T>(n, k, cols + CW) <= (size_t)optin)
    cols += CW;
  *zw = cols;
  *smem = block_smem<T>(n, k, cols);
  // blocks of t threads an SM holds at once
  auto resident = [&](int t, int* r) -> cudaError_t {
    const void* fn = block_kernel<T, RULE>(t);
    if (fn == nullptr) return cudaErrorInvalidValue;
    const cudaError_t s = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (s != cudaSuccess) return s;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(r, fn, t, *smem);
  };
  int th = want;
  if (want <= 0) {
    const long long need = (batch + sms - 1) / sms;
    int r64 = 0;
    e = resident(64, &r64);
    if (e != cudaSuccess) return (int)e;
    const long long conc = need < r64 ? need : r64;
    th = 64;
    for (int t = 128; t <= 256; t *= 2) {
      int r = 0;
      e = resident(t, &r);
      if (e != cudaSuccess) return (int)e;
      if ((need < r ? need : (long long)r) == conc && conc * t <= 1024) th = t;
    }
  }
  e = resident(th, per_sm);
  if (e != cudaSuccess) return (int)e;
  *threads = th;
  return 0;
}

template <typename T, bool RULE = false>
int launch(const void* A, long long sab, long long sar, long long sac,
           const void* Bm, long long sbb, long long sbr, long long sbc,
           void* X, int batch, int n, int k, int threads, void* stream,
           Rule<T> rule = Rule<T>{}) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  int th = 0, zw = 0, per_sm = 0;
  size_t smem = 0;
  const int e =
      block_plan<T, RULE>(batch, n, k, threads, &th, &zw, &smem, &per_sm);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&A, &sab, &sar, &sac, &Bm, &sbb, &sbr, &sbc, &X, &n, &k,
                  &zw, &rule};
  const cudaError_t le = cudaLaunchKernel(
      block_kernel<T, RULE>(th), dim3((unsigned)batch), dim3((unsigned)th),
      args, smem, (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <typename T, int MC, bool RULE>
int launch_warp_sized(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, int batch,
                      int n, int k, void* stream, Rule<T> rule) {
  const size_t smem =
      sizeof(T) * (size_t)WARPS * (size_t)n * (size_t)stage_ld(n + k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gj_warp_kernel<T, MC, RULE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((batch + WARPS - 1) / WARPS);
  gj_warp_kernel<T, MC, RULE>
      <<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(A), sab, sar, sac, static_cast<const T*>(Bm),
          sbb, sbr, sbc, static_cast<T*>(X), batch, n, k, rule);
  return (int)cudaGetLastError();
}

// The column bound MC: n + k rounded up to 8.
template <typename T, bool RULE = false>
int launch_warp(const void* A, long long sab, long long sar, long long sac,
                const void* Bm, long long sbb, long long sbr, long long sbc,
                void* X, int batch, int n, int k, void* stream,
                Rule<T> rule = Rule<T>{}) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  if (n > 32 || n + k > 64) return (int)cudaErrorInvalidValue;
#define GJ_WARP(MC)                                                      \
  case MC / 8:                                                           \
    return launch_warp_sized<T, MC, RULE>(A, sab, sar, sac, Bm, sbb, sbr, \
                                          sbc, X, batch, n, k, stream,    \
                                          rule);
  switch ((n + k + 7) / 8) {
    GJ_WARP(8) GJ_WARP(16) GJ_WARP(24) GJ_WARP(32)
    GJ_WARP(40) GJ_WARP(48) GJ_WARP(56) GJ_WARP(64)
  }
#undef GJ_WARP
  return (int)cudaErrorInvalidValue;
}


// ---- the grid entries: blocked Gauss-Jordan (gj_blocked.cuh) --------------

using gjb::CW;
using gjb::NB;

// Threads of a block of the cooperative grid entry, its warps and the
// 8-row tiles a warp updates at once.
constexpr int GT = 512, GW = GT / 32, GRT = 4;

// The entries of the grid variant, as the plan names them.
enum Entry { GRID_SMEM_PANEL = 0, GRID_L2_PANEL = 1 };

// Shared memory of a block of the cooperative grid entry, in bytes: Z of
// zw trailing columns and L, the candidates and pivot slots of the panel,
// the slots' logical indices ([n], rounded to 8 bytes) and, where the owner
// keeps the panel on chip, the panel ([n][NB + 1]).
template <typename T>
size_t grid_smem(int n, bool panel_on_chip, int zw) {
  size_t b = sizeof(T) * ((size_t)NB * zw + NB * NB) +
             sizeof(gjb::Cand<T>) * 2 * GW +
             sizeof(int) * (NB + ((n + 1) & ~1));
  if (panel_on_chip) b += sizeof(T) * (size_t)n * (NB + 1);
  return b;
}

// One cooperative launch: `teams` teams of `team` blocks, team r taking the
// systems r, r + teams, ... in rounds; its [A | B] is work[r] ([n][ldw],
// rows padded to 16 bytes; device memory, read and written through L2:
// other SMs write it between the barriers), its pivot slots ps and pivots
// dg, [n] each; the slots' logical indices are in the owner's shared
// memory. Block 0 of a team owns the panels; the trailing columns go in tiles of CW, in
// contiguous runs, to the team's other blocks, which first stage the
// panel's G on chip (a team of one block does all, zw columns at a time).
// Look-ahead: in the round of panel p the owner first updates panel
// p + 1's columns (trailing tile 0, written straight into its on-chip
// panel), factors them while the other blocks update the rest, and the
// round ends at one team barrier: a solve takes n / NB + 3 of them.
template <typename T, bool PANEL_ON_CHIP>
__global__ void __launch_bounds__(GT, 1)
    gj_grid_kernel(const T* __restrict__ A, long long sab, long long sar,
                   long long sac, const T* __restrict__ Bm, long long sbb,
                   long long sbr, long long sbc, T* __restrict__ X, T* work,
                   int* pslot, T* dgw, long long batch, int n, int k,
                   int ldw, int team, int zw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Zs = reinterpret_cast<T*>(smem_raw);   // [NB][zw]
  T* Ls = Zs + (size_t)NB * zw;             // [NB][NB]
  auto* wc = reinterpret_cast<gjb::Cand<T>(*)[GW]>(Ls + NB * NB);
  int* psl = reinterpret_cast<int*>(wc + 2);   // [NB]
  int* lg = psl + NB;                          // [n]
  T* pan = reinterpret_cast<T*>(lg + ((n + 1) & ~1));   // [n][NB + 1]
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int m = n + k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x % team;
  const long long r = blockIdx.x / team;
  const long long teams = gridDim.x / team;
  T* w = work + r * (long long)n * ldw;
  int* ps = pslot + r * n;
  T* dg = dgw + r * n;
  gjb::Panel<T, PANEL_ON_CHIP> P;
  P.p = PANEL_ON_CHIP ? pan : w;
  P.ld = PANEL_ON_CHIP ? NB + 1 : ldw;
  P.lg = lg;
  auto team_sync = [&]() {
    if (team > 1) grid.sync(); else __syncthreads();
  };
  auto at = [&](int row, int col) { return w + (long long)row * ldw + col; };
  // G of the current panel, zero at each pivot's own column: on chip in
  // pan (the owner's factored panel, or a staged copy), else in the work
  // area
  auto gget = [&](int row, int c, int j0) -> T {
    return PANEL_ON_CHIP ? pan[row * (NB + 1) + c] : __ldcg(at(row, j0 + c));
  };

  // (a) the panel at j0, by the owner (on chip: copied in from the work
  // area if `load`, else its columns are in pan already), factored; the
  // pivots' own column zeroed (their diagonal is in dg), and G written to
  // the work area if `publish`
  auto panel = [&](int j0, bool load, bool publish) {
    const int nb = min(NB, n - j0);
    gjb::Panel<T, PANEL_ON_CHIP> Pj = P;
    if (!PANEL_ON_CHIP) Pj.p = at(0, j0);
    if (PANEL_ON_CHIP && load) {
      for (int e = tid; e < n * nb; e += GT) {
        const int s = e / nb, c = e - s * nb;
        pan[s * (NB + 1) + c] = __ldcg(at(s, j0 + c));
      }
      __syncthreads();
    }
    gjb::factor_panel<GT>(Pj, n, j0, nb, psl,
                          [&](int kk, int sp, T pv) {
                            __stcg(ps + kk, sp);
                            __stcg(dg + kk, pv);
                          },
                          wc);
    if (PANEL_ON_CHIP) {
      if (publish) {
        for (int e = tid; e < n * nb; e += GT) {
          const int s = e / nb, c = e - s * nb;
          __stcg(at(s, j0 + c), s == psl[c] ? T(0) : pan[s * (NB + 1) + c]);
        }
      }
      if (tid < nb) pan[psl[tid] * (NB + 1) + tid] = T(0);
    } else if (tid < nb) {
      __stcg(at(psl[tid], j0 + tid), T(0));
    }
    __syncthreads();
  };

  // a block other than the owner: the panel's pivot slots, and its G on chip
  auto stage = [&](int j0) {
    const int nb = min(NB, n - j0);
    if (tid < NB) psl[tid] = tid < nb ? __ldcg(ps + j0 + tid) : 0;
    if (PANEL_ON_CHIP) {
      for (int e = tid; e < n * nb; e += GT) {
        const int s = e / nb, c = e - s * nb;
        pan[s * (NB + 1) + c] = __ldcg(at(s, j0 + c));
      }
    }
    __syncthreads();
  };

  // (b) the trailing columns [c0, c1) (c1 - c0 <= zw) of the panel at j0:
  // Z from the pivot rows, then every row takes T -= G Z. With `ahead`, the
  // next panel's columns go to the on-chip panel instead of the work area.
  auto trailing = [&](int j0, int c0, int c1, bool ahead) {
    const int nb = min(NB, n - j0), j1 = j0 + nb;
    const int jn = ahead ? j1 + min(NB, n - j1) : 0;
    const int ntl = (c1 - c0 + CW - 1) / CW, wt = ntl * CW;
    for (int e = tid; e < NB * NB; e += GT) {
      const int c = e / NB, cp = e - c * NB;
      Ls[e] = (c < nb && cp < c) ? gget(psl[c], cp, j0) : T(0);
    }
    for (int e = tid; e < NB * wt; e += GT) {
      const int c = e / wt, j = e - c * wt;
      Zs[c * zw + j] =
          (c < nb && c0 + j < c1) ? __ldcg(at(psl[c], c0 + j)) : T(0);
    }
    __syncthreads();
    for (int j = tid; j < wt; j += GT) {
      T z[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) z[c] = Zs[c * zw + j];
      gjb::forward_subst(z, nb, [&](int c, int cp) { return Ls[c * NB + cp]; });
#pragma unroll
      for (int c = 0; c < NB; ++c) Zs[c * zw + j] = z[c];
    }
    __syncthreads();
    const int nrg = ((n + 7) / 8 + GRT - 1) / GRT;
    for (int it = warp; it < nrg * ntl; it += GW) {
      const int r0 = (it / ntl) * GRT * 8, q = it - (it / ntl) * ntl;
      const int cq = c0 + q * CW;
      gjb::rank_update<GRT, CW / 8>(
          T(0),
          [&](int i, int rr, int c) -> T {
            const int row = r0 + i * 8 + rr;
            return (row < n && c < nb) ? -gget(row, c, j0) : T(0);
          },
          [&](int c, int j) -> T { return Zs[c * zw + q * CW + j]; },
          [&](int i, int rr, int j, T& x0, T& x1) {
            const int row = r0 + i * 8 + rr, col = cq + j;
            x0 = x1 = T(0);
            if (row >= n || col >= c1) return;
            if (col + 1 < c1) gjb::ldcg2(at(row, col), x0, x1);
            else x0 = __ldcg(at(row, col));
          },
          [&](int i, int rr, int j, T x0, T x1) {
            const int row = r0 + i * 8 + rr, col = cq + j;
            if (row >= n || col >= c1) return;
            if (col + 1 < jn) {
              pan[row * (NB + 1) + col - j1] = x0;
              pan[row * (NB + 1) + col + 1 - j1] = x1;
            } else if (col < jn) {
              pan[row * (NB + 1) + col - j1] = x0;
              if (col + 1 < c1) __stcg(at(row, col + 1), x1);
            } else if (col + 1 < c1) {
              gjb::stcg2(at(row, col), x0, x1);
            } else {
              __stcg(at(row, col), x0);
            }
          });
    }
    __syncthreads();
  };
  auto trailing_run = [&](int j0, int c0, int c1) {
    for (int c = c0; c < c1; c += zw) trailing(j0, c, min(c + zw, c1), false);
  };

  const int np = (n + NB - 1) / NB;
  const long long rounds = (batch + teams - 1) / teams;
  for (long long round = 0; round < rounds; ++round) {
    const long long b = round * teams + r;
    const bool live = b < batch;
    if (!live && team == 1) break;
    if (live) {
      const T* Ab = A + b * sab;
      const T* Bb = Bm + b * sbb;
      for (int i = t * GW + warp; i < n; i += team * GW) {
        for (int j = lane; j < m; j += 32) {
          __stcg(at(i, j),
                 j < n ? Ab[i * sar + j * sac] : Bb[i * sbr + (j - n) * sbc]);
        }
      }
      if (t == 0)
        for (int s = tid; s < n; s += GT) lg[s] = s;
    }
    team_sync();   // [A | B] is in the work area
    if (live && t == 0) panel(0, true, team > 1);
    team_sync();   // panel 0 is factored
    for (int p = 0; p < np; ++p) {
      if (live) {
        const int j0 = p * NB, j1 = min(j0 + NB, n);
        const int ntile = (m - j1 + CW - 1) / CW;
        if (t == 0 && team > 1) {
          // look-ahead: panel p + 1's columns first, then its factoring
          if (ntile > 0)
            trailing(j0, j1, min(j1 + CW, m), PANEL_ON_CHIP && j1 < n);
          if (j1 < n) panel(j1, false, true);
        } else if (t == 0) {
          trailing_run(j0, j1, m);
          if (j1 < n) panel(j1, true, false);
        } else if (ntile > 1) {
          const int per = (ntile - 1 + team - 2) / (team - 1);
          const int q0 = 1 + (t - 1) * per, q1 = min(ntile, q0 + per);
          if (q0 < q1) {
            stage(j0);
            trailing_run(j0, j1 + q0 * CW, min(j1 + q1 * CW, m));
          }
        }
      }
      team_sync();   // panel p applied everywhere, panel p + 1 factored
    }
    if (live) {
      // (c) X[j] = B-part of the pivot row of step j / its pivot
      T* Xb = X + b * (long long)n * k;
      for (int j = t * GW + warp; j < n; j += team * GW) {
        const int s = __ldcg(ps + j);
        const T d = __ldcg(dg + j);
        for (int c = lane; c < k; c += 32)
          Xb[(long long)j * k + c] = __ldcg(at(s, n + c)) / d;
      }
    }
    team_sync();   // the work area is read before the next system comes in
  }
}

// The plan of a call, deterministic from the shape and the card: the
// cooperative grid entry, its panel on chip (0) where the owner's shared
// memory holds it, else in L2 (1). `want` forces an entry (-1: the
// plan's; the tests force the panel in L2 at shapes the plan keeps on
// chip); one that cannot take the shape returns cudaErrorInvalidValue.
// *team: blocks per system, *teams: systems at once, *ldw: the work area's
// row stride; *zw: the trailing columns a block takes at a time.
template <typename T>
int grid_plan(long long batch, int n, int k, int want, int* entry, int* team,
              int* teams, int* ldw, int* zw, size_t* smem) {
  // the work area's rows, padded to 16 bytes
  const int per16 = 16 / (int)sizeof(T);
  *ldw = (n + k + per16 - 1) / per16 * per16;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const int m = n + k;
  // the widest trailing run: all columns after the first panel, in tiles
  const int wmax = ((m - (n < NB ? n : NB) + CW - 1) / CW) * CW;
  int ent = want;
  if (ent < 0) {
    ent = grid_smem<T>(n, true, CW) <= (size_t)optin ? GRID_SMEM_PANEL
                                                     : GRID_L2_PANEL;
  }
  if (ent != GRID_SMEM_PANEL && ent != GRID_L2_PANEL)
    return (int)cudaErrorInvalidValue;
  const bool on_chip = ent == GRID_SMEM_PANEL;
  const size_t fixed = grid_smem<T>(n, on_chip, 0);
  if (fixed + sizeof(T) * NB * CW > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  int cols = (int)(((size_t)optin - fixed) / (sizeof(T) * NB) / CW) * CW;
  cols = cols < wmax ? cols : wmax;
  *zw = cols < CW ? CW : cols;
  *smem = grid_smem<T>(n, on_chip, *zw);
  int coop = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  const void* fn = on_chip ? (const void*)gj_grid_kernel<T, true>
                           : (const void*)gj_grid_kernel<T, false>;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)*smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, GT, *smem);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the owner and a block per trailing tile of the first panel
  const long long want_team = 1 + wmax / CW;
  long long tm = batch >= resident ? 1 : resident / batch;
  tm = tm < want_team ? tm : want_team;
  tm = tm < 1 ? 1 : tm;
  long long ts = resident / tm;
  ts = ts < batch ? ts : batch;
  *entry = ent;
  *team = (int)tm;
  *teams = (int)ts;
  return 0;
}

template <typename T>
int launch_grid(const void* A, long long sab, long long sar, long long sac,
                const void* Bm, long long sbb, long long sbr, long long sbc,
                void* X, void* work, void* pslot, void* dgw,
                long long batch, int n, int k, int entry, int team, int teams,
                void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  int want_entry = 0, want_team = 0, want_teams = 0, ldw = 0, zw = 0;
  size_t smem = 0;
  const int e = grid_plan<T>(batch, n, k, entry, &want_entry, &want_team,
                             &want_teams, &ldw, &zw, &smem);
  if (e != 0) return e;
  // the caller sized the work area by gj_grid_plan_*
  if (entry != want_entry || team != want_team || teams != want_teams)
    return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* bm = static_cast<const T*>(Bm);
  T* x = static_cast<T*>(X);
  T* w = static_cast<T*>(work);
  int* ps = static_cast<int*>(pslot);
  T* dg = static_cast<T*>(dgw);
  void* args[] = {&a, &sab, &sar, &sac, &bm, &sbb, &sbr, &sbc, &x, &w,
                  &ps, &dg, &batch, &n, &k, &ldw, &team, &zw};
  const void* fn = entry == GRID_SMEM_PANEL
                       ? (const void*)gj_grid_kernel<T, true>
                       : (const void*)gj_grid_kernel<T, false>;
  return (int)cudaLaunchCooperativeKernel(fn, dim3((unsigned)(team * teams)),
                                          dim3(GT), args, smem,
                                          (cudaStream_t)stream);
}

// One rule launch, warp (warp != 0) or block form: the Rule from the C
// entry's flat arguments.
template <typename T>
int launch_rule(int warp, int mode, const void* A, long long sab,
                long long sar, long long sac, const void* Bm, long long sbb,
                long long sbr, long long sbc, const void* X, long long sxb,
                long long sxr, long long sxc, const void* dA, long long sdb,
                long long sdr, long long sdc, void* out, void* gA, int batch,
                int n, int k, int threads, void* stream) {
  if (mode != TANGENT && mode != ADJOINT) return (int)cudaErrorInvalidValue;
  if (mode == TANGENT && dA == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == ADJOINT && Bm == nullptr) return (int)cudaErrorInvalidValue;
  const Rule<T> rule{mode,
                     static_cast<const T*>(X), sxb, sxr, sxc,
                     static_cast<const T*>(dA), sdb, sdr, sdc,
                     static_cast<T*>(gA)};
  if (warp)
    return launch_warp<T, true>(A, sab, sar, sac, Bm, sbb, sbr, sbc, out,
                                batch, n, k, stream, rule);
  return launch<T, true>(A, sab, sar, sac, Bm, sbb, sbr, sbc, out, batch, n,
                         k, threads, stream, rule);
}

}  // namespace

extern "C" {

// Pointers are device pointers; strides are in elements; stream is a
// cudaStream_t. Each returns the cudaError_t of the launch (0 on success).
// gj_solve_*: the block variant; threads 0 for the plan's (gj_block_plan_*).
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

// The block variant's plan for a batch of [n, n + k] systems (threads: 0
// for the plan's, else forced): *threads per block, *zw, *smem bytes per
// block and *per_sm systems an SM holds at once; cudaErrorInvalidValue
// where the system does not fit one block's shared memory.
int gj_block_plan_f64(long long batch, int n, int k, int threads, int* th,
                      int* zw, long long* smem, int* per_sm) {
  size_t b = 0;
  const int e = block_plan<double>(batch, n, k, threads, th, zw, &b, per_sm);
  *smem = (long long)b;
  return e;
}

int gj_block_plan_f32(long long batch, int n, int k, int threads, int* th,
                      int* zw, long long* smem, int* per_sm) {
  size_t b = 0;
  const int e = block_plan<float>(batch, n, k, threads, th, zw, &b, per_sm);
  *smem = (long long)b;
  return e;
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

// The grid variant's plan for a call: *entry (0: the panel on chip; 1: the
// panel in L2), *team blocks per system, *teams systems at once, *ldw the
// work area's row stride; `want` forces an entry (-1: the plan's own). The
// caller gives the launch a work area of teams * n * ldw elements,
// teams * n pivot slots (int) and teams * n pivots (the matrix's type).
int gj_grid_plan_f64(long long batch, int n, int k, int want, int* entry,
                     int* team, int* teams, int* ldw) {
  int zw = 0;
  size_t smem = 0;
  return grid_plan<double>(batch, n, k, want, entry, team, teams, ldw, &zw,
                        &smem);
}

int gj_grid_plan_f32(long long batch, int n, int k, int want, int* entry,
                     int* team, int* teams, int* ldw) {
  int zw = 0;
  size_t smem = 0;
  return grid_plan<float>(batch, n, k, want, entry, team, teams, ldw, &zw,
                        &smem);
}

int gj_solve_grid_f64(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, void* work,
                      void* pslot, void* dgw, long long batch,
                      int n, int k, int entry, int team, int teams,
                      void* stream) {
  return launch_grid<double>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, work,
                             pslot, dgw, batch, n, k, entry, team, teams,
                             stream);
}

int gj_solve_grid_f32(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, void* work,
                      void* pslot, void* dgw, long long batch,
                      int n, int k, int entry, int team, int teams,
                      void* stream) {
  return launch_grid<float>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, work,
                            pslot, dgw, batch, n, k, entry, team, teams,
                            stream);
}

// K1's derivative rules, one launch each (see Rule): warp != 0 the warp
// form (n <= 32 and n + k <= 64), else the block form (threads 0: the
// plan's). mode 1, the tangent: Bm = dB (null: none), X the forward
// solution, dA A's tangent, out = dX. mode 2, the adjoint: A by its
// transposed strides, Bm = gX, X the forward solution, out = gB, gA the
// cotangent of A (null: not wanted; contiguous [batch][n][n]).
int gj_rule_f64(int warp, int mode, const void* A, long long sab,
                long long sar, long long sac, const void* Bm, long long sbb,
                long long sbr, long long sbc, const void* X, long long sxb,
                long long sxr, long long sxc, const void* dA, long long sdb,
                long long sdr, long long sdc, void* out, void* gA, int batch,
                int n, int k, int threads, void* stream) {
  return launch_rule<double>(warp, mode, A, sab, sar, sac, Bm, sbb, sbr, sbc,
                             X, sxb, sxr, sxc, dA, sdb, sdr, sdc, out, gA,
                             batch, n, k, threads, stream);
}

int gj_rule_f32(int warp, int mode, const void* A, long long sab,
                long long sar, long long sac, const void* Bm, long long sbb,
                long long sbr, long long sbc, const void* X, long long sxb,
                long long sxr, long long sxc, const void* dA, long long sdb,
                long long sdr, long long sdc, void* out, void* gA, int batch,
                int n, int k, int threads, void* stream) {
  return launch_rule<float>(warp, mode, A, sab, sar, sac, Bm, sbb, sbr, sbc,
                            X, sxb, sxr, sxc, dA, sdb, sdr, sdc, out, gA,
                            batch, n, k, threads, stream);
}

}  // extern "C"
