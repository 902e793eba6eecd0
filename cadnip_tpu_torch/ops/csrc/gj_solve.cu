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
//   n = 169 in f64 with k = 1).
// * gj_solve_grid_*: the systems that one block's shared memory does not
//   hold. It replaces the large-n use of the TPU kernel (method gjpl32ir,
//   cadnip_tpu/ops/linalg.py:138-142,170-176, whose VMEM held systems up to
//   n = 1024), and takes the Schur complement of the block-bordered-diagonal
//   solve. The augmented block lives in device memory (L2 holds it at these
//   sizes: n = 1536, k = 1 is 18.9 MB of the 50 MB), copied once from A and
//   B. One cooperative launch per call: a team of co-resident blocks per
//   system, one warp per row as in the block entry, with a grid-wide
//   barrier between the phases of each pivot (two per pivot: after every
//   block's pivot candidate, after the row swap). Where the batch covers
//   the co-resident grid, a team is one block, its barriers block
//   barriers, and each block walks over its systems in turn. What bounds
//   it: n grid barriers' latencies and n sweeps of the block through L2;
//   a blocked right-looking LU on wgmma tiles is later Hopper work.
//   Element for element it does the block entry's arithmetic in the block
//   entry's order, so where both take a shape they give the same bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, bound by ctypes)
// The elimination is written as an FMA; the plain PyTorch twin rounds the
// product first, so the two agree to rounding level, not bit for bit.

#include <cooperative_groups.h>
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


// ---- the grid entry ------------------------------------------------------

constexpr int GRID_THREADS = 256;   // threads of a block of the grid entry

// The candidate of block `t` for the pivot of its team: the argmax of
// |ab[i, kk]| over its rows i >= kk (value -1 and row n where it has none).
// The rows of a block are those of its warps: row i belongs to the warp
// i mod (team * nwarps) of the team.
template <typename T>
__device__ void block_candidate(const T* ab, int n, int m, int kk, int t,
                                int team, gj::Scratch<T>& s, T* cand_v,
                                int* cand_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wstride = team * nwarps;
  T bv = T(-1);
  int bi = n;
  for (int e = tid;; e += blockDim.x) {
    const int i = (e / nwarps) * wstride + t * nwarps + e % nwarps;
    if (i >= n) break;
    if (i < kk) continue;
    const T v = fabs(__ldcg(ab + (long long)i * m + kk));
    if (gj::beats(v, i, bv, bi)) { bv = v; bi = i; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(gj::FULL, bv, off);
    const int oi = __shfl_down_sync(gj::FULL, bi, off);
    if (gj::beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  if (lane == 0) { s.red_v[warp] = bv; s.red_i[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nwarps ? s.red_v[lane] : T(-1);
    bi = lane < nwarps ? s.red_i[lane] : n;
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(gj::FULL, bv, off);
      const int oi = __shfl_down_sync(gj::FULL, bi, off);
      if (gj::beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { __stcg(cand_v, bv); __stcg(cand_i, bi); }
  }
}

// The pivot row of a team from its blocks' candidates, into s.piv_row.
// `beats` is a total order, so every block of the team finds the same row,
// the one the block entry's reduction finds.
template <typename T>
__device__ void team_pivot(const T* cand_v, const int* cand_i, int team,
                           int n, gj::Scratch<T>& s) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0) {
    T bv = T(-1);
    int bi = n;
    for (int c = lane; c < team; c += 32) {
      const T v = __ldcg(cand_v + c);
      const int i = __ldcg(cand_i + c);
      if (gj::beats(v, i, bv, bi)) { bv = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(gj::FULL, bv, off);
      const int oi = __shfl_down_sync(gj::FULL, bi, off);
      if (gj::beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) s.piv_row = bi;
  }
  __syncthreads();
}

// One cooperative launch: `teams` teams of `team` blocks, team r taking the
// systems r, r + teams, ... in rounds; its augmented block is work[r]
// ([n][n + k], device memory), its blocks' candidates cand_*[r * team ..].
// The matrix is read and written through L2 (__ldcg / __stcg): other SMs
// write it between the barriers.
template <typename T>
__global__ void __launch_bounds__(GRID_THREADS)
    gj_grid_kernel(const T* __restrict__ A, long long sab, long long sar,
                   long long sac, const T* __restrict__ Bm, long long sbb,
                   long long sbr, long long sbc, T* __restrict__ X, T* work,
                   T* cand_v, int* cand_i, long long batch, int n, int k,
                   int team) {
  extern __shared__ unsigned char smem_raw[];
  T* prow = reinterpret_cast<T*>(smem_raw);   // the pivot row, [n + k]
  __shared__ gj::Scratch<T> s;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int m = n + k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t = blockIdx.x % team;
  const long long r = blockIdx.x / team;
  const long long teams = gridDim.x / team;
  const int wstride = team * nwarps;
  const int w0 = t * nwarps + warp;   // this warp's first row
  const int t0 = t * blockDim.x + tid, tstride = team * blockDim.x;
  T* ab = work + r * (long long)n * m;
  T* cv = cand_v + r * team;
  int* ci = cand_i + r * team;
  // a team of one block needs only block barriers
  auto team_sync = [&]() {
    if (team > 1) grid.sync(); else __syncthreads();
  };

  const long long rounds = (batch + teams - 1) / teams;
  for (long long round = 0; round < rounds; ++round) {
    const long long b = round * teams + r;
    const bool live = b < batch;
    if (!live && team == 1) break;
    if (live) {
      const T* Ab = A + b * sab;
      const T* Bb = Bm + b * sbb;
      for (int i = w0; i < n; i += wstride) {
        for (int j = lane; j < m; j += 32) {
          __stcg(ab + (long long)i * m + j,
                 j < n ? Ab[i * sar + j * sac] : Bb[i * sbr + (j - n) * sbc]);
        }
      }
      __syncthreads();
      block_candidate(ab, n, m, 0, t, team, s, cv + t, ci + t);
    }
    for (int kk = 0; kk < n; ++kk) {
      team_sync();   // every candidate for pivot kk is written
      if (live) {
        team_pivot(cv, ci, team, n, s);
        const int p = s.piv_row;
        if (p != kk) {
          for (int j = t0; j < m; j += tstride) {
            const T a = __ldcg(ab + (long long)kk * m + j);
            __stcg(ab + (long long)kk * m + j,
                   __ldcg(ab + (long long)p * m + j));
            __stcg(ab + (long long)p * m + j, a);
          }
        }
      }
      team_sync();   // rows kk and p are swapped
      if (live) {
        for (int j = tid; j < m; j += blockDim.x)
          prow[j] = __ldcg(ab + (long long)kk * m + j);
        __syncthreads();
        // eliminate column kk from this block's rows, as gj::eliminate
        const T piv = prow[kk];
        for (int i = w0; i < n; i += wstride) {
          if (i == kk) continue;
          T* row = ab + (long long)i * m;
          const T f = __ldcg(row + kk) / piv;
          __syncwarp();   // every lane holds f before column kk changes
          for (int j = lane; j < m; j += 32) {
            __stcg(row + j, fma(-f, prow[j], __ldcg(row + j)));
          }
        }
        __syncthreads();
        if (kk + 1 < n)
          block_candidate(ab, n, m, kk + 1, t, team, s, cv + t, ci + t);
      }
    }
    if (live) {
      // ---- X = B-part / diag(A-part) of this block's rows
      T* Xb = X + b * (long long)n * k;
      for (int i = w0; i < n; i += wstride) {
        const T d = __ldcg(ab + (long long)i * m + i);
        for (int c = lane; c < k; c += 32)
          Xb[(long long)i * k + c] = __ldcg(ab + (long long)i * m + n + c) / d;
      }
    }
  }
}

// The grid of a call: `team` blocks per system and `teams` systems at once,
// within what the card holds co-resident. A team has a block for every
// GRID_THREADS / 32 rows, as far as the batch leaves room.
template <typename T>
int grid_plan(long long batch, int n, int k, int* team, int* teams,
              size_t* smem) {
  *smem = sizeof(T) * (size_t)(n + k);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gj_grid_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gj_grid_kernel<T>, GRID_THREADS, *smem);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = (n + GRID_THREADS / 32 - 1) / (GRID_THREADS / 32);
  long long tm = batch >= resident ? 1 : resident / batch;
  tm = tm < want ? tm : want;
  tm = tm < 1 ? 1 : tm;
  long long ts = resident / tm;
  ts = ts < batch ? ts : batch;
  *team = (int)tm;
  *teams = (int)ts;
  return 0;
}

template <typename T>
int launch_grid(const void* A, long long sab, long long sar, long long sac,
                const void* Bm, long long sbb, long long sbr, long long sbc,
                void* X, void* work, void* cand_v, void* cand_i,
                long long batch, int n, int k, int team, int teams,
                void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  int want_team = 0, want_teams = 0;
  size_t smem = 0;
  const int e = grid_plan<T>(batch, n, k, &want_team, &want_teams, &smem);
  if (e != 0) return e;
  // the caller sized work and the candidates by gj_grid_plan_*
  if (team != want_team || teams != want_teams)
    return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* bm = static_cast<const T*>(Bm);
  T* x = static_cast<T*>(X);
  T* w = static_cast<T*>(work);
  T* cv = static_cast<T*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  void* args[] = {&a, &sab, &sar, &sac, &bm, &sbb, &sbr, &sbc, &x, &w,
                  &cv, &ci, &batch, &n, &k, &team};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)gj_grid_kernel<T>, dim3((unsigned)(team * teams)),
      dim3(GRID_THREADS), args, smem, (cudaStream_t)stream);
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

// The grid entry's plan for a call: *team blocks per system, *teams
// systems at once. The caller gives the launch a work area of
// teams * n * (n + k) elements and teams * team candidates (a value of the
// matrix's type and an int each).
int gj_grid_plan_f64(long long batch, int n, int k, int* team, int* teams) {
  size_t smem = 0;
  return grid_plan<double>(batch, n, k, team, teams, &smem);
}

int gj_grid_plan_f32(long long batch, int n, int k, int* team, int* teams) {
  size_t smem = 0;
  return grid_plan<float>(batch, n, k, team, teams, &smem);
}

int gj_solve_grid_f64(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, void* work,
                      void* cand_v, void* cand_i, long long batch, int n,
                      int k, int team, int teams, void* stream) {
  return launch_grid<double>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, work,
                             cand_v, cand_i, batch, n, k, team, teams,
                             stream);
}

int gj_solve_grid_f32(const void* A, long long sab, long long sar,
                      long long sac, const void* Bm, long long sbb,
                      long long sbr, long long sbc, void* X, void* work,
                      void* cand_v, void* cand_i, long long batch, int n,
                      int k, int team, int teams, void* stream) {
  return launch_grid<float>(A, sab, sar, sac, Bm, sbb, sbr, sbc, X, work,
                            cand_v, cand_i, batch, n, k, team, teams,
                            stream);
}

}  // extern "C"
