// Kernel K2: the whole adaptive transient of a small dense circuit in one
// launch, one thread block per circuit, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel archive/pallas_tran.py::make_kernel.kernel (the
// Pallas "VMEM integrator"). It computes what that kernel computes; it is
// not carried over block by block. Per Newton iteration: the device
// evaluation of every instance (limiter, then the residual on dual numbers
// for f, q and the local Jacobians; devices.cuh), the assembly of F, Q
// and A = G + c0*C through gather plans built on the host (a fixed summation
// order, no atomics, so step decisions replay), the two-sided equilibrated
// Gauss-Jordan solve of [Dr A Dc | Dr F] (K1's warp form, gj_core.cuh, or
// its blocked form, gj_blocked.cuh) with the column scaling undone, max_dv
// damping, the ok_dx | ok_res test, divided-difference LTE control (BE after
// a breakpoint, then trapezoidal), breakpoint hits, and the linear
// interpolation of each accepted step onto the save rows in (t, t_new]. The
// reference kernel's sequential chunk grid is a loop over chunks inside the
// block: a step never crosses its chunk's last save time, the chunk's rows
// are first filled with its entry state, and a step writes through a window
// of win_rows rows.
//
// The reference is f32 only because Mosaic has no f64; K2 is f64. Its
// constants are the reference's, unchanged, so that step decisions remain
// comparable: RES_EPS = 8e-7, the reltol floor 4e-6 (applied on the host),
// TRTOL, GROW_MAX, NEWTON_FAIL_CUT, the hold of 3 steps after a reject and
// the failure after more than 100 rejects in a row. Limiter states start at
// zeros, as the reference's do.
//
// What bounds it on this card: one block's serial Newton chain, a string
// of block barriers and the FP64 latency of the device functions; the
// bytes are negligible. The design keeps the state vectors, the dense
// [n][n+1] system and, where they fit, the per-instance locals (f, q, J,
// C, limiter states) in shared memory (else in device memory that stays in
// L1/L2), runs each device group on warps of its own (slots built on the
// host, so no warp diverges over two models), lets thread 0 run the scalar
// step control with barriers publishing it, and goes back to the host once
// per transient. For n <= 32 the Newton solve (equilibration,
// elimination, the step and its max_dv maximum) runs inside warp 0 with
// the system in registers (gj::eliminate_warp), while the other warps wait
// at one barrier: about 15 block barriers per iteration. Larger circuits,
// up to n = 127 unknowns as the reference's n + 1 <= 128, take K1's block
// form (gjb::eliminate_smem of gj_blocked.cuh) on the whole block: the
// system in shared memory at an odd row stride (164 KB with the vectors and
// the elimination's work area at n = 127), panels of 16 columns, one
// barrier per pivot and two per panel, the trailing update on the f64
// tensor cores; rows never move, so the step reads each unknown through
// its pivot's slot. The two solves are two instances of the kernel, so
// that the block solve's registers leave the small circuits' alone.
//
// Thread 0 reads clock64() at each phase boundary of an iteration and adds
// the cycles to stats[PHASE0 + p] (always on; a few cycles a phase).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (plain C interface, bound by ctypes)
// nvcc contracts products into FMAs and the plain PyTorch twin does not,
// and the sums run in another order: kernel and twin agree to rounding,
// and rounding may flip an occasional step decision.

#include <cuda_runtime.h>

#include "devices.cuh"
#include "gj_blocked.cuh"

// Scalar configuration; mirrored by _Config in ops/vmem_tran.py (8-byte
// fields only, so the two layouts agree without padding rules).
struct VmemConfig {
  double t0, tstop, h0, hmax, hmin, dt_save, reltol, max_dv, gshunt, gmin,
      temp, srcfact;
  long long n, n_groups, n_inst, n_loc, n_bp, max_steps, max_newton, n_save,
      rows_per_chunk, win_rows, n_chunks;
  // per-instance locals: n_jac Jacobian entries (n_loc local values); the
  // instance slots (each group starts at a warp); the lengths of the F/Q
  // and J/C gather plans; whether the locals and the plans live in shared
  // memory after the vectors (else in device memory)
  long long n_jac, n_slots, n_fq, n_jc, locals_in_smem;
};

// Device pointers; mirrored by _Ptrs in ops/vmem_tran.py.
struct VmemPtrs {
  const long long* gdesc;   // [n_groups][GD_STRIDE]
  const int* conn;          // per group [n_inst][n_local] unknown indices
  const double* par;        // per group [n_inst][n_par]
  const long long* wkind;   // [n_inst total] waveform kinds
  const double* wcoef;      // per wave group [n_inst][W]
  const double* bp;         // [n_bp] breakpoints
  const double *x0, *q0, *qdot0, *atol, *diff, *vmask;   // [n]
  const int *fq_ptr, *fq_idx, *jc_ptr, *jc_idx;           // gather plans
  double *floc, *qloc, *jloc, *cloc, *ueval, *lims, *limacc, *wv, *cdx;
  double* xs;               // [n_chunks * rows_per_chunk][n]
  long long* stats;         // [N_STATS]: naccept, nreject, nnewton, fail,
                            // nsteps; [PHASE0 + p]: cycles of phase p
  double* fin;              // [3][n]: x, q, qdot at the end
  const int* slot_inst;     // [n_slots] global instance index, or -1
  const int* slot_group;    // [n_slots] its device group
  double* gat;              // [2 (n_fq + n_jc)] contributions in plan order
};

namespace {

enum { GD_MODEL = 0, GD_NINST, GD_NL, GD_NPAR, GD_CONN, GD_PAR, GD_LOC,
       GD_JAC, GD_INST, GD_WAVE, GD_W, GD_STRIDE };

// An instance's local vectors (nl values) and local Jacobians (nl * nl)
// sit at odd strides, so the lanes of a warp, one instance each, reach
// distinct shared-memory banks; mirrored by loc_strides in ops/vmem_tran.py.
__device__ __forceinline__ int loc_stride(int nl) { return nl | 1; }
__device__ __forceinline__ int jac_stride(int nl) { return (nl * nl) | 1; }

constexpr double TRTOL = 7.0;
constexpr double GROW_MAX = 2.0;
constexpr double NEWTON_FAIL_CUT = 0.125;
constexpr double RES_EPS = 8e-7;
constexpr double TINY = 1e-30;
constexpr long long HOLD_STEPS = 3;
constexpr long long MAX_REJECT_RUN = 100;
constexpr int N_VECTORS = 19;   // state vectors of n + 1 in shared memory
constexpr int WARP_SOLVE_MAX = 32;   // largest n solved inside one warp
constexpr int K2_THREADS = 256;      // threads of the block (ops/vmem_tran.py)

// Columns of Z in the block solve's work area: every trailing column of
// the first panel of [A | b].
__host__ __device__ constexpr int block_zw(int n) {
  return (n + 1 - gjb::NB + gjb::CW - 1) / gjb::CW * gjb::CW;
}

// Row stride of A in shared memory, and the block solve's work area (0 for
// the warp solve), in bytes; mirrored by smem_bytes in ops/vmem_tran.py.
__host__ __device__ constexpr int a_ld(int n) {
  return n <= WARP_SOLVE_MAX ? n + 1 : gjb::smem_ld(n + 1);
}
__host__ __device__ constexpr size_t solve_work_bytes(int n) {
  return n <= WARP_SOLVE_MAX ? 0
                             : gjb::smem_work_bytes<double>(n, block_zw(n));
}

// Phases of a Newton iteration timed by thread 0: device evaluation;
// assembly; equilibration + solve (with the step's max_dv maximum);
// damping, convergence and LTE; accept and save (with the limiter states);
// step control (with the chunk set-up).
enum { PH_EVAL, PH_ASSEMBLE, PH_SOLVE, PH_CHECK, PH_ACCEPT, PH_STEP,
       N_PHASES };
constexpr int PHASE0 = 8;        // stats slot of the first phase
constexpr int N_STATS = 16;      // mirrored by N_STATS in ops/vmem_tran.py

// Scalar step control: written by thread 0 only, read after a barrier.
struct Ctl {
  double t, h, t1, t2, h_eff, t_new, c0, chunk_t_last;
  long long row0, bp_i, si, naccept, nreject, nnewton, nsteps, nrej_run,
      hold, fail, iord, it;
  int hit_bp, use_be, run;
  int nsaved;
};

// max over the block, NaN ignored (callers test NaN apart)
__device__ double block_max(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double r = red[0];
  for (int w = 1; w < nw; ++w) r = fmax(r, red[w]);
  __syncthreads();
  return r;
}

// Warp 0's Newton solve for n <= 32, n + 1 <= MC: lane i loads row i of
// [A | Ft] into registers; the two-sided equilibration, the elimination and
// the step with its column scaling undone, in the block form's arithmetic.
// Row maxima are in-lane; lane c takes column c's maximum over the
// row-scaled rows from A in shared memory, in the block form's row order.
// rs (n doubles of shared memory) carries the row factors, then the column
// factors. Writes dx (undamped) and, from lane 0, the maximum of |dx| over
// the node-voltage rows and whether one of them is NaN.
template <int MC>
__device__ __noinline__ void warp_newton(const double* A, const double* Ft,
                                         const double* vmask, int n,
                                         double* rs, double* dx,
                                         double* vstep, int* vnan) {
  const int lane = threadIdx.x & 31, m = n + 1;
  const bool live = lane < n;
  double a[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) a[j] = live && j < n ? A[lane * m + j] : 0.0;
  // the columns from n hold zeros, which change no maximum
  double mx = 0.0;
#pragma unroll
  for (int j = 0; j < MC; ++j) mx = dev::tmax(mx, fabs(a[j]));
  const double rinv = 1.0 / clamp_min(mx, TINY);
  const double bv = live ? rinv * Ft[lane] : 0.0;
#pragma unroll
  for (int j = 0; j < MC; ++j) a[j] = j == n ? bv : a[j] * rinv;
  if (live) rs[lane] = rinv;
  __syncwarp();
  double cmx = 0.0;
  if (live)
    for (int i = 0; i < n; ++i)
      cmx = dev::tmax(cmx, fabs(A[i * m + lane] * rs[i]));
  const double cinv = 1.0 / clamp_min(cmx, TINY);
  __syncwarp();
  if (live) rs[lane] = cinv;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MC; ++j)
    if (j < n) a[j] *= rs[j];
  int r = lane;
  gj::eliminate_warp<double, MC>(a, r, n);
  const double ci = __shfl_sync(gj::FULL, cinv, r & 31);
  double vl = 0.0;
  int vn = 0;
  if (live) {
    // column n (the right-hand side) is in slot 0
    const double d = -((a[0] / gj::column(a, gj::rotated<MC>(r, n))) * ci);
    dx[r] = d;
    if (vmask[r] != 0.0) {
      vl = fmax(vl, fabs(d));
      vn = isnan(d);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    vl = fmax(vl, __shfl_xor_sync(gj::FULL, vl, off));
  vn = __any_sync(gj::FULL, vn);
  if (lane == 0) {
    *vstep = vl;
    *vnan = vn;
  }
}

// warp_newton with the column bound n + 1 rounded up to 8
__device__ void warp_newton_n(const double* A, const double* Ft,
                              const double* vmask, int n, double* rs,
                              double* dx, double* vstep, int* vnan) {
  switch ((n + 8) / 8) {
    case 1: warp_newton<8>(A, Ft, vmask, n, rs, dx, vstep, vnan); break;
    case 2: warp_newton<16>(A, Ft, vmask, n, rs, dx, vstep, vnan); break;
    case 3: warp_newton<24>(A, Ft, vmask, n, rs, dx, vstep, vnan); break;
    case 4: warp_newton<32>(A, Ft, vmask, n, rs, dx, vstep, vnan); break;
    default: warp_newton<40>(A, Ft, vmask, n, rs, dx, vstep, vnan); break;
  }
}

// thread 0: the next trial step from the accepted state in S
__device__ void trial_scalars(Ctl& S, const VmemConfig& cfg,
                              const double* bp) {
  const long long j = S.bp_i < cfg.n_bp - 1 ? S.bp_i : cfg.n_bp - 1;
  const double bp_t = bp[j];
  double h_eff = fmin(fmin(S.h, cfg.hmax), S.chunk_t_last - S.t);
  const double to_bp = bp_t - S.t;
  if (to_bp > 0.0 && to_bp < h_eff * 1.5) h_eff = fmin(h_eff, to_bp);
  h_eff = fmax(h_eff, cfg.hmin);
  S.h_eff = h_eff;
  S.t_new = S.t + h_eff;
  S.hit_bp = S.t_new >= bp_t - 1e-6 * fmax(bp_t, TINY);
  S.use_be = S.iord == 1;
  S.c0 = S.use_be ? 1.0 / h_eff : 2.0 / h_eff;
  S.it = 0;
}

}  // namespace

// WARP_SOLVE: the instance for n <= WARP_SOLVE_MAX, whose Newton solve is
// warp_newton; the other holds the block solve. Two instances, so that the
// block solve's registers do not weigh on the small circuits' iterations.
template <bool WARP_SOLVE>
__global__ void __launch_bounds__(K2_THREADS)
    vmem_kernel(const VmemConfig cfg, const VmemPtrs P) {
  extern __shared__ double sm[];
  __shared__ Ctl S;
  __shared__ double red[32];
  __shared__ int vnan_s;

  const int n = (int)cfg.n, m = n + 1;
  const int tid = threadIdx.x, bs = blockDim.x;
  const long long n_loc = cfg.n_loc;
  const long long rc = cfg.rows_per_chunk, wr = cfg.win_rows;
  const long long* gd = P.gdesc;
  const dev::Dyn dyn = dev::make_dyn(cfg.temp, cfg.gmin, cfg.srcfact);
  // thread 0's phase clocks
  long long ph[N_PHASES] = {};
  long long tick0 = clock64();
  auto tick = [&](int p) {
    if (tid == 0) {
      const long long now = clock64();
      ph[p] += now - tick0;
      tick0 = now;
    }
  };

  const int lda = a_ld(n);
  double* A = sm;                                  // [n][lda]: [A | b]
  double* x = sm + n * lda;                        // vectors of n + 1
  double *x1 = x + m, *x2 = x1 + m, *q = x2 + m, *q1 = q + m, *qd = q1 + m;
  double *xi = qd + m, *rq = xi + m, *xn = rq + m, *dx = xn + m;
  double *F = dx + m, *Q = F + m, *Ft = Q + m, *qc = Ft + m, *qdn = qc + m;
  double *atol = qdn + m, *diff = atol + m, *vmask = diff + m;
  double* cinv = vmask + m;                        // N_VECTORS = 19
  // the block solve's work area (n > WARP_SOLVE_MAX)
  const gjb::SmemWork<double> gw =
      gjb::smem_work<double>(cinv + m, n, block_zw(n));
  double* const sm_end = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(cinv + m) + solve_work_bytes(n));

  // the per-instance locals, in shared memory where they fit
  double *floc = P.floc, *qloc = P.qloc, *ueval = P.ueval, *lims = P.lims;
  double *limacc = P.limacc, *cdx = P.cdx, *jloc = P.jloc, *cloc = P.cloc;
  double* wv = P.wv;
  double* gat = P.gat;
  const int *fq_ptr = P.fq_ptr, *fq_idx = P.fq_idx;
  const int *jc_ptr = P.jc_ptr, *jc_idx = P.jc_idx;
  if (cfg.locals_in_smem) {
    floc = sm_end;
    qloc = floc + n_loc;
    ueval = qloc + n_loc;
    lims = ueval + n_loc;
    limacc = lims + n_loc;
    cdx = limacc + n_loc;
    jloc = cdx + n_loc;
    cloc = jloc + cfg.n_jac;
    wv = cloc + cfg.n_jac;
    gat = wv + cfg.n_inst;
    int* ip = reinterpret_cast<int*>(gat + 2 * (cfg.n_fq + cfg.n_jc));
    const long long len[4] = {n + 1, cfg.n_fq, (long long)n * n + 1,
                              cfg.n_jc};
    const int* src[4] = {P.fq_ptr, P.fq_idx, P.jc_ptr, P.jc_idx};
    const int* dst[4];
    for (int q = 0; q < 4; ++q) {
      for (long long k = tid; k < len[q]; k += bs) ip[k] = src[q][k];
      dst[q] = ip;
      ip += len[q];
    }
    fq_ptr = dst[0];
    fq_idx = dst[1];
    jc_ptr = dst[2];
    jc_idx = dst[3];
  }
  const int n_slots = (int)cfg.n_slots;

  // ---- initial state; the ground slot n of xi and dx reads 0
  for (int i = tid; i < n; i += bs) {
    x[i] = x1[i] = x2[i] = P.x0[i];
    q[i] = q1[i] = P.q0[i];
    qd[i] = P.qdot0[i];
    atol[i] = P.atol[i];
    diff[i] = P.diff[i];
    vmask[i] = P.vmask[i];
  }
  for (long long k = tid; k < n_loc; k += bs) lims[k] = limacc[k] = 0.0;
  if (tid == 0) {
    xi[n] = 0.0;
    dx[n] = 0.0;
    S.t = cfg.t0;
    S.h = cfg.h0;
    S.t1 = cfg.t0 - 1.0;
    S.t2 = cfg.t0 - 2.0;
    S.bp_i = 0; S.si = 1; S.naccept = 0; S.nreject = 0; S.nnewton = 0;
    S.nsteps = 0; S.nrej_run = 0; S.hold = 0; S.fail = 0; S.iord = 1;
  }
  __syncthreads();

  // all threads: the trial's vectors and every source's waveform value
  auto trial_vectors = [&]() {
    const double c0 = S.c0, h_eff = S.h_eff, t_new = S.t_new;
    const bool use_be = S.use_be, pred = S.naccept >= 1;
    const double dt1 = fmax(S.t - S.t1, TINY);
    for (int i = tid; i < n; i += bs) {
      rq[i] = c0 * q[i] + (use_be ? 0.0 : qd[i]);
      xi[i] = pred ? x[i] + (x[i] - x1[i]) / dt1 * h_eff : x[i];
    }
    for (int s = tid; s < n_slots; s += bs) {
      const int idx = P.slot_inst[s];
      if (idx < 0) continue;
      const long long* G = gd + P.slot_group[s] * GD_STRIDE;
      if (G[GD_WAVE] < 0) continue;
      const int W = (int)G[GD_W];
      wv[idx] = dev::eval_wave(
          P.wkind[idx], P.wcoef + G[GD_WAVE] + (idx - G[GD_INST]) * W, W,
          t_new);
    }
  };

  for (long long ci = 0; ci < cfg.n_chunks; ++ci) {
    if (tid == 0) {
      const long long last = (ci + 1) * rc - 1 < cfg.n_save - 1
                                 ? (ci + 1) * rc - 1 : cfg.n_save - 1;
      S.chunk_t_last = cfg.t0 + (double)last * cfg.dt_save;
      S.row0 = ci * rc;
      trial_scalars(S, cfg, P.bp);
    }
    __syncthreads();
    // rows this chunk never crosses keep its entry state
    for (long long e = tid; e < rc * n; e += bs)
      P.xs[S.row0 * n + e] = x[e % n];
    trial_vectors();
    __syncthreads();

    for (;;) {
      if (tid == 0)
        S.run = S.t < S.chunk_t_last - 0.01 * cfg.dt_save && S.fail == 0
                && S.nsteps < cfg.max_steps && S.si < cfg.n_save;
      __syncthreads();
      if (!S.run) break;
      tick(PH_STEP);
      const double c0 = S.c0;

      // ---- device evaluation, one thread per instance slot (each group
      // on warps of its own, so the models do not diverge in a warp)
      for (int s = tid; s < n_slots; s += bs) {
        const int idx = P.slot_inst[s];
        if (idx < 0) continue;
        const long long* G = gd + P.slot_group[s] * GD_STRIDE;
        const int nl = (int)G[GD_NL], li = idx - (int)G[GD_INST];
        const int* cn = P.conn + G[GD_CONN] + li * nl;
        const long long lo = G[GD_LOC] + li * loc_stride(nl);
        const long long jo = G[GD_JAC] + (long long)li * jac_stride(nl);
        double u[dev::MAX_NL], up[dev::MAX_NL];
        for (int a = 0; a < nl; ++a) {
          u[a] = xi[cn[a]];
          up[a] = lims[lo + a];
        }
        dev::eval_model((int)G[GD_MODEL], u, up,
                        P.par + G[GD_PAR] + li * G[GD_NPAR],
                        G[GD_WAVE] >= 0 ? wv[idx] : 0.0, dyn, floc + lo,
                        qloc + lo, jloc + jo, cloc + jo, ueval + lo);
      }
      __syncthreads();
      tick(PH_EVAL);

      // ---- assembly through the gather plans (fixed summation order):
      // one parallel pass lays every contribution out in plan order, then
      // each row and entry sums its contiguous run, loads ahead of the sums
      {
        const int nfq = (int)cfg.n_fq, njc = (int)cfg.n_jc;
        for (int k = tid; k < nfq; k += bs) {
          const int i = fq_idx[k];
          gat[k] = floc[i];
          gat[nfq + k] = qloc[i];
        }
        double* gj = gat + 2 * nfq;
        for (int k = tid; k < njc; k += bs) {
          const int i = jc_idx[k];
          gj[k] = jloc[i];
          gj[njc + k] = cloc[i];
        }
      }
      __syncthreads();
      for (int r = tid; r < n; r += bs) {
        const double* gf = gat;
        const double* gq = gat + cfg.n_fq;
        double fr = 0.0, qr = 0.0;
        for (int k = fq_ptr[r]; k < fq_ptr[r + 1]; ++k) {
          fr += gf[k];
          qr += gq[k];
        }
        fr = fr + cfg.gshunt * xi[r] * vmask[r];
        F[r] = fr;
        Q[r] = qr;
        Ft[r] = fr + c0 * qr - rq[r];
      }
      for (int e = tid; e < n * n; e += bs) {
        const int r = e / n, c = e - r * n;
        const double* gj = gat + 2 * cfg.n_fq;
        const double* gc = gj + cfg.n_jc;
        double g = 0.0, cc = 0.0;
        for (int k = jc_ptr[e]; k < jc_ptr[e + 1]; ++k) {
          g += gj[k];
          cc += gc[k];
        }
        if (r == c) g = g + cfg.gshunt * vmask[r];
        A[r * lda + c] = g + c0 * cc;
      }
      __syncthreads();
      tick(PH_ASSEMBLE);

      // ---- the Newton step of the equilibrated system, and the largest
      // node-voltage move for the max_dv damping
      double vstep;
      bool vstep_nan;
      if constexpr (WARP_SOLVE) {
        if (tid < 32)
          warp_newton_n(A, Ft, vmask, n, cinv, dx, &red[0], &vnan_s);
        __syncthreads();
        vstep = red[0];
        vstep_nan = vnan_s != 0;
      } else {
        // two-sided equilibration: rows, then columns; b = Dr Ft
        for (int r = tid; r < n; r += bs) {
          double mx = 0.0;
          for (int c = 0; c < n; ++c)
            mx = dev::tmax(mx, fabs(A[r * lda + c]));
          const double rinv = 1.0 / clamp_min(mx, TINY);
          for (int c = 0; c < n; ++c) A[r * lda + c] *= rinv;
          A[r * lda + n] = rinv * Ft[r];
        }
        __syncthreads();
        for (int c = tid; c < n; c += bs) {
          double mx = 0.0;
          for (int r = 0; r < n; ++r)
            mx = dev::tmax(mx, fabs(A[r * lda + c]));
          cinv[c] = 1.0 / clamp_min(mx, TINY);
        }
        __syncthreads();
        for (int e = tid; e < n * n; e += bs) {
          const int r = e / n, c = e - r * n;
          A[r * lda + c] *= cinv[c];
        }
        __syncthreads();
        gjb::eliminate_smem<K2_THREADS>(A, n, m, lda, gw);
        // the step with its column scaling undone: unknown i is the right-
        // hand side of step i's pivot slot over its pivot
        double vloc = 0.0;
        int vnan = 0;
        for (int i = tid; i < n; i += bs) {
          const double d =
              -((A[gw.ps[i] * lda + n] / gw.dg[i]) * cinv[i]);
          dx[i] = d;
          if (vmask[i] != 0.0) {
            vloc = fmax(vloc, fabs(d));
            vnan |= isnan(d);
          }
        }
        vstep = block_max(vloc, red);
        vstep_nan = __syncthreads_or(vnan);
      }
      tick(PH_SOLVE);
      // ---- damped so no node voltage moves more than max_dv
      const double scale = (cfg.max_dv > 0.0 && !vstep_nan)
                               ? fmin(1.0, cfg.max_dv / fmax(vstep, TINY))
                               : 1.0;
      int okdx = 1, okres = 1, badl = 0;
      for (int i = tid; i < n; i += bs) {
        const double d = dx[i] * scale;
        const double v = xi[i] + d;
        dx[i] = d;
        xn[i] = v;
        const double tol = cfg.reltol * dev::tmax(fabs(v), fabs(xi[i]))
                           + atol[i];
        okdx &= fabs(d) <= tol;
        const double rows = fabs(F[i]) + fabs(c0 * Q[i]) + fabs(rq[i]);
        okres &= fabs(Ft[i]) <= RES_EPS * rows + atol[i];
        badl |= !isfinite(v);
      }
      const bool ok_dx = __syncthreads_and(okdx);
      const bool ok_res = __syncthreads_and(okres);
      const bool bad = __syncthreads_or(badl);
      if (bad)
        for (int i = tid; i < n; i += bs) xn[i] = xi[i];

      // ---- LTE on the differential rows
      const double t = S.t, t1 = S.t1, t2 = S.t2, tn = S.t_new;
      const double he = S.h_eff;
      const bool use_be = S.use_be;
      double rloc = 0.0;
      int rnan = 0;
      for (int i = tid; i < n; i += bs) {
        if (diff[i] == 0.0) continue;
        const double d1a = (xn[i] - x[i]) / fmax(tn - t, TINY);
        const double d1b = (x[i] - x1[i]) / fmax(t - t1, TINY);
        const double d1c = (x1[i] - x2[i]) / fmax(t1 - t2, TINY);
        const double d2a = (d1a - d1b) / fmax(tn - t1, TINY);
        const double d2b = (d1b - d1c) / fmax(t - t2, TINY);
        const double d3 = (d2a - d2b) / fmax(tn - t2, TINY);
        const double lte = use_be ? he * he * fabs(d2a)
                                  : 0.5 * pow(he, 3.0) * fabs(d3);
        const double etol = TRTOL * (cfg.reltol * dev::tmax(fabs(xn[i]),
                                                            fabs(x[i]))
                                     + atol[i]);
        const double ratio = lte / etol;
        rloc = fmax(rloc, ratio);
        rnan |= isnan(ratio);
      }
      double enorm = block_max(rloc, red);
      const bool enan = __syncthreads_or(rnan);

      tick(PH_CHECK);

      // ---- step decision: every thread computes it from the same values
      const long long it = S.it + 1;
      const bool conv = (ok_dx || ok_res) && !bad;
      const bool newton_done = conv || bad || it >= cfg.max_newton;
      if (S.naccept < 2) enorm = 0.0;
      else if (enan) enorm = INFINITY;
      const bool accept = newton_done && conv
                          && (enorm <= 1.0 || he <= cfg.hmin * 1.01);
      const bool reject = newton_done && !accept;
      double fac = conv ? fmin(fmax(0.9 * pow(fmax(enorm, 1e-10),
                                              -1.0 / 3.0), 0.02), GROW_MAX)
                        : NEWTON_FAIL_CUT;
      if (accept && S.hold > 0) fac = fmin(fac, 1.0);
      double h_next = fmin(fmax(he * fac, cfg.hmin), cfg.hmax);
      if (!(isfinite(h_next) && h_next > 0.0)) h_next = cfg.hmin;
      const bool fail_now = reject && he <= cfg.hmin * 1.01;

      if (accept) {
        // charge update Qc = Q + C dx from the per-instance C blocks
        for (int s = tid; s < n_slots; s += bs) {
          const int idx = P.slot_inst[s];
          if (idx < 0) continue;
          const long long* G = gd + P.slot_group[s] * GD_STRIDE;
          const int nl = (int)G[GD_NL], li = idx - (int)G[GD_INST];
          const int* cn = P.conn + G[GD_CONN] + li * nl;
          const long long lo = G[GD_LOC] + li * loc_stride(nl);
          const double* Cl = cloc + G[GD_JAC]
                             + (long long)li * jac_stride(nl);
          for (int a = 0; a < nl; ++a) {
            double acc = 0.0;
            for (int b = 0; b < nl; ++b) acc += Cl[a * nl + b] * dx[cn[b]];
            cdx[lo + a] = acc;
          }
        }
        if (tid == 0) S.nsaved = 0;
        __syncthreads();
        for (int r = tid; r < n; r += bs) {
          double s = 0.0;
          for (int k = fq_ptr[r]; k < fq_ptr[r + 1]; ++k)
            s += cdx[fq_idx[k]];
          qc[r] = Q[r] + s;
          qdn[r] = c0 * qc[r] - rq[r];
        }
        // the save rows in (t, t_new], through the window of wr rows
        long long k0 = (long long)floor((t - cfg.t0) / cfg.dt_save) + 1
                       - S.row0;
        k0 = k0 > 0 ? k0 : 0;
        k0 = k0 < rc - wr ? k0 : rc - wr;
        const long long base = S.row0 + k0;
        int cnt = 0;
        for (long long w = tid; w < wr; w += bs) {
          const double wt = cfg.t0 + (double)(base + w) * cfg.dt_save;
          cnt += (wt > t + 1e-37) && (wt <= tn + 1e-37);
        }
        if (cnt) atomicAdd(&S.nsaved, cnt);   // integer: order-free
        for (long long e = tid; e < wr * n; e += bs) {
          const long long w = e / n;
          const int i = (int)(e - w * n);
          const double wt = cfg.t0 + (double)(base + w) * cfg.dt_save;
          if (!((wt > t + 1e-37) && (wt <= tn + 1e-37))) continue;
          const double wf = clip((wt - t) / fmax(tn - t, TINY), 0.0, 1.0);
          P.xs[(base + w) * n + i] = x[i] + wf * (xn[i] - x[i]);
        }
        __syncthreads();
        for (int i = tid; i < n; i += bs) {
          x2[i] = x1[i];
          x1[i] = x[i];
          x[i] = xn[i];
          q1[i] = q[i];
          q[i] = qc[i];
          qd[i] = qdn[i];
        }
      }

      // ---- limiter states: roll back on a bad iterate, commit on accept,
      // restore the last accepted step's on reject
      for (long long k = tid; k < n_loc; k += bs) {
        const double ln = bad ? lims[k] : ueval[k];
        if (accept) {
          limacc[k] = ln;
          lims[k] = ln;
        } else {
          lims[k] = newton_done ? limacc[k] : ln;
        }
      }
      __syncthreads();
      tick(PH_ACCEPT);

      if (tid == 0) {
        if (accept) {
          S.t2 = S.t1;
          S.t1 = S.t;
          S.t = tn;
          S.iord = S.hit_bp ? 1 : 2;
          if (S.hit_bp) S.bp_i += 1;
          S.si += S.nsaved;
        } else if (reject && !conv) {
          S.iord = 1;
        }
        if (newton_done) S.h = h_next;
        S.naccept += accept;
        S.nreject += reject;
        S.nnewton += 1;
        S.nsteps += newton_done;
        if (fail_now || S.nrej_run > MAX_REJECT_RUN) S.fail = 1;
        S.nrej_run = accept ? 0 : S.nrej_run + reject;
        S.hold = reject ? HOLD_STEPS
                        : (accept ? (S.hold > 1 ? S.hold - 1 : 0) : S.hold);
        if (newton_done) trial_scalars(S, cfg, P.bp);
        else S.it = it;
      }
      __syncthreads();
      if (newton_done) {
        trial_vectors();
      } else {
        for (int i = tid; i < n; i += bs) xi[i] = xn[i];
      }
      __syncthreads();
    }
  }

  if (tid == 0) {
    const bool ran_out = S.nsteps >= cfg.max_steps
                         && S.t < cfg.tstop * (1.0 - 1e-6);
    P.stats[0] = S.naccept;
    P.stats[1] = S.nreject;
    P.stats[2] = S.nnewton;
    P.stats[3] = S.fail + (ran_out ? 1 : 0);
    P.stats[4] = S.nsteps;
    for (int p = 0; p < N_PHASES; ++p) P.stats[PHASE0 + p] = ph[p];
  }
  for (int i = tid; i < n; i += bs) {
    P.fin[i] = x[i];
    P.fin[n + i] = q[i];
    P.fin[2 * n + i] = qd[i];
  }
}

// The device-evaluation entries: the same device functions on given
// inputs, for holding them against the twin's group evaluation.
__global__ void eval_group_kernel(int model, int n_inst, int nl,
                                  const double* u, const double* up,
                                  const double* par, int npar,
                                  const double* wv, dev::Dyn d, double* f,
                                  double* q, double* J, double* C,
                                  double* ue) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_inst) return;
  double uu[dev::MAX_NL], pp[dev::MAX_NL];
  for (int a = 0; a < nl; ++a) {
    uu[a] = u[i * nl + a];
    pp[a] = up[i * nl + a];
  }
  dev::eval_model(model, uu, pp, par + (long long)i * npar, wv[i], d,
                  f + i * nl, q + i * nl, J + i * nl * nl, C + i * nl * nl,
                  ue + i * nl);
}

__global__ void eval_waves_kernel(const long long* kind, const double* coef,
                                  int W, int n_inst, const double* ts,
                                  int n_t, double* out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n_t * n_inst) return;
  const int ti = (int)(e / n_inst), i = (int)(e - (long long)ti * n_inst);
  out[e] = dev::eval_wave(kind[i], coef + (long long)i * W, W, ts[ti]);
}

extern "C" {

// Runs one transient; returns the cudaError_t of the launch (0 on success).
int vmem_tran_f64(const VmemConfig* cfg, const VmemPtrs* ptrs, int threads,
                  void* stream) {
  if (threads != K2_THREADS) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)cfg->n;
  size_t smem = sizeof(double) * (n * a_ld((int)n) + N_VECTORS * (n + 1)) +
                solve_work_bytes((int)n);
  if (cfg->locals_in_smem)
    smem += sizeof(double) * (size_t)(6 * cfg->n_loc + 2 * cfg->n_jac
                                      + cfg->n_inst
                                      + 2 * (cfg->n_fq + cfg->n_jc))
            + sizeof(int) * (size_t)(n + 1 + cfg->n_fq + n * n + 1
                                     + cfg->n_jc);
  const void* fn = n <= (size_t)WARP_SOLVE_MAX
                       ? (const void*)vmem_kernel<true>
                       : (const void*)vmem_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= (size_t)WARP_SOLVE_MAX)
    vmem_kernel<true><<<1, threads, smem, (cudaStream_t)stream>>>(*cfg, *ptrs);
  else
    vmem_kernel<false><<<1, threads, smem, (cudaStream_t)stream>>>(*cfg,
                                                                   *ptrs);
  return (int)cudaGetLastError();
}

int vmem_eval_group_f64(int model, int n_inst, int nl, const void* u,
                        const void* up, const void* par, int npar,
                        const void* wv, double temp, double gmin,
                        double srcfact, void* f, void* q, void* J, void* C,
                        void* ue, void* stream) {
  if (n_inst <= 0) return 0;
  const dev::Dyn d = dev::make_dyn(temp, gmin, srcfact);
  const int threads = 128;
  eval_group_kernel<<<(n_inst + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      model, n_inst, nl, static_cast<const double*>(u),
      static_cast<const double*>(up), static_cast<const double*>(par), npar,
      static_cast<const double*>(wv), d, static_cast<double*>(f),
      static_cast<double*>(q), static_cast<double*>(J),
      static_cast<double*>(C), static_cast<double*>(ue));
  return (int)cudaGetLastError();
}

int vmem_eval_waves_f64(const void* kind, const void* coef, int W,
                        int n_inst, const void* ts, int n_t, void* out,
                        void* stream) {
  const long long total = (long long)n_t * n_inst;
  if (total <= 0) return 0;
  const int threads = 128;
  eval_waves_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                      0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(kind), static_cast<const double*>(coef),
      W, n_inst, static_cast<const double*>(ts), n_t,
      static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
