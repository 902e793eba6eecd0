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
// What bounds it on this card: the latency of one serial Newton chain on
// one SM; the bytes and operations are negligible. An iteration is a chain
// of dependent phases, each latency-bound: the device evaluation (one warp
// runs a whole device group, so a MOSFET's dual-number code sets its
// length), the assembly, the elimination (a shuffle-and-divide chain per
// pivot), the tests and the step control, with a hand-over between threads
// (a block barrier, values through shared memory) between them.
//
// Two instances of the kernel, chosen by n. For n <= WARP_SOLVE_MAX = 32
// (vmem_kernel<true>) warps 1-7 evaluate and warp 0 runs the rest of the
// iteration alone, lane r owning unknown r. The evaluating threads take
// each device group on warps of their own (slots built on the host) and do
// all per-instance work in one pass: the accepted step's C dx, the limiter
// states committed or rolled back, the waveform value of a new step, the
// evaluation, and each contribution's copy to its place in the plans'
// order. The whole block then sums the nonzero entries of A = G + c0*C and
// C and the rows of F and Q, one plan run a thread, in plan order (a lane
// summing a whole row would serialise the DFF's supply rows). Warp 0 keeps
// x, x1, x2, q, qdot and the trial iterate in registers across iterations,
// equilibrates and eliminates in registers (gj::eliminate_warp), damps,
// tests convergence and LTE with warp votes and reductions (the LTE's terms
// that do not depend on the iterate while the other warps evaluate),
// interpolates the save rows 32 at a time, and decides the step with every
// lane computing the same scalars; the charges Qc = Q + C dx of an accepted
// step are summed with the next assembly, in the block instance's order.
// Three block barriers an iteration: the contributions are in place; the
// system is assembled; the next trial is published (two more per chunk).
// Larger circuits, up to n = 127 unknowns as the reference's n + 1 <= 128
// (vmem_kernel<false>), keep the state vectors and the dense [n][n+1]
// system in shared memory and take K1's block form (gjb::eliminate_smem of
// gj_blocked.cuh) on the whole block: the system at an odd row stride (164
// KB with the vectors and the elimination's work area at n = 127), panels
// of 16 columns, one barrier per pivot and two per panel, the trailing
// update on the f64 tensor cores; rows never move, so the step reads each
// unknown through its pivot's slot; thread 0 runs the step control, and
// barriers publish it. Both keep the per-instance locals (f, q, J, C,
// limiter states) and the gather plans in shared memory where they fit
// (else in device memory that stays in L1/L2), compute the same expressions
// in the same order, and go back to the host once per transient.
//
// Thread 0 reads clock64() at each phase boundary of an iteration and adds
// the cycles to stats[PHASE0 + p] (always on; a few cycles a phase). A
// barrier blocks lazily, at the first instruction that needs it; so in the
// warp instance the read after the evaluation waits on the result of the
// barrier, and the evaluation's time falls in its own phase.
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
  // the nonzero entries of the n x n J/C plan (jc_ent)
  long long n_ent;
  // the first instance slot of the largest device group: its thread times
  // that instance's eval_model (stats[GROUP_CYCLES], warp instance); -1
  // for none
  long long timed_slot;
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
                            // nsteps; [WARP_ITERS]: iterations of the warp
                            // instance; [PHASE0 + p]: cycles of phase p;
                            // [GROUP_CYCLES]: the largest group's cycles
                            // in eval_model
  double* fin;              // [3][n]: x, q, qdot at the end
  const int* slot_inst;     // [n_slots] global instance index, or -1
  const int* slot_group;    // [n_slots] its device group
  double* gat;              // [2 (n_fq + n_jc)] contributions in plan order
  const int* jc_ent;        // [n_ent] the entries r n + c of the J/C plan
                            // with contributions, the longest runs first
  const int *fq_pos, *jc_pos;   // [n_loc], [n_jac]: each local's place in
                                // the F/Q or J/C plan, or -1
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
constexpr int N_VECTORS = 19;   // block instance: vectors of n + 1
constexpr int WARP_SOLVE_MAX = 32;   // largest n solved inside one warp
constexpr int K2_THREADS = 256;      // threads of the block (ops/vmem_tran.py)
constexpr int EVAL_THREADS = K2_THREADS - 32;   // warp instance: warps 1-7

// Columns of Z in the block solve's work area: every trailing column of
// the first panel of [A | b].
__host__ __device__ constexpr int block_zw(int n) {
  return (n + 1 - gjb::NB + gjb::CW - 1) / gjb::CW * gjb::CW;
}

// Block instance: the row stride of A in shared memory, and the block
// solve's work area in bytes. Warp instance: the row stride of its A (odd,
// so the lanes, one row each, reach distinct banks). Both mirrored by
// smem_bytes in ops/vmem_tran.py.
__host__ __device__ constexpr int a_ld(int n) { return gjb::smem_ld(n + 1); }
__host__ __device__ constexpr size_t solve_work_bytes(int n) {
  return gjb::smem_work_bytes<double>(n, block_zw(n));
}
__host__ __device__ constexpr int warp_ld(int n) { return n | 1; }

// Dynamic shared memory before the per-instance locals, in bytes: the
// warp instance's rows of A, trial iterate (with the ground slot),
// chunk entry state, F, Q, the node-voltage mask, the accepted step (with
// the ground slot), its Q and its charges, and two lane vectors; the block
// instance's [n][n+1] system, vectors and work area.
__host__ __device__ constexpr size_t solve_smem_bytes(int n) {
  return n <= WARP_SOLVE_MAX
             ? sizeof(double) * ((size_t)n * warp_ld(n) + 8 * n + 66)
             : sizeof(double) * ((size_t)n * a_ld(n) + N_VECTORS * (n + 1))
                   + solve_work_bytes(n);
}

// Phases of a Newton iteration timed by thread 0: device evaluation (in the
// warp instance with the limiter states and the waveforms); assembly;
// equilibration + solve (with the step's max_dv maximum); damping,
// convergence and LTE; accept and save (in the block instance with the
// limiter states); step control (with the chunk set-up).
enum { PH_EVAL, PH_ASSEMBLE, PH_SOLVE, PH_CHECK, PH_ACCEPT, PH_STEP,
       N_PHASES };
constexpr int WARP_ITERS = 5;    // stats slot: warp-instance iterations
constexpr int PHASE0 = 8;        // stats slot of the first phase
// stats slot: clock64 cycles that the thread of cfg.timed_slot spends in
// eval_model, over the transient; one instance of the largest group, which
// its warp evaluates in lockstep, so the group's evaluation time. Counted
// by the warp instance only (the block instance leaves it 0: its solve
// took 8 % more cycles with the count in its evaluation loop)
constexpr int GROUP_CYCLES = 14;
constexpr int N_STATS = 16;      // mirrored by N_STATS in ops/vmem_tran.py

// Scalar step control: in the block instance written by thread 0 only and
// read after a barrier; in the warp instance held by every lane of warp 0.
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

// the next trial step from the accepted state in S
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

// The last save row of chunk ci.
__device__ __forceinline__ long long chunk_last_row(long long ci,
                                                   const VmemConfig& cfg) {
  const long long last = (ci + 1) * cfg.rows_per_chunk - 1;
  return last < cfg.n_save - 1 ? last : cfg.n_save - 1;
}

// Whether the chunk ended with its last row unwritten: its last step
// stopped within 0.01 save intervals short of that row (the test that ends
// the chunk), with no failure. The row then takes the accepted state. (The
// reference kernel leaves it at the chunk's entry state.)
__device__ __forceinline__ bool chunk_row_left(const Ctl& S,
                                               const VmemConfig& cfg) {
  return S.fail == 0 && S.nsteps < cfg.max_steps
         && S.t >= S.chunk_t_last - 0.01 * cfg.dt_save
         && S.chunk_t_last > S.t + 1e-37;
}

// The per-instance locals and the gather plans: in shared memory from `at`
// where they fit (cfg.locals_in_smem; the plans copied in by the whole
// block, read after its next barrier), else in device memory.
struct Locals {
  double *floc, *qloc, *ueval, *lims, *limacc, *cdx, *jloc, *cloc, *wv, *gat;
  const int *fq_ptr, *fq_idx, *jc_ptr, *jc_idx, *jc_ent, *fq_pos, *jc_pos;
};

__device__ __forceinline__ Locals place_locals(const VmemConfig& cfg,
                                               const VmemPtrs& P,
                                               double* at) {
  Locals L{P.floc, P.qloc, P.ueval, P.lims, P.limacc, P.cdx, P.jloc,
           P.cloc, P.wv, P.gat, P.fq_ptr, P.fq_idx, P.jc_ptr, P.jc_idx,
           P.jc_ent, P.fq_pos, P.jc_pos};
  if (!cfg.locals_in_smem) return L;
  const long long n = cfg.n, n_loc = cfg.n_loc;
  L.floc = at;
  L.qloc = L.floc + n_loc;
  L.ueval = L.qloc + n_loc;
  L.lims = L.ueval + n_loc;
  L.limacc = L.lims + n_loc;
  L.cdx = L.limacc + n_loc;
  L.jloc = L.cdx + n_loc;
  L.cloc = L.jloc + cfg.n_jac;
  L.wv = L.cloc + cfg.n_jac;
  L.gat = L.wv + cfg.n_inst;
  int* ip = reinterpret_cast<int*>(L.gat + 2 * (cfg.n_fq + cfg.n_jc));
  const long long len[7] = {n + 1,      cfg.n_fq,  n * n + 1, cfg.n_jc,
                            cfg.n_ent,  n_loc,     cfg.n_jac};
  const int* src[7] = {P.fq_ptr, P.fq_idx, P.jc_ptr, P.jc_idx,
                       P.jc_ent, P.fq_pos, P.jc_pos};
  const int* dst[7];
  for (int q = 0; q < 7; ++q) {
    for (long long k = threadIdx.x; k < len[q]; k += blockDim.x)
      ip[k] = src[q][k];
    dst[q] = ip;
    ip += len[q];
  }
  L.fq_ptr = dst[0];
  L.fq_idx = dst[1];
  L.jc_ptr = dst[2];
  L.jc_idx = dst[3];
  L.jc_ent = dst[4];
  L.fq_pos = dst[5];
  L.jc_pos = dst[6];
  return L;
}

// ---------------------------------------------------------------------------
// the warp instance (n <= WARP_SOLVE_MAX)

// Written by warp 0 before the barrier that starts an iteration or a
// chunk, read by the other warps after it: the trial's time and c0, whether
// it is a new step (its waveform values are due), the limiter update the
// last step decision asks for, whether it accepted a step (whose charges
// are due), whether the chunk runs on, its first row.
struct Pub {
  double t_new, c0;
  long long row0;
  int run, fresh, lim_op, acc;
};

// The limiter update before an instance's next evaluation: none yet;
// accepted (commit the limited point); rejected (back to the last accepted
// step's states); another Newton iteration (advance to the limited point).
enum { LIM_KEEP = 0, LIM_COMMIT, LIM_RESTORE, LIM_ADVANCE };

// The warp instance's shared memory before the locals (solve_smem_bytes).
struct WarpSmem {
  double* A;           // [n][warp_ld(n)]: row r of A = G + c0 C
  double* xi;          // [n + 1]: the trial iterate, ground slot n at 0
  double* x0;          // [n]: the chunk's entry state
  double *F, *Q;       // [n]: the residual and charge rows
  double* vm;          // [n]: the node-voltage mask
  double* dxa;         // [n + 1]: the accepted step, ground slot n at 0
  double *qacc, *qc;   // [n]: its Q, and its charges Q + C dx
  double *cs, *dx;     // [32] each: column factors, the step by unknown
  double* end;
};

__device__ __forceinline__ WarpSmem warp_smem(double* sm, int n) {
  WarpSmem W;
  W.A = sm;
  W.xi = W.A + n * warp_ld(n);
  W.x0 = W.xi + n + 1;
  W.F = W.x0 + n;
  W.Q = W.F + n;
  W.vm = W.Q + n;
  W.dxa = W.vm + n;
  W.qacc = W.dxa + n + 1;
  W.qc = W.qacc + n;
  W.cs = W.qc + n;
  W.dx = W.cs + 32;
  W.end = W.dx + 32;
  return W;
}

// rows the chunk never crosses keep its entry state x0 (every thread)
__device__ __forceinline__ void fill_chunk(const VmemConfig& cfg,
                                           const VmemPtrs& P,
                                           const double* x0,
                                           long long row0) {
  const long long n = cfg.n;
  for (long long e = threadIdx.x; e < cfg.rows_per_chunk * n;
       e += K2_THREADS)
    P.xs[row0 * n + e] = x0[e % n];
}

// The sums of u[k] and of w[k] over k in [k0, k1), each in order from 0,
// four loaded ahead of their sums.
__device__ __forceinline__ void plan_sums(const double* u, const double* w,
                                          int k0, int k1, double& su,
                                          double& sw) {
  double a = 0.0, b = 0.0;
  int k = k0;
#pragma unroll 1
  for (; k + 4 <= k1; k += 4) {
    double p[4], q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = u[k + j];
      q[j] = w[k + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += p[j];
      b += q[j];
    }
  }
#pragma unroll 1
  for (; k < k1; ++k) {
    a += u[k];
    b += w[k];
  }
  su = a;
  sw = b;
}

// The accepted step's C dx of one instance (Cl its local C block, cn its
// unknowns), from the block it was evaluated with, into cdx.
__device__ __forceinline__ void instance_cdx(const double* Cl, const int* cn,
                                             int nl, const double* dxa,
                                             double* cdx) {
  for (int a = 0; a < nl; ++a) {
    double acc = 0.0;
    for (int b = 0; b < nl; ++b) acc += Cl[a * nl + b] * dxa[cn[b]];
    cdx[a] = acc;
  }
}

// Row r of the accepted step's charges, Qc = Q + C dx, the instances' C dx
// summed over the F/Q plan's run in plan order.
__device__ __forceinline__ void charge_row(const Locals& L,
                                           const WarpSmem& W, int r) {
  double s = 0.0;
  for (int k = L.fq_ptr[r]; k < L.fq_ptr[r + 1]; ++k) s += L.cdx[L.fq_idx[k]];
  W.qc[r] = W.qacc[r] + s;
}

// Every thread of the block, once the contributions are in plan order:
// the nonzero entries of A = G + c0 C (jc_ent) and the rows of F and Q,
// each summed over its run of the plans in plan order (fixed summation
// order), a task a thread with the longest runs first, and after an accept
// the rows of its charges. The other entries of A hold their constant
// values (warp_transient).
__device__ __forceinline__ void assemble(const VmemConfig& cfg,
                                         const Locals& L, const WarpSmem& W,
                                         double c0, bool acc) {
  const int n = (int)cfg.n, ld = warp_ld(n), n_ent = (int)cfg.n_ent;
  const double *gf = L.gat, *gq = gf + cfg.n_fq, *gj = gq + cfg.n_fq;
  const double* gc = gj + cfg.n_jc;
  for (int t = threadIdx.x; t < n_ent + n; t += K2_THREADS) {
    double s, sc;
    if (t < n_ent) {
      const int e = L.jc_ent[t], r = e / n, c = e - r * n;
      plan_sums(gj, gc, L.jc_ptr[e], L.jc_ptr[e + 1], s, sc);
      if (r == c) s = s + cfg.gshunt * W.vm[r];
      W.A[r * ld + c] = s + c0 * sc;
    } else {
      const int r = t - n_ent;
      plan_sums(gf, gq, L.fq_ptr[r], L.fq_ptr[r + 1], s, sc);
      W.F[r] = s + cfg.gshunt * W.xi[r] * W.vm[r];
      W.Q[r] = sc;
      if (acc) charge_row(L, W, r);
    }
  }
}

// a / b as IEEE division; a node at rest gives zero numerators, which the
// division's fast path would hand to its slow subroutine
__device__ __forceinline__ double quotient(double a, double b) {
  return gj::quotient(a, b, true);
}

// The largest v over warp 0, for v >= 0 or NaN (NaN the largest): a
// non-negative double orders as its bit pattern, high word then low word.
__device__ __forceinline__ double warp_max(double v) {
  const unsigned long long b = gj::to_bits(v);
  const unsigned hi = static_cast<unsigned>(b >> 32);
  const unsigned lo = static_cast<unsigned>(b);
  const unsigned mhi = __reduce_max_sync(gj::FULL, hi);
  const unsigned mlo = __reduce_max_sync(gj::FULL, hi == mhi ? lo : 0u);
  return gj::from_bits((static_cast<unsigned long long>(mhi) << 32) | mlo);
}

// Warps 1-7, every iteration: per instance slot (each group on warps of its
// own, so the models do not diverge in a warp) an accepted step's C dx, the
// limiter update, the waveform value of a new step, the device evaluation
// of the trial iterate into the locals, and each of its contributions to
// its place in the plans' order (gat); then their share of the assembly.
// Barriers in step with newton_warp.
__device__ __forceinline__ void evaluate_warps(const VmemConfig& cfg,
                                               const VmemPtrs& P,
                                               const Locals& L,
                                               const WarpSmem& W,
                                               const Pub& pub) {
  const int et = threadIdx.x - 32, n_slots = (int)cfg.n_slots;
  const dev::Dyn dyn = dev::make_dyn(cfg.temp, cfg.gmin, cfg.srcfact);
  double *gf = L.gat, *gq = gf + cfg.n_fq, *gj = gq + cfg.n_fq;
  double* gc = gj + cfg.n_jc;
  long long gcyc = 0;   // cycles in eval_model of the slot timed_slot
  for (long long ci = 0; ci < cfg.n_chunks; ++ci) {
    __syncthreads();   // warp 0 sets the chunk up
    __syncthreads();
    fill_chunk(cfg, P, W.x0, pub.row0);
    while (pub.run) {
      const int op = pub.lim_op;
      const bool fresh = pub.fresh != 0, acc = pub.acc != 0;
      for (int s = et; s < n_slots; s += EVAL_THREADS) {
        const int idx = P.slot_inst[s];
        if (idx < 0) continue;
        const long long* G = P.gdesc + P.slot_group[s] * GD_STRIDE;
        const int nl = (int)G[GD_NL], li = idx - (int)G[GD_INST];
        const int* cn = P.conn + G[GD_CONN] + li * nl;
        const long long lo = G[GD_LOC] + li * loc_stride(nl);
        const long long jo = G[GD_JAC] + (long long)li * jac_stride(nl);
        // an accepted step's C dx, before its C block is overwritten
        if (acc)
          instance_cdx(L.cloc + jo, cn, nl, W.dxa, L.cdx + lo);
        // u and up at static indices, so that they stay in registers
        double u[dev::MAX_NL], up[dev::MAX_NL];
#pragma unroll
        for (int a = 0; a < dev::MAX_NL; ++a) {
          if (a >= nl) break;
          double lp = L.lims[lo + a];
          if (op == LIM_COMMIT) {
            lp = L.ueval[lo + a];
            L.limacc[lo + a] = lp;
          } else if (op == LIM_RESTORE) {
            lp = L.limacc[lo + a];
          } else if (op == LIM_ADVANCE) {
            lp = L.ueval[lo + a];
          }
          L.lims[lo + a] = lp;
          u[a] = W.xi[cn[a]];
          up[a] = lp;
        }
        if (G[GD_WAVE] >= 0 && fresh) {
          const int Wc = (int)G[GD_W];
          L.wv[idx] = dev::eval_wave(
              P.wkind[idx], P.wcoef + G[GD_WAVE] + (idx - G[GD_INST]) * Wc,
              Wc, pub.t_new);
        }
        const bool timed = s == cfg.timed_slot;
        const long long c_in = timed ? clock64() : 0;
        dev::eval_model((int)G[GD_MODEL], u, up,
                        P.par + G[GD_PAR] + li * G[GD_NPAR],
                        G[GD_WAVE] >= 0 ? L.wv[idx] : 0.0, dyn,
                        L.floc + lo, L.qloc + lo, L.jloc + jo, L.cloc + jo,
                        L.ueval + lo);
        if (timed) gcyc += clock64() - c_in;
        // each contribution to its place in plan order, the Jacobian's four
        // at a time so that their loads go out ahead of the stores
        for (int a = 0; a < nl; ++a) {
          const int k = L.fq_pos[lo + a];
          if (k < 0) continue;
          gf[k] = L.floc[lo + a];
          gq[k] = L.qloc[lo + a];
        }
        for (int e0 = 0; e0 < nl * nl; e0 += 4) {
          int k[4];
          double gv[4], cv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            k[j] = e0 + j < nl * nl ? L.jc_pos[jo + e0 + j] : -1;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gv[j] = k[j] >= 0 ? L.jloc[jo + e0 + j] : 0.0;
            cv[j] = k[j] >= 0 ? L.cloc[jo + e0 + j] : 0.0;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k[j] < 0) continue;
            gj[k[j]] = gv[j];
            gc[k[j]] = cv[j];
          }
        }
      }
      __syncthreads_or(0);   // the contributions are in place
      assemble(cfg, L, W, pub.c0, acc);
      __syncthreads();       // the system is assembled
      __syncthreads();       // the next trial is published
    }
  }
  if (cfg.timed_slot >= et && (cfg.timed_slot - et) % EVAL_THREADS == 0)
    P.stats[GROUP_CYCLES] = gcyc;
  // the charges of a step accepted last
  if (pub.acc) {
    for (int s = et; s < n_slots; s += EVAL_THREADS) {
      const int idx = P.slot_inst[s];
      if (idx < 0) continue;
      const long long* G = P.gdesc + P.slot_group[s] * GD_STRIDE;
      const int nl = (int)G[GD_NL], li = idx - (int)G[GD_INST];
      instance_cdx(L.cloc + G[GD_JAC] + (long long)li * jac_stride(nl),
                   P.conn + G[GD_CONN] + li * nl, nl, W.dxa,
                   L.cdx + G[GD_LOC] + li * loc_stride(nl));
    }
    __syncthreads();
    for (int r = threadIdx.x; r < (int)cfg.n; r += K2_THREADS)
      charge_row(L, W, r);
    __syncthreads();
  }
}

// Warp 0, lane r owning unknown r (n <= 32, n + 1 <= MC): the whole
// transient after each device evaluation, with its state in registers and
// the step control computed alike by every lane.
template <int MC>
__device__ __forceinline__ void newton_warp(const VmemConfig& cfg,
                                            const VmemPtrs& P,
                                            const Locals& L,
                                            const WarpSmem& W, Pub& pub) {
  const int n = (int)cfg.n, lane = threadIdx.x, ld = warp_ld(n);
  const bool live = lane < n;
  const long long rc = cfg.rows_per_chunk, wr = cfg.win_rows;
  // lane 0's phase clocks
  long long ph[N_PHASES] = {};
  long long tick0 = clock64();
  auto tick = [&](int p) {
    if (lane == 0) {
      const long long now = clock64();
      ph[p] += now - tick0;
      tick0 = now;
    }
  };

  double x = 0.0, q = 0.0, qd = 0.0, atol = 0.0, vmv = 0.0;
  bool dif = false;
  if (live) {
    x = P.x0[lane];
    q = P.q0[lane];
    qd = P.qdot0[lane];
    atol = P.atol[lane];
    dif = P.diff[lane] != 0.0;
    vmv = P.vmask[lane];
  }
  const bool vm = vmv != 0.0;
  double x1 = x, x2 = x, xi = x, rq = 0.0;
  Ctl S;
  S.t = cfg.t0;
  S.h = cfg.h0;
  S.t1 = cfg.t0 - 1.0;
  S.t2 = cfg.t0 - 2.0;
  S.bp_i = 0; S.si = 1; S.naccept = 0; S.nreject = 0; S.nnewton = 0;
  S.nsteps = 0; S.nrej_run = 0; S.hold = 0; S.fail = 0; S.iord = 1;
  long long warp_iters = 0;

  // a new step's trial iterate (predicted after the first accepted step);
  // its charge term rq waits for the charges of the step accepted before
  // it, which the whole block computes with the next assembly
  bool fresh = true, pending = false;
  double c0a = 0.0, rqa = 0.0;
  auto trial = [&]() {
    const double dt1 = fmax(S.t - S.t1, TINY);
    xi = S.naccept >= 1 ? x + (x - x1) / dt1 * S.h_eff : x;
    fresh = true;
  };
  auto take_charges = [&]() {
    if (live) {
      q = W.qc[lane];
      qd = c0a * q - rqa;
    }
    pending = false;
  };
  auto running = [&]() {
    return S.t < S.chunk_t_last - 0.01 * cfg.dt_save && S.fail == 0
           && S.nsteps < cfg.max_steps && S.si < cfg.n_save;
  };

  for (long long ci = 0; ci < cfg.n_chunks; ++ci) {
    __syncthreads();   // the evaluating warps have read the last Pub
    S.chunk_t_last =
        cfg.t0 + (double)chunk_last_row(ci, cfg) * cfg.dt_save;
    S.row0 = ci * rc;
    trial_scalars(S, cfg, P.bp);
    trial();
    S.run = running();
    if (live) {
      W.xi[lane] = xi;
      W.x0[lane] = x;
    }
    if (lane == 0) {
      pub.row0 = S.row0;
      pub.t_new = S.t_new;
      pub.c0 = S.c0;
      pub.fresh = 1;
      pub.run = S.run;
    }
    __syncthreads();
    fill_chunk(cfg, P, W.x0, S.row0);

    while (S.run) {
      tick(PH_STEP);
      // the LTE's terms that do not depend on the iterate, while the other
      // warps evaluate
      const double t = S.t, t1 = S.t1, t2 = S.t2, tn = S.t_new;
      const double he = S.h_eff;
      const double den1a = fmax(tn - t, TINY), den2a = fmax(tn - t1, TINY);
      const double den3 = fmax(tn - t2, TINY);
      const double lte_k = S.use_be ? he * he : 0.5 * pow(he, 3.0);
      double d1b = 0.0, d2b = 0.0;
      if (live && dif) {
        d1b = quotient(x - x1, fmax(t - t1, TINY));
        const double d1c = quotient(x1 - x2, fmax(t1 - t2, TINY));
        d2b = quotient(d1b - d1c, fmax(t - t2, TINY));
      }
      // the contributions of this trial are in place; the barrier blocks
      // lazily, so its result gates the clock read
      if (__syncthreads_or(0) == 0) tick(PH_EVAL);

      // ---- assembly, by the whole block; then lane r takes row r
      assemble(cfg, L, W, S.c0, pending);
      __syncthreads();   // the system is assembled
      const double c0 = S.c0;
      if (fresh) {
        if (pending) take_charges();
        rq = c0 * q + (S.use_be ? 0.0 : qd);
        fresh = false;
      }
      double F = 0.0, Q = 0.0, Ft = 0.0;
      if (live) {
        F = W.F[lane];
        Q = W.Q[lane];
        Ft = F + c0 * Q - rq;
      }
      double a[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j)
        a[j] = live && j < n ? W.A[lane * ld + j] : 0.0;
      tick(PH_ASSEMBLE);

      // ---- the two-sided equilibration of [A | Ft] (row maxima in-lane;
      // lane c takes column c's maximum over the row-scaled rows, in the
      // block form's row order), the elimination, and the step with its
      // column scaling undone; W.cs carries the row factors, then the
      // column factors
      double mx = 0.0;
#pragma unroll
      for (int j = 0; j < MC; ++j) mx = dev::tmax(mx, fabs(a[j]));
      const double rinv = 1.0 / clamp_min(mx, TINY);
      const double bv = live ? rinv * Ft : 0.0;
#pragma unroll
      for (int j = 0; j < MC; ++j) a[j] = j == n ? bv : a[j] * rinv;
      W.cs[lane] = rinv;
      __syncwarp();
      double cmx = 0.0;
      if (live)
        for (int i = 0; i < n; ++i)
          cmx = dev::tmax(cmx, fabs(W.A[i * ld + lane] * W.cs[i]));
      const double cinv = 1.0 / clamp_min(cmx, TINY);
      __syncwarp();
      W.cs[lane] = cinv;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < MC; ++j)
        if (j < n) a[j] *= W.cs[j];
      int r = lane;
      gj::eliminate_warp<double, MC>(a, r, n);
      // lane r ends holding logical row r: unknown r is its right-hand side
      // (column n, in slot 0) over its pivot, through W.dx to lane r
      W.dx[r] = live ? -((a[0] / gj::column(a, gj::rotated<MC>(r, n)))
                         * W.cs[r])
                     : 0.0;
      __syncwarp();
      double d = W.dx[lane];
      // the largest node-voltage move for the max_dv damping, NaN apart
      const bool dnan = vm && isnan(d);
      const double vstep = warp_max(vm && !dnan ? fabs(d) : 0.0);
      const bool vstep_nan = __any_sync(gj::FULL, dnan);
      tick(PH_SOLVE);

      // ---- damped so no node voltage moves more than max_dv
      const double scale = (cfg.max_dv > 0.0 && !vstep_nan)
                               ? fmin(1.0, cfg.max_dv / fmax(vstep, TINY))
                               : 1.0;
      d = d * scale;
      const double v = xi + d;
      const double tol = cfg.reltol * dev::tmax(fabs(v), fabs(xi)) + atol;
      const double rows = fabs(F) + fabs(c0 * Q) + fabs(rq);
      const bool ok_dx = __all_sync(gj::FULL, !live || fabs(d) <= tol);
      const bool ok_res =
          __all_sync(gj::FULL, !live || fabs(Ft) <= RES_EPS * rows + atol);
      const bool bad = __any_sync(gj::FULL, live && !isfinite(v));
      const double xn = bad ? xi : v;

      // ---- LTE on the differential rows
      double ratio = 0.0;
      if (live && dif) {
        const double d1a = quotient(xn - x, den1a);
        const double d2a = quotient(d1a - d1b, den2a);
        const double d3 = quotient(d2a - d2b, den3);
        const double lte = lte_k * fabs(S.use_be ? d2a : d3);
        const double etol =
            TRTOL * (cfg.reltol * dev::tmax(fabs(xn), fabs(x)) + atol);
        ratio = quotient(lte, etol);
      }
      double enorm = warp_max(ratio > 0.0 ? ratio : 0.0);
      const bool enan = __any_sync(gj::FULL, isnan(ratio));
      tick(PH_CHECK);

      // ---- step decision: every lane computes it from the same values
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

      long long nsaved = 0;
      if (accept) {
        // the charges Qc = Q + C dx and qdot = c0 Qc - rq follow with the
        // next assembly (take_charges)
        if (live) {
          W.qacc[lane] = Q;
          W.dxa[lane] = d;
        }
        c0a = c0;
        rqa = rq;
        pending = true;
        // the save rows in (t, t_new], through the window of wr rows: 32
        // candidate rows a round, lane l taking row w0 + l's fraction, from
        // two rows before the first one after t; the rows' times rise with
        // w, so a round that reaches past t_new is the last
        const long long kt = (long long)floor((t - cfg.t0) / cfg.dt_save)
                             + 1 - S.row0;
        long long k0 = kt > 0 ? kt : 0;
        k0 = k0 < rc - wr ? k0 : rc - wr;
        const long long base = S.row0 + k0;
        for (long long w0 = kt - 2 - k0 > 0 ? kt - 2 - k0 : 0; w0 < wr;
             w0 += 32) {
          const long long w = w0 + lane;
          const double wt = cfg.t0 + (double)(base + w) * cfg.dt_save;
          const bool in = w < wr && wt > t + 1e-37 && wt <= tn + 1e-37;
          const double wf =
              clip(gj::quotient(wt - t, fmax(tn - t, TINY), in), 0.0, 1.0);
          unsigned rows = __ballot_sync(gj::FULL, in);
          nsaved += __popc(rows);
          while (rows) {
            const int l = __ffs(rows) - 1;
            rows &= rows - 1;
            const double f = __shfl_sync(gj::FULL, wf, l);
            if (live) P.xs[(base + w0 + l) * n + lane] = x + f * (xn - x);
          }
          if (__any_sync(gj::FULL, w >= wr || !(wt <= tn + 1e-37))) break;
        }
        x2 = x1;
        x1 = x;
        x = xn;
      }
      tick(PH_ACCEPT);

      if (accept) {
        S.t2 = S.t1;
        S.t1 = S.t;
        S.t = tn;
        S.iord = S.hit_bp ? 1 : 2;
        if (S.hit_bp) S.bp_i += 1;
        S.si += nsaved;
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
      ++warp_iters;
      if (newton_done) {
        trial_scalars(S, cfg, P.bp);
        trial();
      } else {
        S.it = it;
        xi = xn;
      }
      S.run = running();
      if (live) W.xi[lane] = xi;
      if (lane == 0) {
        pub.t_new = S.t_new;
        pub.c0 = S.c0;
        pub.fresh = newton_done;
        pub.acc = accept;
        pub.lim_op = accept ? LIM_COMMIT
                            : (newton_done ? LIM_RESTORE : LIM_ADVANCE);
        pub.run = S.run;
      }
      __syncthreads();   // the next trial is published
    }
    if (chunk_row_left(S, cfg)) {
      if (live) P.xs[chunk_last_row(ci, cfg) * n + lane] = x;
      S.si += 1;
    }
  }

  // the charges of a step accepted last (in step with evaluate_warps)
  if (pending) {
    __syncthreads();
    for (int r = lane; r < n; r += K2_THREADS) charge_row(L, W, r);
    __syncthreads();
    take_charges();
  }
  if (lane == 0) {
    const bool ran_out = S.nsteps >= cfg.max_steps
                         && S.t < cfg.tstop * (1.0 - 1e-6);
    P.stats[0] = S.naccept;
    P.stats[1] = S.nreject;
    P.stats[2] = S.nnewton;
    P.stats[3] = S.fail + (ran_out ? 1 : 0);
    P.stats[4] = S.nsteps;
    P.stats[WARP_ITERS] = warp_iters;
    for (int p = 0; p < N_PHASES; ++p) P.stats[PHASE0 + p] = ph[p];
  }
  if (live) {
    P.fin[lane] = x;
    P.fin[n + lane] = q;
    P.fin[2 * n + lane] = qd;
  }
}

__device__ __forceinline__ void warp_transient(const VmemConfig& cfg,
                                               const VmemPtrs& P) {
  extern __shared__ double sm[];
  __shared__ Pub pub;
  const int n = (int)cfg.n, tid = threadIdx.x;
  const WarpSmem W = warp_smem(sm, n);
  const Locals L = place_locals(cfg, P, W.end);
  for (long long k = tid; k < cfg.n_loc; k += K2_THREADS)
    L.lims[k] = L.limacc[k] = 0.0;
  // the entries of A without contributions: G's gshunt on the node-voltage
  // diagonal, the rest 0, as the sums over empty runs give
  const int ld = warp_ld(n);
  for (int e = tid; e < n * n; e += K2_THREADS) {
    const int r = e / n, c = e - r * n;
    W.A[r * ld + c] = r == c ? cfg.gshunt * P.vmask[r] : 0.0;
  }
  for (int i = tid; i < n; i += K2_THREADS) W.vm[i] = P.vmask[i];
  if (tid == 0) {
    W.xi[n] = 0.0;
    W.dxa[n] = 0.0;
    pub.lim_op = LIM_KEEP;
    pub.acc = 0;
  }
  if (tid >= 32) {
    evaluate_warps(cfg, P, L, W, pub);
    return;
  }
  // the column bound n + 1 rounded up to 8
  switch ((n + 8) / 8) {
    case 1: newton_warp<8>(cfg, P, L, W, pub); break;
    case 2: newton_warp<16>(cfg, P, L, W, pub); break;
    case 3: newton_warp<24>(cfg, P, L, W, pub); break;
    case 4: newton_warp<32>(cfg, P, L, W, pub); break;
    default: newton_warp<40>(cfg, P, L, W, pub); break;
  }
}

// ---------------------------------------------------------------------------
// the block instance (n > WARP_SOLVE_MAX)

__device__ __forceinline__ void block_transient(const VmemConfig& cfg,
                                                const VmemPtrs& P) {
  extern __shared__ double sm[];
  __shared__ Ctl S;
  __shared__ double red[32];

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
  // the block solve's work area
  const gjb::SmemWork<double> gw =
      gjb::smem_work<double>(cinv + m, n, block_zw(n));
  double* const sm_end = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(cinv + m) + solve_work_bytes(n));

  // the per-instance locals, in shared memory where they fit
  const Locals L = place_locals(cfg, P, sm_end);
  double *floc = L.floc, *qloc = L.qloc, *ueval = L.ueval, *lims = L.lims;
  double *limacc = L.limacc, *cdx = L.cdx, *jloc = L.jloc, *cloc = L.cloc;
  double *wv = L.wv, *gat = L.gat;
  const int *fq_ptr = L.fq_ptr, *fq_idx = L.fq_idx;
  const int *jc_ptr = L.jc_ptr, *jc_idx = L.jc_idx;
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
      S.chunk_t_last =
          cfg.t0 + (double)chunk_last_row(ci, cfg) * cfg.dt_save;
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
      const double vstep = block_max(vloc, red);
      const bool vstep_nan = __syncthreads_or(vnan) != 0;
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
    const bool row_left = chunk_row_left(S, cfg);
    if (row_left)
      for (int i = tid; i < n; i += bs)
        P.xs[chunk_last_row(ci, cfg) * n + i] = x[i];
    __syncthreads();   // every thread has read S
    if (row_left && tid == 0) S.si += 1;
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

}  // namespace

// The two instances, chosen by n: their registers and their control stay
// apart.
template <bool WARP_SOLVE>
__global__ void __launch_bounds__(K2_THREADS)
    vmem_kernel(const VmemConfig cfg, const VmemPtrs P) {
  if constexpr (WARP_SOLVE)
    warp_transient(cfg, P);
  else
    block_transient(cfg, P);
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
  size_t smem = solve_smem_bytes((int)n);
  if (cfg->locals_in_smem)
    smem += sizeof(double) * (size_t)(6 * cfg->n_loc + 2 * cfg->n_jac
                                      + cfg->n_inst
                                      + 2 * (cfg->n_fq + cfg->n_jc))
            + sizeof(int) * (size_t)(n + 1 + cfg->n_fq + n * n + 1
                                     + cfg->n_jc + cfg->n_ent + cfg->n_loc
                                     + cfg->n_jac);
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
