"""Kernel K2: the whole adaptive transient of a small dense circuit in one
CUDA launch, and its plain PyTorch twin.

`vmem_tran(cc, tspan, ...)` runs a transient analysis. The operating point
is solved on the host side through the port's `dc` (and so through kernel
K1 on a CUDA circuit); then the integrator runs: on a CUDA circuit the
hand-written Hopper kernel `csrc/vmem_tran.cu` (one launch per transient),
on a CPU circuit `integrate_plain`, the same algorithm in torch ops with
one Newton iteration per pass of a Python loop. There is no fallback
between the two: a CUDA circuit launches the kernel or raises.
`vmem_tran_plain` runs the twin on any device.

Replaces the TPU kernel `archive/pallas_tran.py::make_kernel.kernel`
(entry `vmem_tran`). It computes what that kernel computes, per Newton
iteration: every source's waveform once per trial step, the device
residuals with their local Jacobians (limited, and linearized at the
limited point), the dense assembly of F, Q and A = G + c0*C, a two-sided
equilibrated Gauss-Jordan solve, the max_dv damping, the ok_dx | ok_res
convergence test, divided-difference LTE control (BE after a breakpoint,
then trapezoidal), breakpoint hits and the interpolation of each accepted
step onto the save grid. Its step-control constants are the reference
kernel's, unchanged, so that step decisions stay comparable with it:
RES_EPS, the reltol floor, TRTOL, GROW_MAX, NEWTON_FAIL_CUT, the 3-step
hold after a reject and the failure after more than 100 rejects in a row.
So are its step-limiting rules: hmax capped to (win_rows - 2) save
intervals, steps capped at the last save time of their chunk of
`rows_per_chunk` rows (rows a chunk never crosses keep its entry state),
hmin and h0. One departure: a chunk whose last step stops within 0.01 save
intervals short of its last row writes that row from the accepted state,
where the reference leaves it at the chunk's entry state. The reference is
f32 because Mosaic has no f64; K2 and its twin are f64 throughout.

Device functions: every built-in model's, hand-written in
`csrc/devices.cuh`, and for a Verilog-A model the one that `va/cuda.py`
emits from the compiler's statements (the reference kernel refuses
Verilog-A). A circuit with Verilog-A models runs a K2 library built with
their generated header (`VaLibrary`, built once per header text and
loaded once a process); its twin evaluates them through the compiler's
torch interpreter.

What bounds K2 on the H100 is the latency of one serial Newton chain on
one SM, not bytes or operations: an iteration is a chain of dependent,
latency-bound phases (the device evaluation, whose length one warp running
a whole MOSFET or BJT group sets; the assembly; the elimination; the tests;
the step control) with a hand-over between threads after each. For n <= 32
(`WARP_SOLVE_MAX`) warps 1-7 evaluate the devices, each group on warps of
its own (host-built slots), doing all per-instance work in one pass (the
accepted step's C dx, the limiter states, the waveforms, the evaluation,
and each contribution's copy to its place in plan order through the
inverse plans `fq_pos`, `jc_pos`); the whole block sums the nonzero
entries of A and the rows of F and Q, one plan run a thread (`jc_ent`);
and warp 0 runs the rest of the iteration alone, lane r owning unknown r:
its state in registers across iterations, the equilibration and
elimination in registers (K1's warp variant), the tests and the LTE with
warp votes and reductions, the save rows and the step decision, every lane
computing the same scalars. Three block barriers an iteration (the
contributions are in place; the system is assembled; the next trial is
published); `sol.k2_warp_iterations` counts the iterations that ran so.
Above that, up to `MAX_UNKNOWNS`, the whole block runs K1's blocked form
(`gj_solve_blocked_plain` in the twin) on the system in shared memory, with
thread 0 deciding the step and barriers publishing it. The two compute the
same expressions in the same order. Both keep the per-instance locals and
the gather plans on chip where they fit (`locals_bytes`), touch device
memory only for the save rows, and return to the host once per transient.
Thread 0 times each phase of an iteration with clock64(); `integrate`
returns the cycles per phase (`PHASES`). Lane batching and TMA are later
work.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
from torch.func import vmap

from .. import obs
from ..config import DTYPE, ITYPE
from ..mna.assemble import (_group_eval, _lane_dyn, make_assembler,
                            make_rhs_assembler, make_sorted_scatter,
                            pad_state)
from ..mna.devices import (BJT, CAPACITOR, CCCS, CCVS, CLASS_V, DIODE,
                           DIODE_RS, INDUCTOR, ISOURCE, MOSFET1, MUTUAL,
                           RESISTOR, VCCS, VCVS, VSOURCE)
from ..mna.newton import abstol_vector
from ..mna.spec import MODE_TRAN, MODE_TRANOP, T0_K, DynSpec, make_dynspec
from ..mna.waveforms import WAVE_DC, eval_wave, pack_waveforms
from ..va import cuda as va_cuda
from . import nvcc
from .gj_solve import (PANEL, block_work_bytes, gj_solve_blocked_plain,
                       gj_solve_plain)

# step-control constants of the reference kernel (archive/pallas_tran.py)
TRTOL = 7.0
GROW_MAX = 2.0
NEWTON_FAIL_CUT = 0.125
RES_EPS = 8e-7          # residual-test floor
RELTOL_FLOOR = 4e-6
HOLD_STEPS = 3          # steps that may not grow after a reject
MAX_REJECT_RUN = 100    # rejects in a row before the integrator gives up
GMIN = 1e-12            # junction gmin of the transient (reference: fixed)

#: largest circuit K2 takes: n + 1 <= 128 as the reference; the dense
#: [n, n+1] system, the state vectors and the block solve's work area fill
#: 164 KB of shared memory
MAX_UNKNOWNS = 127
#: most instances of one device group (the reference's lane width)
MAX_INST = 128
#: state vectors of length n + 1 that the block instance keeps in shared
#: memory
_N_VECTORS = 19
_THREADS = 256
#: largest circuit whose Newton solve runs inside one warp
WARP_SOLVE_MAX = 32
#: the kernel's statistics slots (csrc/vmem_tran.cu: N_STATS, PHASE0,
#: WARP_ITERS, the Newton iterations that ran on the warp-resident path, and
#: GROUP_CYCLES, the largest device group's cycles in its device function)
_N_STATS, _PHASE0, _WARP_ITERS, _GROUP_CYCLES = 16, 8, 5, 14
#: phases of a Newton iteration that K2's thread 0 times, in slot order
PHASES = ("device evaluation", "assembly", "equilibration + solve",
          "damping, convergence, LTE", "accept and save", "step control")

_DIODE_P = ("is", "n", "cjo", "vj", "m", "fc", "tt", "bv", "ibv", "area",
            "rs")
_MOS_P = ("type", "vth", "kp", "lambda", "w", "l", "cgs", "cgd", "cgb",
          "cbd", "cbs", "is")
_BJT_P = ("type", "is", "bf", "br", "nf", "nr", "vaf", "var", "cje", "vje",
          "mje", "cjc", "vjc", "mjc", "tf", "tr", "fc", "area")
#: models K2 has a device function for: model -> (id in csrc/devices.cuh,
#: parameter order of its packed row). Every built-in model: the reference
#: kernel traces any model that is not Verilog-A. A Verilog-A model has one
#: where `va/cuda.py` emits it: its id and row come from the circuit's
#: `VaLibrary`.
KERNEL_MODELS = {RESISTOR: (0, ("r",)), CAPACITOR: (1, ("c",)),
                 VSOURCE: (2, ()), ISOURCE: (3, ()), DIODE: (4, _DIODE_P),
                 DIODE_RS: (5, _DIODE_P), MOSFET1: (6, _MOS_P),
                 INDUCTOR: (7, ("l",)), MUTUAL: (8, ("m",)),
                 VCVS: (9, ("gain",)), VCCS: (10, ("gm",)),
                 CCCS: (11, ("gain",)), CCVS: (12, ("r",)),
                 BJT: (13, _BJT_P)}


def _is_va(model) -> bool:
    return model.name.startswith("va:")


def supported(cc) -> bool:
    """Can this circuit run through K2? The reference kernel's rule (dense,
    n + 1 <= 128, <= 128 instances per group, no B-source models, no $limit
    sites or delays), and every model must be one K2 has a device function
    for: every built-in model, and a Verilog-A model that `va/cuda.py`
    emits (`va_cuda.refusal` says why it does not). The reference kernel
    refuses every Verilog-A model."""
    if cc.bbd is not None or cc.n + 1 > MAX_UNKNOWNS + 1:
        return False
    for g in cc.groups:
        m = g.model
        if m.residual_lim is not None or m.n_delay_sites:
            return False
        if m.name.startswith("bsrc") or g.n_inst > MAX_INST:
            return False
        if _is_va(m):
            if va_cuda.refusal(m) is not None:
                return False
        elif m not in KERNEL_MODELS:
            return False
    return True


@dataclasses.dataclass
class VaLibrary:
    """The Verilog-A models of one circuit as K2 device functions: each
    model's id and emitted form, the header of K2's library for them
    (`va_cuda.header`), on a CUDA circuit that library, built once per
    header text and loaded once a process (`load_library`), and each
    group's parameter rows (set by `prepare`)."""
    models: dict              # model -> (id, va_cuda.EmittedModel)
    header: str
    lib: object = None
    rows: dict = dataclasses.field(default_factory=dict)  # model -> [I, P]


def va_library(models, device) -> VaLibrary:
    """The library of the Verilog-A `models` (distinct, in order)."""
    emitted = [va_cuda.emit(m) for m in models]
    head = va_cuda.header(emitted)
    return VaLibrary(
        models={m: (va_cuda.FIRST_ID + k, em)
                for k, (m, em) in enumerate(zip(models, emitted))},
        header=head,
        lib=load_library(head) if torch.device(device).type == "cuda"
        else None)


#: dynamic shared memory one K2 block may use (227 KB less the kernel's
#: static scratch)
SMEM_MAX = 232448 - 2048


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one K2 launch before the locals
    (csrc/vmem_tran.cu: solve_smem_bytes). n <= WARP_SOLVE_MAX: the rows of
    A at the odd stride n | 1, the trial iterate with its ground slot,
    the chunk's entry state, F, Q, the node-voltage mask, the accepted step
    with its ground slot, its Q and its charges, and two vectors of 32.
    Above: [n, n+1] (rows at an odd stride), the vectors and the block
    solve's work area."""
    if n <= WARP_SOLVE_MAX:
        return 8 * (n * (n | 1) + 8 * n + 66)
    zw = -(-(n + 1 - PANEL) // PANEL) * PANEL
    return 8 * (n * ((n + 1) | 1) + _N_VECTORS * (n + 1)) \
        + block_work_bytes(n, zw, 8)


def locals_bytes(n: int, pk: dict) -> int:
    """What K2 keeps in shared memory besides `smem_bytes` where it fits:
    the per-instance locals (f, q, the limited point, two limiter states
    and C dx, n_loc each; the local Jacobians J and C, n_jac each; the
    source values), the contributions laid out in plan order (f, q, J, C)
    and the F/Q and J/C gather plans with the J/C plan's nonzero entries
    and each local's place in the plans (int32)."""
    n_fq, n_jc = len(pk["fq_idx"]), len(pk["jc_idx"])
    return (8 * (6 * pk["n_loc"] + 2 * pk["n_jac"] + pk["n_inst"]
                 + 2 * (n_fq + n_jc))
            + 4 * (n + 1 + n_fq + n * n + 1 + n_jc + len(pk["jc_ent"])
                   + pk["n_loc"] + pk["n_jac"]))


# ---------------------------------------------------------------------------
# host set-up, shared by the kernel and the twin

@dataclasses.dataclass
class Setup:
    """One transient, ready to integrate: the operating point, the initial
    charges and every scalar of the step control."""
    cc: object
    params: list
    t0: float
    tstop: float
    dt_save: float
    n_save: int
    rows_per_chunk: int
    win_rows: int
    n_chunks: int
    h0: float
    hmax: float
    hmin: float
    reltol: float
    max_steps: int
    bp: np.ndarray            # breakpoints after t0 (tstop last)
    x0: torch.Tensor          # [n]
    q0: torch.Tensor
    qdot0: torch.Tensor
    diff: torch.Tensor        # [n] bool: rows with charge (LTE rows)
    atol: torch.Tensor        # [n]
    vmask: torch.Tensor       # [n] bool: node-voltage rows
    op_converged: torch.Tensor
    op_iters: torch.Tensor
    va: VaLibrary = None      # the circuit's Verilog-A models, if any

    def dyn(self, t):
        """The transient's DynSpec at time t, as the reference kernel
        builds it (its gmin is fixed at 1e-12)."""
        s = self.cc.spec
        return make_dynspec(temp_c=s.temp_c, time=t, gmin=GMIN,
                            gshunt=s.gshunt, srcfact=1.0, mode=MODE_TRAN,
                            device=self.cc.device)


def prepare(cc, tspan, *, dt=None, dtmax=None, n_save=None,
            max_steps=2_000_000, x0=None, uic=False, ic=None,
            rows_per_chunk=512) -> Setup:
    """Operating point, initial charges and step-control scalars
    (the reference's `vmem_tran`, `archive/pallas_tran.py:764-860`)."""
    from ..analyses.dc import dc
    from ..analyses.tran import collect_breakpoints

    if not supported(cc):
        raise ValueError("circuit not supported by kernel K2 (vmem_tran)")
    spec = cc.spec
    dev = cc.device
    t0, tstop = float(tspan[0]), float(tspan[1])
    if tstop <= t0:
        raise ValueError(f"vmem_tran needs tstop > t0, got {tspan}")
    if dt is None:
        dt = (tstop - t0) / 1000.0
    if dtmax is None:
        dtmax = max((tstop - t0) / 50.0, dt)
    if n_save is None:
        n_save = int(round((tstop - t0) / dt)) + 1
    if n_save < 2:
        raise ValueError("vmem_tran needs at least 2 save points")
    rc = int(rows_per_chunk)
    if rc < 8:
        raise ValueError("vmem_tran needs rows_per_chunk >= 8")
    dt_save = (tstop - t0) / (n_save - 1)
    params = cc.params0()

    op_conv = torch.tensor(True, device=dev)
    op_iters = torch.tensor(0, dtype=ITYPE, device=dev)
    if x0 is None:
        if uic:
            x0 = torch.zeros(cc.n, dtype=DTYPE, device=dev)
        else:
            with obs.span("op"):
                op = dc(cc, params, mode=MODE_TRANOP, time=t0)
            x0, op_conv, op_iters = op.x, op.converged, op.iters
    with obs.span("pack"):
        va = None
        va_models = list(dict.fromkeys(g.model for g in cc.groups
                                       if _is_va(g.model)))
        if va_models:
            # the header, its hash, the library's lookup, build or load,
            # and the groups' parameter rows (the emission itself is cached
            # on each model by `supported`)
            with obs.span("va"):
                va = va_library(va_models, dev)
                dyn_t0 = make_dynspec(temp_c=spec.temp_c, time=t0,
                                      gmin=GMIN, gshunt=spec.gshunt,
                                      srcfact=1.0, mode=MODE_TRAN,
                                      device="cpu")
                va.rows = {g.model: va.models[g.model][1].rows(g.params,
                                                               dyn_t0)
                           for g in cc.groups if g.model in va.models}
        x0 = torch.as_tensor(x0, dtype=DTYPE, device=dev).clone()
        for node, v in (ic or {}).items():
            x0[cc.index_of(str(node))] = float(v)

        xp = pad_state(x0[None])
        dyn_op = spec.dyn(dev, mode=MODE_TRANOP, time=t0)
        with obs.span("build"):
            rhs = make_rhs_assembler(cc)
            assemble = make_assembler(cc)
        with obs.span("charge"):
            f0, q0 = rhs(xp, params, dyn_op)
            # init_lim(x0) serves only this call: the integrator's limiter
            # states start at zeros, as the reference kernel's do (`lim0`)
            _, _, _, C0, _ = assemble(xp, assemble.init_lim(xp), params,
                                      dyn_op)
            diff = C0[0].abs().sum(-1) > 0.0

        # the breakpoints and the step-control scalars
        with obs.span("steps"):
            bp = collect_breakpoints(cc, tstop)
            bp = bp[bp > t0]
            win_rows = min(rc, max(8, int(8 * np.ceil(
                (np.ceil(dtmax / dt_save) + 2) / 8))))
            return Setup(
                cc=cc, params=params, t0=t0, tstop=tstop, dt_save=dt_save,
                n_save=n_save, rows_per_chunk=rc, win_rows=win_rows,
                n_chunks=(n_save + rc - 1) // rc,
                h0=min(dt / 10.0, dtmax),
                # a step may cross at most win_rows - 2 save rows
                hmax=min(dtmax, (win_rows - 2) * dt_save),
                hmin=max((tstop - t0) * 1e-7, dt * 1e-4, 1e-30),
                reltol=max(spec.reltol, RELTOL_FLOOR),
                max_steps=int(max_steps), bp=np.asarray(bp, np.float64),
                x0=x0, q0=q0[0], qdot0=-f0[0], diff=diff,
                atol=abstol_vector(cc),
                vmask=torch.as_tensor(cc.classes == CLASS_V, device=dev),
                op_converged=op_conv, op_iters=op_iters, va=va)


# ---------------------------------------------------------------------------
# device evaluation of one group (the twin's; csrc/devices.cuh in K2)

def _instance_eval(model, with_wave):
    def one(u, u_prev, p, wv, dyn):
        if with_wave:
            # the source sees its waveform's value at the trial time as a
            # DC value, evaluated once per trial step (as the reference)
            p = dict(p, wave={"kind": WAVE_DC, "coeffs": wv.reshape(1),
                              "ncoef": 1, "dc": wv})
        return _group_eval(model, u, u_prev, p, dyn)

    return vmap(one, in_dims=(0, 0, 0, 0 if with_wave else None, 0))


def eval_group_plain(model, u, u_prev, params, wv, dyn: DynSpec):
    """Limited residual, charge and local Jacobians of I instances:
    u, u_prev [I, L]; params {name: [I]} (no "wave"); wv [I] source values
    or None; dyn with 0-d fields. Returns f, q [I, L], J, C [I, L, L] and
    the limited point u_eval [I, L], through `mna/assemble.py`'s group
    evaluation."""
    I = u.shape[0]
    p = {k: v for k, v in params.items() if k != "wave"}
    return _instance_eval(model, wv is not None)(u, u_prev, p, wv,
                                                 _lane_dyn(dyn, 1, I))


def wave_values_plain(packed, t):
    """Every source's waveform value at the scalar time t: [I]."""
    tt = torch.as_tensor(t, dtype=DTYPE, device=packed["coeffs"].device)
    return eval_wave(packed["kind"], packed["coeffs"], packed["ncoef"], tt)


# ---------------------------------------------------------------------------
# the twin

@dataclasses.dataclass
class _Result:
    xs: torch.Tensor          # [n_save, n]
    stats: tuple              # naccept, nreject, nnewton, fail (ints)
    final: torch.Tensor       # [3, n]: x, q, qdot at the end
    host_syncs: int
    phases: dict = None       # K2 only: {phase: clock64 cycles}
    warp_iterations: int = None   # K2 only: iterations on the warp path
    group_cycles: int = None  # K2 only: the largest group's eval cycles


def integrate_plain(S: Setup) -> _Result:
    """K2's algorithm in torch ops on S's device: the chunk loop, and in it
    one Newton iteration per pass of a Python loop, with the scalar step
    control on the host."""
    cc = S.cc
    n, dev = cc.n, cc.device
    spec = cc.spec
    rc, wr = S.rows_per_chunk, S.win_rows
    groups = []
    for g, p in zip(cc.groups, S.params):
        conn = torch.as_tensor(g.conn, dtype=ITYPE, device=dev)
        wave = p.get("wave")
        groups.append((conn, g.model.limit is not None,
                       _instance_eval(g.model, wave is not None),
                       {k: v for k, v in p.items() if k != "wave"}, wave))
    np1 = n + 1
    fq_scatter = make_sorted_scatter([g.conn for g in cc.groups], np1, dev)
    jc_scatter = make_sorted_scatter(
        [(g.conn[:, :, None] * np1 + g.conn[:, None, :]) for g in
         cc.groups], np1 * np1, dev)
    vm = S.vmask.to(DTYPE)
    gsh = float(spec.gshunt)
    max_dv = float(spec.max_dv)
    max_newton = int(spec.max_newton_iters)
    reltol, hmin, hmax = S.reltol, S.hmin, S.hmax
    n_bp = len(S.bp)
    dyn0 = S.dyn(S.t0)

    def evaluate(xi, lims, wvs, t_new):
        xpad = pad_state(xi)
        dyn = dyn0._replace(time=torch.as_tensor(t_new, dtype=DTYPE,
                                                 device=dev))
        fs, qs, Js, Cs, lim_new = [], [], [], [], []
        for (conn, limited, ev, p, _), lim, wv in zip(groups, lims, wvs):
            u = xpad[conn]
            f, q, J, C, ue = ev(u, lim if limited else u, p, wv,
                                _lane_dyn(dyn, 1, conn.shape[0]))
            fs.append(f.reshape(1, -1))
            qs.append(q.reshape(1, -1))
            Js.append(J.reshape(1, -1))
            Cs.append(C.reshape(1, -1))
            lim_new.append(ue if limited else None)
        F = fq_scatter(fs)[0, :n] + gsh * xi * vm
        Q = fq_scatter(qs)[0, :n]
        G = jc_scatter(Js).reshape(np1, np1)[:n, :n] \
            + torch.diag(gsh * vm)
        C = jc_scatter(Cs).reshape(np1, np1)[:n, :n]
        return F, Q, G, C, lim_new

    # the kernel's two forms: the warp solve up to WARP_SOLVE_MAX unknowns,
    # the blocked (panel) form above
    gj = gj_solve_plain if n <= WARP_SOLVE_MAX else gj_solve_blocked_plain

    def solve(A, rhs):
        """Two-sided equilibration, then Gauss-Jordan on [Dr A Dc | Dr b]
        (K1's elimination) and the column scaling undone."""
        rinv = 1.0 / torch.clamp(A.abs().amax(1), min=1e-30)
        A = A * rinv[:, None]
        cinv = 1.0 / torch.clamp(A.abs().amax(0), min=1e-30)
        A = A * cinv[None, :]
        y = gj(A[None], (rinv * rhs)[None, :, None])[0, :, 0]
        return y * cinv

    def waves(t_new):
        return [None if w is None else wave_values_plain(w, t_new)
                for (_, _, _, _, w) in groups]

    xs = torch.zeros((S.n_chunks * rc, n), dtype=DTYPE, device=dev)
    x, x1, x2 = S.x0.clone(), S.x0.clone(), S.x0.clone()
    q, q1, qd = S.q0.clone(), S.q0.clone(), S.qdot0.clone()
    t, h, t1, t2 = S.t0, S.h0, S.t0 - 1.0, S.t0 - 2.0
    bp_i, si, naccept, nreject, nnewton = 0, 1, 0, 0, 0
    nsteps, nrej_run, hold, fail, iord = 0, 0, 0, 0, 1
    # limiter states: the previous evaluation point and the state at the
    # last accepted step, both starting at zeros (the reference's lim0)
    lims = [torch.zeros(conn.shape, dtype=DTYPE, device=dev) if lim
            else None for (conn, lim, _, _, _) in groups]
    limaccs = [v if v is None else v.clone() for v in lims]
    syncs = 0

    for ci in range(S.n_chunks):
        last_row = min((ci + 1) * rc - 1, S.n_save - 1)
        chunk_t_last = S.t0 + last_row * S.dt_save
        row0 = ci * rc
        xs[row0:row0 + rc] = x

        def setup_trial():
            bp_t = float(S.bp[min(bp_i, n_bp - 1)])
            h_eff = min(min(h, hmax), chunk_t_last - t)
            to_bp = bp_t - t
            if 0.0 < to_bp < h_eff * 1.5:
                h_eff = min(h_eff, to_bp)
            h_eff = max(h_eff, hmin)
            t_new = t + h_eff
            hit_bp = t_new >= bp_t - 1e-6 * max(bp_t, 1e-30)
            use_be = iord == 1
            c0 = 1.0 / h_eff if use_be else 2.0 / h_eff
            rhs_q = c0 * q + (0.0 if use_be else qd)
            dt1 = max(t - t1, 1e-30)
            xi = x + (x - x1) / dt1 * h_eff if naccept >= 1 else x
            return h_eff, t_new, hit_bp, use_be, c0, rhs_q, xi, waves(t_new)

        h_eff, t_new, hit_bp, use_be, c0, rhs_q, xi, wvs = setup_trial()
        it = 0
        while (t < chunk_t_last - 0.01 * S.dt_save and not fail
               and nsteps < S.max_steps and si < S.n_save):
            F, Q, G, C, lim_new = evaluate(xi, lims, wvs, t_new)
            Ft = F + c0 * Q - rhs_q
            dx = -solve(G + c0 * C, Ft)
            # host syncs: this read, the flags, enorm and (on accept) nsaved
            vstep = float(torch.where(S.vmask, dx.abs(), 0.0).amax())
            if max_dv > 0:
                dx = dx * min(1.0, max_dv / max(vstep, 1e-30))
            xi_new = xi + dx
            tol = reltol * torch.maximum(xi_new.abs(), xi.abs()) + S.atol
            rowscale = F.abs() + (c0 * Q).abs() + rhs_q.abs()
            flags = torch.stack([
                (dx.abs() <= tol).all(),
                (Ft.abs() <= RES_EPS * rowscale + S.atol).all(),
                ~torch.isfinite(xi_new).all()]).tolist()
            ok, bad = flags[0] or flags[1], flags[2]
            if bad:
                xi_new = xi
                lim_new = lims
            it += 1
            conv = ok and not bad
            newton_done = conv or bad or it >= max_newton

            tiny = 1e-30
            d1a = (xi_new - x) / max(t_new - t, tiny)
            d1b = (x - x1) / max(t - t1, tiny)
            d1c = (x1 - x2) / max(t1 - t2, tiny)
            d2a = (d1a - d1b) / max(t_new - t1, tiny)
            d2b = (d1b - d1c) / max(t - t2, tiny)
            d3 = (d2a - d2b) / max(t_new - t2, tiny)
            lte = (h_eff * h_eff * d2a.abs() if use_be
                   else 0.5 * h_eff ** 3 * d3.abs())
            etol = TRTOL * (reltol * torch.maximum(xi_new.abs(), x.abs())
                            + S.atol)
            enorm = float(torch.where(S.diff, lte / etol, 0.0).amax())
            syncs += 3
            enorm = enorm if naccept >= 2 else 0.0
            enorm = math.inf if math.isnan(enorm) else enorm
            accept = newton_done and conv and (enorm <= 1.0
                                               or h_eff <= hmin * 1.01)
            reject = newton_done and not accept
            if conv:
                fac = min(max(0.9 * max(enorm, 1e-10) ** (-1.0 / 3.0),
                              0.02), GROW_MAX)
            else:
                fac = NEWTON_FAIL_CUT
            if accept and hold > 0:
                fac = min(fac, 1.0)
            h_next = min(max(h_eff * fac, hmin), hmax)
            if not (math.isfinite(h_next) and h_next > 0):
                h_next = hmin
            fail_now = reject and h_eff <= hmin * 1.01

            if accept:
                Qc = Q + C @ dx
                qdot_new = c0 * Qc - rhs_q
                # the save rows in (t, t_new], through K2's window
                k0 = max(math.floor((t - S.t0) / S.dt_save) + 1 - row0, 0)
                k0 = min(k0, rc - wr)
                rows = torch.arange(row0 + k0, row0 + k0 + wr, device=dev)
                wt = S.t0 + rows.to(DTYPE) * S.dt_save
                m = (wt > t + 1e-37) & (wt <= t_new + 1e-37)
                wfac = torch.clamp((wt - t) / max(t_new - t, tiny), 0.0, 1.0)
                xw = x + wfac[:, None] * (xi_new - x)
                xs[rows] = torch.where(m[:, None], xw, xs[rows])
                si += int(m.sum())
                syncs += 1
                x2, x1, x = x1, x, xi_new
                q1, q, qd = q, Qc, qdot_new
                t2, t1, t = t1, t, t_new
                # BE after a breakpoint, trapezoidal otherwise
                iord = 1 if hit_bp else 2
                bp_i += hit_bp
            elif reject and not conv:
                iord = 1          # BE after a Newton failure
            if newton_done:
                h = h_next
            naccept += accept
            nreject += reject
            nnewton += 1
            nsteps += newton_done
            if fail_now or nrej_run > MAX_REJECT_RUN:
                fail = 1
            nrej_run = 0 if accept else nrej_run + reject
            hold = HOLD_STEPS if reject else (max(hold - 1, 0) if accept
                                              else hold)
            if accept:
                limaccs = lim_new
                lims = lim_new
            elif newton_done:
                lims = limaccs
            else:
                lims = lim_new
            if newton_done:
                (h_eff, t_new, hit_bp, use_be, c0, rhs_q, xi,
                 wvs) = setup_trial()
                it = 0
            else:
                xi = xi_new
        # a chunk whose last step stopped within 0.01 save intervals short
        # of its last row: the row takes the accepted state (the reference
        # kernel leaves it at the chunk's entry state)
        if (not fail and nsteps < S.max_steps
                and t >= chunk_t_last - 0.01 * S.dt_save
                and chunk_t_last > t + 1e-37):
            xs[last_row] = x
            si += 1

    ran_out = nsteps >= S.max_steps and t < S.tstop * (1.0 - 1e-6)
    return _Result(xs=xs[:S.n_save], stats=(naccept, nreject, nnewton,
                                            int(fail) + int(ran_out)),
                   final=torch.stack([x, q, qd]), host_syncs=syncs)


# ---------------------------------------------------------------------------
# the kernel

_libs: dict = {}

_CFG_DOUBLES = ("t0", "tstop", "h0", "hmax", "hmin", "dt_save", "reltol",
                "max_dv", "gshunt", "gmin", "temp", "srcfact")
_CFG_INTS = ("n", "n_groups", "n_inst", "n_loc", "n_bp", "max_steps",
             "max_newton", "n_save", "rows_per_chunk", "win_rows",
             "n_chunks", "n_jac", "n_slots", "n_fq", "n_jc",
             "locals_in_smem", "n_ent", "timed_slot")
_PTRS = ("gdesc", "conn", "par", "wkind", "wcoef", "bp", "x0", "q0",
         "qdot0", "atol", "diff", "vmask", "fq_ptr", "fq_idx", "jc_ptr",
         "jc_idx", "floc", "qloc", "jloc", "cloc", "ueval", "lims",
         "limacc", "wv", "cdx", "xs", "stats", "fin", "slot_inst",
         "slot_group", "gat", "jc_ent", "fq_pos", "jc_pos")


class _Config(ctypes.Structure):
    """Mirror of `VmemConfig` in csrc/vmem_tran.cu (8-byte fields only)."""
    _fields_ = ([(k, ctypes.c_double) for k in _CFG_DOUBLES]
                + [(k, ctypes.c_longlong) for k in _CFG_INTS])


class _Ptrs(ctypes.Structure):
    """Mirror of `VmemPtrs` in csrc/vmem_tran.cu (device pointers)."""
    _fields_ = [(k, ctypes.c_void_p) for k in _PTRS]


def load_library(header=None):
    """Build (once per source hash) and load the K2 shared library; with
    the `header` of a circuit's Verilog-A models (`va_cuda.header`), the
    library built with it (`nvcc.load`). Loaded once a process per header
    text."""
    lib = _libs.get(header)
    if lib is not None:
        return lib
    lib = nvcc.load("vmem_tran", header)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.vmem_tran_f64.argtypes = [ctypes.POINTER(_Config),
                                  ctypes.POINTER(_Ptrs), ci, vp]
    lib.vmem_tran_f64.restype = ci
    lib.vmem_eval_group_f64.argtypes = [ci, ci, ci, vp, vp, vp, ci, vp, cd,
                                        cd, cd, vp, vp, vp, vp, vp, vp]
    lib.vmem_eval_group_f64.restype = ci
    lib.vmem_eval_waves_f64.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp]
    lib.vmem_eval_waves_f64.restype = ci
    _libs[header] = lib
    return lib


def _csr(dest, n_rows):
    """Host gather plan: for each destination row, the indices of its
    contributions in ascending order (the stable order of
    `make_sorted_scatter`); destinations outside [0, n_rows) (ground)
    are dropped. Returns int32 (ptr [n_rows + 1], idx)."""
    dest = np.asarray(dest, np.int64)
    keep = np.nonzero((dest >= 0) & (dest < n_rows))[0]
    order = keep[np.argsort(dest[keep], kind="stable")]
    counts = np.bincount(dest[keep], minlength=n_rows)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return ptr, order.astype(np.int32)


def loc_strides(nl: int):
    """The strides of one instance's local vectors (nl values) and local
    Jacobians (nl * nl) in K2's scratch: odd, so that the lanes of a warp,
    one instance each, reach distinct shared-memory banks (csrc:
    loc_stride, jac_stride)."""
    return nl | 1, (nl * nl) | 1


def pack(S: Setup) -> dict:
    """The host packer: per-group descriptors, connection tables,
    parameter rows, packed waveforms and the F/Q and J/C gather plans, as
    numpy arrays in the layout csrc/vmem_tran.cu reads.

    gdesc [NG, 11] int64 per group: model id, n_inst, n_local, n_par,
    offsets into conn, par, the local vectors (f, q, u_eval, limiter
    states), the local Jacobians, the instance list, the waveform
    coefficients (-1 without), and the coefficient width. An instance's
    local vectors and Jacobians sit at the strides of `loc_strides`; the
    slots between are padding that no plan reads.

    slot_inst, slot_group [n_slots] int32: the thread slots of the
    per-instance loops, each group padded to whole warps so that no warp
    runs two models; a slot's global instance index (-1 for padding) and
    its group. timed_slot: the first slot of the group with the most local
    unknowns (instances times locals), whose thread times its device
    function in the warp instance (`group_cycles`); -1 without groups.

    A Verilog-A group takes its id and its rows, the effective parameter
    values in the emitter's order, from S.va (computed by `prepare`).

    jc_ent [n_ent] int32: the entries r n + c of the J/C plan that have
    contributions, the longest runs first, one assembly task each in the
    warp instance. fq_pos [n_loc], jc_pos [n_jac] int32: the inverse
    plans, each local's place in the F/Q or J/C plan (-1 for ground and
    padding), through which the warp instance's evaluating threads lay
    their contributions out in plan order."""
    cc = S.cc
    n = cc.n
    gdesc, conn, par, wkind, wcoef = [], [], [], [], []
    fq_dest, jc_dest, slot_inst, slot_group = [], [], [], []
    off = dict(conn=0, par=0, loc=0, jac=0, inst=0, wave=0)
    for g, p in zip(cc.groups, S.params):
        I, L = g.conn.shape
        if g.model in KERNEL_MODELS:
            mid, pnames = KERNEL_MODELS[g.model]
            rows = (np.stack([np.asarray(g.params[k], np.float64)
                              for k in pnames], 1) if pnames else None)
        else:
            mid, em = S.va.models[g.model]
            pnames = em.params
            rows = S.va.rows[g.model]
        wave_off, W = -1, 0
        kinds = np.zeros(I, np.int64)
        if g.waves is not None:
            w = pack_waveforms(g.waves, device="cpu")
            W = int(w["coeffs"].shape[1])
            kinds = w["kind"].numpy()
            wcoef.append(w["coeffs"].numpy().reshape(-1))
            wave_off = off["wave"]
            off["wave"] += I * W
        wkind.append(kinds)
        gdesc.append([mid, I, L, len(pnames), off["conn"], off["par"],
                      off["loc"], off["jac"], off["inst"], wave_off, W])
        conn.append(g.conn.reshape(-1))
        if pnames:
            par.append(rows.reshape(-1))
        ls, js = loc_strides(L)
        fq = np.full((I, ls), -1, np.int64)
        fq[:, :L] = g.conn
        fq_dest.append(fq.reshape(-1))
        jc = np.full((I, js), -1, np.int64)
        jc[:, :L * L] = np.where((g.conn[:, :, None] < n)
                                 & (g.conn[:, None, :] < n),
                                 g.conn[:, :, None] * n
                                 + g.conn[:, None, :], -1).reshape(I, -1)
        jc_dest.append(jc.reshape(-1))
        pad = -I % 32
        slot_inst.append(np.concatenate([off["inst"] + np.arange(I),
                                         np.full(pad, -1)]))
        slot_group.append(np.full(I + pad, len(gdesc) - 1))
        off["conn"] += I * L
        off["par"] += I * len(pnames)
        off["loc"] += I * ls
        off["jac"] += I * js
        off["inst"] += I
    fq_ptr, fq_idx = _csr(np.concatenate(fq_dest), n)
    jc_ptr, jc_idx = _csr(np.concatenate(jc_dest), n * n)
    runs = np.diff(jc_ptr)
    jc_ent = np.nonzero(runs)[0]
    jc_ent = jc_ent[np.argsort(-runs[jc_ent], kind="stable")]
    fq_pos = np.full(off["loc"], -1, np.int32)
    fq_pos[fq_idx] = np.arange(len(fq_idx))
    jc_pos = np.full(off["jac"], -1, np.int32)
    jc_pos[jc_idx] = np.arange(len(jc_idx))

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.zeros(1, dtype))

    sizes = [g.conn.size for g in cc.groups]
    slot_group_all = cat(slot_group, np.int32)
    timed_slot = (int(np.flatnonzero(slot_group_all
                                     == int(np.argmax(sizes)))[0])
                  if sizes else -1)

    return dict(gdesc=np.asarray(gdesc, np.int64),
                conn=cat(conn, np.int32), par=cat(par, np.float64),
                wkind=cat(wkind, np.int64), wcoef=cat(wcoef, np.float64),
                fq_ptr=fq_ptr, fq_idx=fq_idx, jc_ptr=jc_ptr, jc_idx=jc_idx,
                jc_ent=jc_ent.astype(np.int32), fq_pos=fq_pos,
                jc_pos=jc_pos,
                slot_inst=cat(slot_inst, np.int32),
                slot_group=slot_group_all, timed_slot=timed_slot,
                n_loc=off["loc"], n_jac=off["jac"], n_inst=off["inst"])


def _kernel_args(S: Setup):
    """K2's config and its input, scratch and output tensors on S's
    device."""
    cc, n = S.cc, S.cc.n
    dev, spec = cc.device, cc.spec
    pk = pack(S)

    def dv(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    t = dict(gdesc=dv(pk["gdesc"]), conn=dv(pk["conn"]), par=dv(pk["par"]),
             wkind=dv(pk["wkind"]), wcoef=dv(pk["wcoef"]),
             bp=dv(S.bp, DTYPE), x0=S.x0.contiguous(),
             q0=S.q0.contiguous(), qdot0=S.qdot0.contiguous(),
             atol=S.atol.contiguous(), diff=S.diff.to(DTYPE).contiguous(),
             vmask=S.vmask.to(DTYPE).contiguous(),
             fq_ptr=dv(pk["fq_ptr"]), fq_idx=dv(pk["fq_idx"]),
             jc_ptr=dv(pk["jc_ptr"]), jc_idx=dv(pk["jc_idx"]),
             jc_ent=dv(pk["jc_ent"]), fq_pos=dv(pk["fq_pos"]),
             jc_pos=dv(pk["jc_pos"]),
             slot_inst=dv(pk["slot_inst"]), slot_group=dv(pk["slot_group"]),
             xs=torch.empty((S.n_chunks * S.rows_per_chunk, n), dtype=DTYPE,
                            device=dev),
             stats=torch.zeros(_N_STATS, dtype=torch.int64, device=dev),
             fin=torch.empty((3, n), dtype=DTYPE, device=dev))
    n_loc, n_jac = max(pk["n_loc"], 1), max(pk["n_jac"], 1)
    for k, size in (("floc", n_loc), ("qloc", n_loc), ("jloc", n_jac),
                    ("cloc", n_jac), ("ueval", n_loc), ("lims", n_loc),
                    ("limacc", n_loc), ("wv", max(pk["n_inst"], 1)),
                    ("cdx", n_loc),
                    ("gat", 2 * (len(pk["fq_idx"]) + len(pk["jc_idx"])))):
        t[k] = torch.empty(size, dtype=DTYPE, device=dev)
    cfg = _Config(
        t0=S.t0, tstop=S.tstop, h0=S.h0, hmax=S.hmax, hmin=S.hmin,
        dt_save=S.dt_save, reltol=S.reltol, max_dv=float(spec.max_dv),
        gshunt=float(spec.gshunt), gmin=GMIN, temp=spec.temp_c + T0_K,
        srcfact=1.0, n=n, n_groups=len(cc.groups), n_inst=pk["n_inst"],
        n_loc=pk["n_loc"], n_bp=len(S.bp), max_steps=S.max_steps,
        max_newton=int(spec.max_newton_iters), n_save=S.n_save,
        rows_per_chunk=S.rows_per_chunk, win_rows=S.win_rows,
        n_chunks=S.n_chunks, n_jac=pk["n_jac"],
        n_slots=len(pk["slot_inst"]), n_fq=len(pk["fq_idx"]),
        n_jc=len(pk["jc_idx"]), n_ent=len(pk["jc_ent"]),
        locals_in_smem=int(smem_bytes(n) + locals_bytes(n, pk) <= SMEM_MAX),
        timed_slot=pk["timed_slot"])
    return cfg, t


def integrate(S: Setup) -> _Result:
    """Run the integrator: K2 on a CUDA circuit, the twin on the CPU."""
    dev = S.cc.device
    if dev.type == "cpu":
        return integrate_plain(S)
    if dev.type != "cuda":
        raise ValueError(f"vmem_tran: unsupported device {dev}")
    lib = load_library() if S.va is None else S.va.lib
    with obs.span("args"):
        cfg, t = _kernel_args(S)
        ptrs = _Ptrs(**{k: t[k].data_ptr() for k in _PTRS})
        stream = torch.cuda.current_stream(dev).cuda_stream
    with obs.span("launch"):
        err = lib.vmem_tran_f64(ctypes.byref(cfg), ctypes.byref(ptrs),
                                _THREADS, stream)
    if err != 0:
        raise RuntimeError(f"vmem_tran kernel launch failed: cudaError {err}")
    vmem_tran.launches += 1
    with obs.span("wait"):
        stats = t["stats"].tolist()   # the one host sync of the transient
    # the largest group's device-function cycles, as a program counter of
    # the call (`integrate.group_cycles#n`)
    obs.count("group_cycles", stats[_GROUP_CYCLES])
    return _Result(xs=t["xs"][:S.n_save], stats=tuple(stats[:4]),
                   final=t["fin"], host_syncs=1,
                   phases=dict(zip(PHASES, stats[_PHASE0:])),
                   warp_iterations=stats[_WARP_ITERS],
                   group_cycles=stats[_GROUP_CYCLES])


def eval_group(model, u, u_prev, params, wv, dyn: DynSpec):
    """`eval_group_plain` through K2's device functions on a CUDA tensor
    (the `vmem_eval_group` entry of csrc/vmem_tran.cu), the plain version
    on a CPU tensor."""
    if u.device.type == "cpu":
        return eval_group_plain(model, u, u_prev, params, wv, dyn)
    I, L = u.shape
    dev = u.device
    if model in KERNEL_MODELS:
        lib = load_library()
        mid, pnames = KERNEL_MODELS[model]
        par = (torch.stack([params[k].to(DTYPE) for k in pnames], 1)
               .contiguous() if pnames else torch.zeros(1, dtype=DTYPE,
                                                        device=dev))
    else:
        va = va_library([model], dev)
        lib = va.lib
        mid, em = va.models[model]
        pnames = em.params
        par = torch.as_tensor(em.rows({k: v.cpu().numpy() for k, v in
                                       params.items()}, dyn),
                              dtype=DTYPE, device=dev).contiguous()
    wvt = (wv if wv is not None
           else torch.zeros(I, dtype=DTYPE, device=dev)).contiguous()
    f = torch.empty((I, L), dtype=DTYPE, device=dev)
    q, ue = torch.empty_like(f), torch.empty_like(f)
    J = torch.empty((I, L, L), dtype=DTYPE, device=dev)
    C = torch.empty_like(J)
    err = lib.vmem_eval_group_f64(
        mid, I, L, u.contiguous().data_ptr(), u_prev.contiguous().data_ptr(),
        par.data_ptr(), len(pnames), wvt.data_ptr(), float(dyn.temp),
        float(dyn.gmin), float(dyn.srcfact), f.data_ptr(), q.data_ptr(),
        J.data_ptr(), C.data_ptr(), ue.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vmem_eval_group launch failed: cudaError {err}")
    return f, q, J, C, ue


def wave_values(packed, ts):
    """Waveform values [T, I] at the times ts [T]: K2's device waveform
    evaluation (`vmem_eval_waves`) on CUDA, `eval_wave` on the CPU."""
    co = packed["coeffs"]
    if co.device.type == "cpu":
        return torch.stack([wave_values_plain(packed, t) for t in ts])
    lib = load_library()
    I, W = co.shape
    T = ts.shape[0]
    out = torch.empty((T, I), dtype=DTYPE, device=co.device)
    err = lib.vmem_eval_waves_f64(
        packed["kind"].contiguous().data_ptr(), co.contiguous().data_ptr(),
        W, I, ts.contiguous().data_ptr(), T, out.data_ptr(),
        torch.cuda.current_stream(co.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vmem_eval_waves launch failed: cudaError {err}")
    return out


# ---------------------------------------------------------------------------
# entry points

def _solution(S: Setup, r: _Result):
    from ..analyses.tran import TranSolution, TranStats
    dev = S.cc.device
    na, nr, nn, fl = r.stats
    st = TranStats(naccept=torch.tensor(na, device=dev),
                   nreject=torch.tensor(nr, device=dev),
                   nnewton=torch.tensor(nn, device=dev),
                   fail=torch.tensor(fl > 0, device=dev))
    sol = TranSolution(S.cc, np.linspace(S.t0, S.tstop, S.n_save), r.xs, st,
                       op_converged=S.op_converged, host_syncs=r.host_syncs,
                       op_iters=S.op_iters)
    sol.final = r.final
    #: K2's clock64 cycles per phase of its Newton iterations (None for
    #: the twin)
    sol.phase_cycles = r.phases
    #: K2's Newton iterations on its warp-resident path (n <= 32; equal to
    #: stats.nnewton there, 0 on the block path; None for the twin)
    sol.k2_warp_iterations = r.warp_iterations
    #: K2's clock64 cycles in the device function of the group with the
    #: most local unknowns, summed over the transient (one thread of the
    #: warp that evaluates the group's first instances; n <= 32 only, 0 on
    #: the block path; None for the twin)
    sol.group_cycles = r.group_cycles
    return sol


@obs.entry
def vmem_tran(cc, tspan, *, dt=None, dtmax=None, n_save=None,
              max_steps=2_000_000, x0=None, uic=False, ic=None,
              rows_per_chunk=512):
    """Transient analysis through kernel K2 (the twin on a CPU circuit).

    Same semantics as the reference kernel's entry for the supported
    circuit class (`supported`): default parameters, a uniform save grid
    of n_save points (default from dt), dtmax the largest internal step.
    `uic` starts from zeros, `ic` pins node voltages in x0. Raises
    ValueError for an unsupported circuit. Returns a TranSolution, with
    `sol.final` ([3, n]: x, q, qdot at the end) and `sol.timings`."""
    # host seconds (`obs`) of the operating point and set-up ("prepare":
    # "prepare.op", the DC chain, and "prepare.pack", K2's set-up), and of
    # the integrator, which ends in a host sync ("integrate"; on the card
    # "integrate.args", ".launch" and ".wait")
    with obs.span("prepare"):
        S = prepare(cc, tspan, dt=dt, dtmax=dtmax, n_save=n_save,
                    max_steps=max_steps, x0=x0, uic=uic, ic=ic,
                    rows_per_chunk=rows_per_chunk)
    with obs.span("integrate"):
        return _solution(S, integrate(S))


def vmem_tran_plain(cc, tspan, **kw):
    """`vmem_tran` through the twin on any device."""
    S = prepare(cc, tspan, **kw)
    return _solution(S, integrate_plain(S))


#: K2 launches since the last reset (twin runs do not count)
vmem_tran.launches = 0
