"""Transient analysis: adaptive trapezoidal (or Gear2) integration with LTE
control (PyTorch port of `cadnip_tpu/analyses/tran.py`).

Scheme (ngspice-style TRAP), as in the JAX package:
  * charge-based formulation f(x) + dq/dt = 0; each implicit step solves
    f(x) + c0*q(x) = rhs_q with Newton, warm-started from a linear predictor
  * backward Euler on the first step, after every breakpoint and after a
    Newton failure; trap (or Gear2) otherwise
  * LTE from divided differences of the state on the differential rows,
    normalized by reltol*|x| + per-class abstol and the SPICE trtol factor
  * waveform breakpoints are hit exactly
  * results land on a fixed save grid by linear interpolation

The runner is the JAX package's flattened state machine: every pass of one
Python loop performs exactly one Newton iteration on every lane, and step
control (accept/reject, h update, history rotation, saving) runs as masked
updates on a dict of [B, ...] tensors. The loop reads its termination mask
to the host once per pass: one sync per Newton iteration, counted in
`TranSolution.host_syncs`.

Verilog-A `absdelay` (reference DDE path, `src/mna/delay.jl:20-28`): each
lane carries a chronological ring of `delay_hist` accepted times and the
delayed expressions' values there, seeded with H copies of the operating
point's (the constant pre-t0 history). Every trial reads the values at
t - tau by linear interpolation as explicit history, the step is capped at
the shortest delay, and an unbatched call also hits the source
breakpoints' echoes at b + k tau. `trace=True` keeps a ring of the last
4096 Newton passes per lane: (t_new, h, iteration, converged, violation,
accepted).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..config import DTYPE, ITYPE
from ..interop import to_numpy
from ..mna.assemble import (ensure_setup, make_delay_meta,
                            make_rhs_assembler, pad_state)
from ..mna.devices import CLASS_V
from ..mna.newton import (_make_assemble_solve, abstol_vector, damp_step,
                          make_system_assembler, make_uic_warmup)
from ..mna.spec import MODE_TRAN, MODE_TRANOP
from ..mna.structure import CompiledCircuit
from .dc import dc, param_lanes

TRTOL = 7.0          # SPICE LTE slack factor
TRACE_LEN = 4096     # solver-trace ring buffer length
GROW_MAX = 2.0
NEWTON_FAIL_CUT = 0.125


class TranStats(NamedTuple):
    naccept: torch.Tensor
    nreject: torch.Tensor
    nnewton: torch.Tensor
    fail: torch.Tensor        # True if the integrator gave up (h < hmin)


class TranSolution:
    """Waveforms on the save grid; name-addressable like DCSolution.
    sol['out'] -> values over the save times; sol.ts -> the grid.
    `timings` holds the host wall seconds of the operating point ("op")
    and of the transient loop with its set-up ("transient"); each ends on
    a host sync, so on a CUDA circuit they include the device work. Their
    parts are the spans of `obs` under them (`tran`: "op.direct.iter",
    "transient.iter.assemble", "transient.sync", ...), each with its
    count under "<name>#n"."""

    def __init__(self, cc, ts, xs, stats: TranStats, op_converged=True,
                 host_syncs: int = 0, op_iters=0, timings=None, trace=None):
        self.cc = cc
        self.ts = ts
        self.xs = xs
        self.stats = stats
        self.op_converged = op_converged
        self.host_syncs = host_syncs
        self.op_iters = op_iters
        self.timings = timings or {}
        # (ring [.., TRACE_LEN, 6], passes recorded [..]) with trace=True
        self.trace = trace

    def __getitem__(self, name):
        return self.xs[..., self.cc.index_of(str(name))]

    def v(self, p, n=None):
        vp = self[p]
        return vp if n is None else vp - self[n]

    @property
    def converged(self):
        return (~self.stats.fail) & self.op_converged

    def __repr__(self):
        s = self.stats
        return (f"TranSolution({self.cc.title!r}, {self.ts.shape[-1]} pts, "
                f"accepted={s.naccept.tolist()}, "
                f"rejected={s.nreject.tolist()}, "
                f"newton={s.nnewton.tolist()}, fail={s.fail.tolist()})")

    def save(self, path):
        """Persist the waveforms and the name table to .npz (the JAX
        package's keys: ts, xs, names), from host copies."""
        names = sorted(self.cc.names, key=self.cc.names.get)
        np.savez_compressed(path, ts=to_numpy(self.ts),
                            xs=to_numpy(self.xs),
                            names=np.asarray(names, dtype=str))

    @staticmethod
    def load(path):
        """Load saved waveforms: (ts, {name: values}) as numpy arrays."""
        z = np.load(path)
        xs = z["xs"]
        return z["ts"], {nm: xs[..., i] for i, nm in enumerate(z["names"])}


def collect_breakpoints(cc: CompiledCircuit, tstop: float) -> np.ndarray:
    """Gather waveform kink times from every source in the circuit."""
    bps = [np.array([tstop])]
    for g in cc.groups:
        if g.waves is None:
            continue
        for w in g.waves:
            bps.append(w.breakpoints(tstop))
    b = np.unique(np.concatenate(bps))
    b = b[(b > 0) & (b <= tstop)]
    if b.size == 0 or b[-1] != tstop:
        b = np.append(b, tstop)
    return b


def _interp_hist(ht, hv, tq):
    """Per-lane, per-site linear interpolation into the absdelay history
    ring: ht [B, H] ascending times, hv [B, H, D] recorded values, tq
    [B, D] query times. Queries outside the recorded range clamp to the
    nearest endpoint (the pre-t0 history is the DC value, the standard
    SPICE DDE initial history)."""
    H = ht.shape[1]
    i = torch.clip(torch.searchsorted(ht, tq, right=True), 1, H - 1)
    t_lo = torch.gather(ht, 1, i - 1)
    t_hi = torch.gather(ht, 1, i)
    w = torch.clip((tq - t_lo) / torch.clamp(t_hi - t_lo, min=1e-300),
                   0.0, 1.0)
    v_lo = torch.gather(hv, 1, (i - 1)[:, None, :])[:, 0]
    v_hi = torch.gather(hv, 1, i[:, None, :])[:, 0]
    return v_lo + w * (v_hi - v_lo)


def _lane_mask(m, v):
    """A [B] mask shaped to broadcast against v [B, ...]."""
    return m.reshape((-1,) + (1,) * (v.ndim - 1))


def _divided_diff3(xc, tc, x0, t0, x1, t1, x2, t2):
    """Second and third divided differences over (tc,xc),(t0,x0),(t1,x1),
    (t2,x2); times are [B, 1], states [B, n]."""
    tiny = 1e-300
    d1a = (xc - x0) / torch.clamp(tc - t0, min=tiny)
    d1b = (x0 - x1) / torch.clamp(t0 - t1, min=tiny)
    d1c = (x1 - x2) / torch.clamp(t1 - t2, min=tiny)
    d2a = (d1a - d1b) / torch.clamp(tc - t1, min=tiny)
    d2b = (d1b - d1c) / torch.clamp(t0 - t2, min=tiny)
    d3 = (d2a - d2b) / torch.clamp(tc - t2, min=tiny)
    return d2a, d3


def make_tran_runner(cc: CompiledCircuit, n_save: int, max_steps: int,
                     window: int, method: str | None = None,
                     integ: str = "trap", assemble=None,
                     trace: bool = False, delay_hist: int = 1024):
    """Build run(x0, lim0, q0, qdot0, params, dyn0, t0, tstop, h0, hmax,
    hmin, bp_times, save_ts, diff_mask) -> (xs [B, n_save, n], TranStats,
    passes, trace). x0 etc. carry the lane axis B; trace is (ring
    [B, TRACE_LEN, 6], passes recorded [B]) with `trace`, else None.

    The save grid is written in place under the accept mask, through a
    window of `window` rows at each lane's save cursor (a step crosses
    fewer grid points than that, since h <= hmax); the JAX package instead
    rewrites the grid functionally every Newton iteration. The trace ring
    is written in place too, on the lanes still running."""
    assemble, solve_J, matvec = _make_assemble_solve(cc, assemble, method)
    dmeta = make_delay_meta(cc)   # absdelay history (None for most circuits)
    H = int(delay_hist)
    atol = abstol_vector(cc)
    is_v = torch.as_tensor(cc.classes == CLASS_V, device=cc.device)
    spec = cc.spec
    W = window

    def run(x0, lim0, q0, qdot0, params, dyn0, t0, tstop, h0, hmax, hmin,
            bp_times, save_ts, diff_mask):
        dev = x0.device
        B, n = x0.shape
        n_bp = bp_times.shape[0]
        lanes = torch.arange(B, device=dev)[:, None]
        win = torch.arange(W, device=dev)
        xs = torch.zeros((B, n_save + W, n), dtype=DTYPE, device=dev)
        save_ts_pad = torch.cat([save_ts, torch.full(
            (W,), float("inf"), dtype=DTYPE, device=dev)])

        def col(v):
            return v[:, None]

        def save_points(si, t_old, x_old, t_new, x_new, accept):
            """Fill every grid point in (t_old, t_new] of the accepted
            lanes by linear interpolation; returns the new save cursor."""
            rows = si[:, None] + win                             # [B, W]
            ts_win = save_ts_pad[rows]
            mask = ((ts_win > col(t_old) + 1e-30)
                    & (ts_win <= col(t_new) + 1e-30))
            w = torch.where(col(t_new > t_old),
                            (ts_win - col(t_old))
                            / torch.clamp(col(t_new - t_old), min=1e-300),
                            1.0)
            w = torch.clip(w, 0.0, 1.0)
            xi = x_old[:, None, :] + w[..., None] * (x_new - x_old)[:, None]
            put = (mask & col(accept))[..., None]
            xs[lanes, rows] = torch.where(put, xi, xs[lanes, rows])
            return si + mask.sum(-1)

        if dmeta is not None:
            # absdelay history ring, seeded with the initial (DC) probe
            # values: the constant pre-t0 history function (reference
            # `src/mna/delay.jl:20-28` h(p, t - tau))
            v0_dly, taus = dmeta.probe(pad_state(x0), params,
                                       dyn0._replace(time=t0))
            tau_cap = torch.where(taus > 0, taus, float("inf")).amin(-1)

        def setup_trial(s):
            """Next trial step (h_eff, t_new, c0, rhs_q, hit_bp, x_pred,
            and the delayed values dly) from the accepted state in s."""
            t, h, x = s["t"], s["h"], s["x"]
            bp_t = bp_times[torch.clamp(s["bp_i"], max=n_bp - 1)]
            h_eff = torch.minimum(torch.clamp(h, max=hmax), tstop - t)
            if dmeta is not None:
                # never step past the shortest transport delay: the
                # delayed values are explicit history, so t - tau must
                # land at or before the last accepted point
                h_eff = torch.minimum(h_eff, torch.clamp(tau_cap, min=hmin))
            to_bp = bp_t - t
            h_eff = torch.where((to_bp > 0) & (to_bp < h_eff * 1.5),
                                torch.minimum(h_eff, to_bp), h_eff)
            h_eff = torch.clamp(h_eff, min=hmin)
            t_new = t + h_eff
            hit_bp = t_new >= bp_t - 1e-15 * torch.clamp(bp_t, min=1.0)
            use_be = s["ord"] == 1
            if integ == "trap":
                c0 = torch.where(use_be, 1.0 / h_eff, 2.0 / h_eff)
                rhs_q = col(c0) * s["q"] + col((~use_be).to(DTYPE)) \
                    * s["qdot"]
            else:  # gear2: variable-step BDF2 over charge history
                h2 = torch.clamp(t - s["t1"], min=1e-300)
                a0 = (2 * h_eff + h2) / (h_eff * (h_eff + h2))
                b0 = -(h_eff + h2) / (h_eff * h2)
                g0 = h_eff / (h2 * (h_eff + h2))
                c0 = torch.where(use_be, 1.0 / h_eff, a0)
                rhs_q = torch.where(col(use_be), s["q"] / col(h_eff),
                                    -(col(b0) * s["q"] + col(g0) * s["q1"]))
            dt1 = torch.clamp(t - s["t1"], min=1e-300)
            slope = (x - s["x1"]) / col(dt1)
            x_pred = torch.where(col(s["naccept"] >= 1),
                                 x + slope * col(h_eff), x)
            trial = dict(h_eff=h_eff, t_new=t_new, c0=c0, rhs_q=rhs_q,
                         hit_bp=hit_bp, use_be=use_be, xi=x_pred,
                         it=torch.zeros(B, dtype=ITYPE, device=dev))
            if dmeta is not None:
                trial["dly"] = _interp_hist(s["hist_t"], s["hist_v"],
                                            col(t_new) - taus)
            return trial

        def lane(v):
            return torch.full((B,), v, dtype=DTYPE, device=dev)

        def ilane(v):
            return torch.full((B,), v, dtype=ITYPE, device=dev)

        zero = ilane(0)
        true = torch.ones(B, dtype=torch.bool, device=dev)
        si0 = save_points(zero, lane(t0 - 1.0), x0, lane(t0), x0, true)
        s = dict(t=lane(t0), h=lane(h0), x=x0, lim=lim0, lim_acc=lim0,
                 q=q0, qdot=qdot0, q1=q0, x1=x0, t1=lane(t0 - 1.0), x2=x0,
                 t2=lane(t0 - 2.0), ord=ilane(1), bp_i=zero, si=si0,
                 naccept=zero, nreject=zero, nnewton=zero,
                 fail=~true, nsteps=zero, nrej_run=zero, hold=zero)
        if dmeta is not None:
            s["hist_t"] = lane(t0)[:, None].expand(B, H).clone()
            s["hist_v"] = v0_dly[:, None, :].expand(
                B, H, v0_dly.shape[1]).clone()
        if trace:
            ring = torch.zeros((B, TRACE_LEN, 6), dtype=DTYPE, device=dev)
            ti = ilane(0)
        s.update(setup_trial(s))
        mode_tran = torch.as_tensor(MODE_TRAN, dtype=ITYPE, device=dev)
        passes = 0

        while True:
            active = ((s["t"] < tstop * (1.0 - 1e-12)) & ~s["fail"]
                      & (s["nsteps"] < max_steps) & (s["si"] < n_save))
            passes += 1
            with obs.span("sync"):         # the one host sync per pass
                if not bool(active.any()):
                    break
            with obs.span("iter"):
                # ---- exactly ONE Newton iteration on the in-flight trial
                c0, rhs_q = s["c0"], s["rhs_q"]
                dyn = dyn0._replace(time=s["t_new"], mode=mode_tran)
                with obs.span("assemble"):
                    F, Q, G, C, lim_new = assemble(
                        pad_state(s["xi"]), s["lim"], params, dyn,
                        s["dly"] if dmeta is not None else None)
                Ft = F + col(c0) * Q - rhs_q
                with obs.span("solve"):
                    dx = solve_J(G, C, c0, -Ft)
                if spec.max_dv > 0:
                    dx = damp_step(dx, is_v, spec.max_dv)
                xi_new = s["xi"] + dx
                ok_dx = (dx.abs() <= spec.reltol * torch.maximum(
                    xi_new.abs(), s["xi"].abs()) + atol).all(-1)
                # residual test relative to each row's own current magnitudes
                rowscale = F.abs() + (col(c0) * Q).abs() + rhs_q.abs()
                ok_res = (Ft.abs() <= 1e-9 * rowscale + atol).all(-1)
                ok = ok_dx | ok_res
                bad = ~torch.isfinite(xi_new).all(-1)
                xi_new = torch.where(col(bad), s["xi"], xi_new)
                lim_new = torch.where(col(bad), s["lim"], lim_new)
                it = s["it"] + 1
                conv = ok & ~bad
                newton_done = conv | bad | (it >= spec.max_newton_iters)

            # ---- step control (masked: applies only when newton_done)
            with obs.span("control"):
                t, x, h_eff, t_new = s["t"], s["x"], s["h_eff"], s["t_new"]
                d2, d3 = _divided_diff3(xi_new, col(t_new), x, col(t), s["x1"],
                                        col(s["t1"]), s["x2"], col(s["t2"]))
                lte = torch.where(col(s["use_be"]),
                                  col(h_eff * h_eff) * d2.abs(),
                                  col(0.5 * h_eff ** 3) * d3.abs())
                etol = TRTOL * (spec.reltol * torch.maximum(xi_new.abs(),
                                                            x.abs()) + atol)
                # LTE only on differential variables
                enorm = torch.where(diff_mask, lte / etol, 0.0).amax(-1)
                enorm = torch.where(s["naccept"] >= 2, enorm, 0.0)
                # NaN guard: a NaN enorm would deadlock the controller
                enorm = torch.where(torch.isnan(enorm), float("inf"), enorm)
                accept = newton_done & conv & ((enorm <= 1.0)
                                               | (h_eff <= hmin * 1.01))
                reject = newton_done & ~accept
                fac = torch.where(conv, torch.clip(0.9 * torch.pow(
                    torch.clamp(enorm, min=1e-10), -1.0 / 3.0), 0.02,
                    GROW_MAX), NEWTON_FAIL_CUT)
                fac = torch.where(accept & (s["hold"] > 0),
                                  torch.clamp(fac, max=1.0), fac)
                h_next = torch.clip(h_eff * fac, hmin, hmax)
                h_next = torch.where(torch.isfinite(h_next) & (h_next > 0),
                                     h_next, hmin)
                fail_now = reject & (h_eff <= hmin * 1.01)
                # first-order charge correction (Q at the pre-update iterate)
                Qc = Q + matvec(C, dx)
                # qdot from the discretization identity (BE/trap/gear2 alike)
                qdot_new = col(c0) * Qc - rhs_q
                acc = accept & active
                si_new = save_points(s["si"], t, x, t_new, xi_new, acc)

                def pick(a, b):
                    return torch.where(col(accept) if a.ndim == 2 else accept,
                                       a, b)

                one, two = ilane(1), ilane(2)
                ns = dict(
                    t=pick(t_new, t),
                    h=torch.where(newton_done, h_next, s["h"]),
                    x=pick(xi_new, x), q=pick(Qc, s["q"]),
                    qdot=pick(qdot_new, s["qdot"]), q1=pick(s["q"], s["q1"]),
                    x1=pick(x, s["x1"]), t1=pick(t, s["t1"]),
                    x2=pick(s["x1"], s["x2"]), t2=pick(s["t1"], s["t2"]),
                    # BE after breakpoints and after Newton failures
                    ord=torch.where(accept & s["hit_bp"], one, torch.where(
                        accept, two, torch.where(reject & ~conv, one,
                                                 s["ord"]))),
                    bp_i=torch.where(accept & s["hit_bp"], s["bp_i"] + 1,
                                     s["bp_i"]),
                    si=torch.where(accept, si_new, s["si"]),
                    naccept=s["naccept"] + accept.to(ITYPE),
                    nreject=s["nreject"] + reject.to(ITYPE),
                    nnewton=s["nnewton"] + 1,
                    # a long unbroken run of rejects = "timestep too small"
                    nrej_run=torch.where(accept, 0,
                                         s["nrej_run"] + reject.to(ITYPE)),
                    hold=torch.where(reject, 3, torch.where(
                        accept, torch.clamp(s["hold"] - 1, min=0), s["hold"])),
                    fail=s["fail"] | fail_now | (s["nrej_run"] > 100),
                    nsteps=s["nsteps"] + newton_done.to(ITYPE))
                if dmeta is not None:
                    # record the accepted point's delayed-expression values
                    # into the (chronologically ordered, shift-left) ring
                    v_now, _ = dmeta.probe(pad_state(xi_new), params, dyn)
                    ns["hist_t"] = torch.where(col(accept), torch.cat(
                        [s["hist_t"][:, 1:], col(t_new)], dim=1), s["hist_t"])
                    ns["hist_v"] = torch.where(
                        accept[:, None, None], torch.cat(
                            [s["hist_v"][:, 1:], v_now[:, None]], dim=1),
                        s["hist_v"])
                # next trial: fresh setup when this one finished, else continue
                trial = setup_trial(ns)
                keep = dict(h_eff=h_eff, t_new=t_new, c0=c0, rhs_q=rhs_q,
                            hit_bp=s["hit_bp"], use_be=s["use_be"], xi=xi_new,
                            it=it)
                if dmeta is not None:
                    keep["dly"] = s["dly"]
                for k in trial:
                    ns[k] = torch.where(_lane_mask(newton_done, trial[k]),
                                        trial[k], keep[k])
                # limiter state: keep updating while Newton continues; commit
                # on accept; restore the last accepted step's state on reject
                ns["lim_acc"] = torch.where(col(accept), lim_new, s["lim_acc"])
                ns["lim"] = torch.where(col(accept), lim_new, torch.where(
                    col(newton_done), s["lim_acc"], lim_new))
                if trace:
                    viol = (dx.abs() / (spec.reltol * torch.maximum(
                        xi_new.abs(), s["xi"].abs()) + atol)).amax(-1)
                    rec = torch.stack([t_new, h_eff, it.to(DTYPE),
                                       conv.to(DTYPE), viol, accept.to(DTYPE)],
                                      dim=-1)
                    row = ti % TRACE_LEN
                    ring[lanes[:, 0], row] = torch.where(
                        col(active), rec, ring[lanes[:, 0], row])
                    ti = ti + active.to(ITYPE)
                # lanes that have finished keep their state
                for k, v in ns.items():
                    s[k] = torch.where(_lane_mask(active, v), v, s[k])

        ran_out = (s["nsteps"] >= max_steps) & (s["t"] < tstop * (1 - 1e-12))
        stats = TranStats(naccept=s["naccept"], nreject=s["nreject"],
                          nnewton=s["nnewton"], fail=s["fail"] | ran_out)
        return xs[:, :n_save], stats, passes, (ring, ti) if trace else None

    return run


@obs.entry
def tran(cc: CompiledCircuit, tspan, params=None, *, dt=None, dtmax=None,
         n_save: int | None = None, save_ts=None, max_steps: int = 200_000,
         x0=None, method: str | None = None, integ: str = "trap",
         ic: dict | None = None, uic: bool = False, trace: bool = False,
         delay_hist: int = 1024) -> TranSolution:
    """Transient analysis over tspan=(t0, tstop).

    dt: output resolution (SPICE .tran tstep); dtmax: max internal step
    (SPICE tmax). Output is interpolated onto a uniform grid of n_save
    points (default from dt). Parameters with a lane axis give batched
    waveforms xs [B, n_save, n]; otherwise xs is [n_save, n].

    trace: keep the solver trace, `sol.trace = (ring, passes)`: ring
    [TRACE_LEN, 6] (with a lane axis when batched) of (t_new, h, Newton
    iteration, converged, max violation of the dx test, accepted) per
    Newton pass, written at `passes % TRACE_LEN`. delay_hist: length of
    the absdelay history ring (accepted points kept per lane).

    As in the JAX package's vmapped transient (`transweep`), a batched
    call takes its operating point from the bare DC chain, without the
    rescue tiers, does not run the `uic` warmup and adds no absdelay
    breakpoint echoes."""
    t0, tstop = float(tspan[0]), float(tspan[1])
    if tstop <= t0:
        raise ValueError(f"tran needs tstop > t0, got tspan=({t0}, {tstop})")
    with obs.span("op"):
        dev = cc.device
        if params is None:
            params = cc.params0()
        params = ensure_setup(cc, params)
        lanes = param_lanes(params)
        B = lanes or 1
        if dt is None:
            dt = (tstop - t0) / 1000.0
        if dtmax is None:
            dtmax = max((tstop - t0) / 50.0, dt)
        if save_ts is None:
            if n_save is None:
                n_save = int(round((tstop - t0) / dt)) + 1
            save_ts = np.linspace(t0, tstop, n_save)
        save_np = np.asarray(save_ts, np.float64)
        n_save = int(save_np.shape[0])

        # operating point at t0 with transient source values; `uic` skips the
        # DC solve and starts from zeros + .ic values; `ic` forces node
        # voltages into x0 either way
        op_conv = torch.ones(B, dtype=torch.bool, device=dev)
        op_iters = torch.zeros(B, dtype=ITYPE, device=dev)
        if x0 is None and uic:
            x0 = torch.zeros((B, cc.n), dtype=DTYPE, device=dev)
        if x0 is None:
            op = dc(cc, params, mode=MODE_TRANOP, time=t0,
                    rescue=lanes is None)
            x0 = op.x.reshape(B, cc.n)
            op_conv = op.converged.reshape(B)
            op_iters = op.iters.reshape(B)
        x0 = torch.as_tensor(x0, dtype=DTYPE,
                             device=dev).expand(B, cc.n).clone()
        for node, v in (ic or {}).items():
            x0[:, cc.index_of(str(node))] = float(v)
        if uic and lanes is None:
            # consistency projection: a few tiny implicit-Euler steps settle
            # the algebraic unknowns while the differential states stay put
            h_w = max((tstop - t0) * 1e-12, dt * 1e-6)
            x0 = make_uic_warmup(cc, method=method)(
                x0, params, cc.spec.dyn(dev, mode=MODE_TRAN, time=t0), h_w)
            for node, v in (ic or {}).items():
                x0[:, cc.index_of(str(node))] = float(v)

    with obs.span("transient"):
        bp = collect_breakpoints(cc, tstop)
        bp = bp[bp > t0]
        dmeta = make_delay_meta(cc)
        if dmeta is not None and lanes is None:
            # transport-delay breakpoint echoes: a source kink at b re-emerges
            # at the output of every absdelay site at b + k tau (the reference
            # expands breakpoints into solver tstops, `src/mna/solve.jl:
            # 1847-1918`; the DDE path needs the delayed images too)
            _, taus0 = dmeta.probe(pad_state(x0), params,
                                   cc.spec.dyn(dev, mode=MODE_TRANOP, time=t0))
            taus0 = np.unique(taus0.cpu().numpy())
            taus0 = taus0[taus0 > 0]
            ext = [bp, np.asarray([t0])]
            for k_echo in (1, 2):
                for tau_v in taus0:
                    ext.append(bp + k_echo * float(tau_v))
                    ext.append(np.asarray([t0 + k_echo * float(tau_v)]))
            bp = np.unique(np.concatenate(ext))
            bp = bp[(bp > t0) & (bp <= tstop)]
            if bp.size == 0 or bp[-1] != tstop:
                bp = np.append(bp, tstop)
        # a step crosses at most ceil(dtmax / save_dt) + 1 grid points
        dt_min = float(np.min(np.diff(save_np))) if n_save > 1 else dtmax
        W = min(int(np.ceil(dtmax / max(dt_min, 1e-300))) + 2, n_save)

        assemble = make_system_assembler(cc)
        rhs = make_rhs_assembler(cc)
        runner = make_tran_runner(cc, n_save, int(max_steps), W, method=method,
                                  integ=integ, assemble=assemble, trace=trace,
                                  delay_hist=delay_hist)
        xp = pad_state(x0)
        lim0 = assemble.init_lim(xp)
        dyn_op = cc.spec.dyn(dev, mode=MODE_TRANOP, time=t0)
        f0, q0 = rhs(xp, params, dyn_op)
        _, _, _, C0, _ = assemble(xp, lim0, params, dyn_op)
        # the differential rows: those with a charge entry
        if cc.bbd is None:
            diff_mask = C0.abs().sum(-1) > 0.0
        else:
            from ..ops.bbd import global_row_sums
            diff_mask = global_row_sums(cc.bbd, C0) > 0.0
        dyn0 = cc.spec.dyn(dev, mode=MODE_TRAN, time=t0)
        # hmin floor: below ~1e-5*dt the trapezoidal system becomes so stiff
        # that f64 Newton cannot converge
        hmin = max((tstop - t0) * 1e-12, dt * 1e-5, 1e-18)
        h0 = min(dt / 10.0, dtmax)
        xs, stats, passes, tr = runner(
            x0, lim0, q0, -f0, params, dyn0, t0, tstop, h0, float(dtmax), hmin,
            torch.as_tensor(bp, dtype=DTYPE, device=dev),
            torch.as_tensor(save_np, dtype=DTYPE, device=dev), diff_mask)
        if lanes is None:
            xs = xs[0]
            stats = TranStats(*(v[0] for v in stats))
            op_conv, op_iters = op_conv[0], op_iters[0]
            if tr is not None:
                tr = (tr[0][0], tr[1][0])
    return TranSolution(cc, save_np, xs, stats, op_converged=op_conv,
                        host_syncs=passes, op_iters=op_iters, trace=tr)
