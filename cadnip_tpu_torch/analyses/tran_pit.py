"""Parallel-in-time transient: window Newton over batched timepoints
(PyTorch port of `cadnip_tpu/analyses/tran_pit.py`).

Fixed-step trapezoidal integration solved as a SEQUENCE OF WINDOWS, each
window's W timepoints Newton-iterated SIMULTANEOUSLY. With qdot_k the state
derivative at step k, the trapezoidal recursion
  q_k - q_{k-1} = h/2 (qdot_k + qdot_{k-1}),   F_k + qdot_k = 0
eliminates qdot exactly into the window system
  R_1 = F_1 + c0 (Q_1 - Q_0) - qdot_0                 (carry-in)
  R_k = F_k + F_{k-1} + c0 (Q_k - Q_{k-1}) = 0,  k = 2..W
with c0 = 2/h. Its Jacobian is block lower-bidiagonal,
  D_k = G_k + c0 C_k,     L_k = G_{k-1} - c0 C_{k-1},
so one Newton update solves D_k dx_k = -R_k - L_k dx_{k-1}: the affine
recurrence dx_k = M_k dx_{k-1} + c_k with [M_k | c_k] = -D_k^-1 [L_k | R_k],
evaluated by a doubling prefix scan of [n, n] affine maps.

One window-Newton iteration is one assembly with the window as the
assembler's lane axis, ONE launch of kernel K1 over the W systems
D_k [M_k | c_k] = [L_k | R_k] ([W, n, n + 1]; rows scaled by 1 / max|D_k
row| as the JAX package's lane-parallel Gauss-Jordan `_gj_lanes` scales
them, so K1's partial pivoting picks its pivots), and the scan: an f32
doubling scan, one f64 defect correction and a second f32 scan. Above
n = 40 the rows are not scaled (the JAX package's `gauss_solve` branch) and
the scan runs in f64.

Windows are seeded three ways, as in the reference:
  * the LADDER (`make_pit_runner`): each window solved coarse to fine, from
    a constant seed at every r-th point (backward Euler) up to the full
    grid (trapezoidal), each level seeded by interpolating the coarser one;
  * PERIODIC seeding (`make_flat_runner`): when every source shares a
    period that divides into steps, the window snaps to whole periods and
    each window is seeded with the previous one's waveform, under one
    pooled trip budget; window 0's seed is a serial `tran` at 8 dt;
  * the OSCILLATOR mode: serial single-step windows until `detect_period`
    finds a stable period in the waveform, then periodic seeding.
A failed window falls back to the robust ladder: a same-grid backward
Euler rescue level, then halving down to 64 steps.

The Newton loops run on the host: each iteration reads its window's
convergence flag once. The JAX package's TPU-only plumbing (fixed-trip
loops, CPU hybrids, the 3e-7 residual floor, compile keys) is not ported;
the residual floor is the CPU value, 1e-9.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import obs
from ..config import DTYPE, F32
from ..mna.assemble import (ensure_setup, make_assembler, make_rhs_assembler,
                             pad_state)
from ..mna.devices import CLASS_V
from ..mna.newton import abstol_vector
from ..mna.spec import MODE_TRAN, MODE_TRANOP
from ..mna.structure import CompiledCircuit
from ..mna.waveforms import (WAVE_DC, WAVE_EXP, WAVE_PULSE, WAVE_PWL,
                             WAVE_SFFM, WAVE_SIN)
from ..ops.gj_solve import gj_solve
from .dc import dc
from .tran import TranSolution, TranStats, tran as serial_tran

#: KCL-residual acceptance floor, relative to each row's magnitudes
RES_EPS = 1e-9
#: largest n solved with scaled rows and the mixed-precision scan
LANE_MAJOR_MAX = 40


def supported(cc: CompiledCircuit) -> bool:
    """Dense circuits without transport delays; any device class."""
    if cc.bbd is not None or cc.n > 150:
        return False
    for g in cc.groups:
        if g.model.n_delay_sites:
            return False
    return True


def _matvec(M, v):
    """sum_j M[:, :, j] * v[:, j] for M [W, n, n], v [W, n], summed term by
    term in the order j = 0, 1, ...: the JAX package's unrolled sums, which
    round alike on every device. A matmul sums in its library's order, and
    the Newton budgets of the rescue ladder sit on a knife edge: with
    torch.bmm here the mul startup's same-grid rescue level converges where
    the JAX package's exhausts its budget and halves, so the halving path
    could no longer be held to the reference's counts
    (test_torch_tran_pit_paths.py::test_rescue_halving_matches_jax)."""
    P = M * v[:, None, :]
    out = P[..., 0]
    for j in range(1, M.shape[-1]):
        out = out + P[..., j]
    return out


def _compose(Mo, ME):
    """Mo_k ME_k, summed over the inner index as `_matvec` sums."""
    Mn = Mo[:, :, 0, None] * ME[:, None, 0, :]
    for m in range(1, Mo.shape[-1]):
        Mn = Mn + Mo[:, :, m, None] * ME[:, None, m, :]
    return Mn


def scan_affine(M, c):
    """dx_k = M_k dx_{k-1} + c_k with dx_{-1} = 0, for M [W, n, n] and
    c [W, n]: the doubling scan of the JAX package's `_scan_lanes`, with
    the window axis first. At shift sh every point composes with the one
    sh earlier (M_k M_{k-sh}, M_k c_{k-sh} + c_k); the first sh points are
    complete and stay."""
    W = c.shape[0]
    sh = 1
    while sh < W:
        Mo = M[sh:]
        c = torch.cat([c[:sh], _matvec(Mo, c[:-sh]) + c[sh:]])
        if 2 * sh < W:
            M = torch.cat([M[:sh], _compose(Mo, M[:-sh])])
        sh *= 2
    return c


def mixed_scan_affine(M, c):
    """`scan_affine` of f64 maps through an f32 scan, one f64 defect
    correction and a second f32 scan: the scan is linear, so the scan of
    the defect delta_k = M_k dx_{k-1} + c_k - dx_k restores f64 accuracy.
    """
    M32 = M.to(F32)
    dxT = scan_affine(M32, c.to(F32)).to(DTYPE)
    dxp = torch.cat([torch.zeros_like(dxT[:1]), dxT[:-1]])
    delta = _matvec(M, dxp) + c - dxT
    return dxT + scan_affine(M32, delta.to(F32)).to(DTYPE)


def fastest_timescale(cc: CompiledCircuit) -> float:
    """Shortest source feature time (edge/kink spacing) in the circuit —
    the seeding ladder's coarsest grid must still resolve it: a coarse
    grid that smears a clock edge seeds a bistable circuit in the wrong
    basin."""
    tmin = np.inf
    for g in cc.groups:
        if g.waves is None:
            continue
        for w in g.waves:
            c = w.coeffs
            if w.kind == WAVE_PULSE:
                cand = [x for x in (c[3], c[4], c[5]) if x and np.isfinite(x)]
                tmin = min(tmin, *cand) if cand else tmin
            elif w.kind == WAVE_SIN:
                if c[2] > 0:
                    tmin = min(tmin, 1.0 / (8.0 * c[2]))
            elif w.kind == WAVE_PWL:
                ts = np.asarray(c[0::2])
                d = np.diff(ts)
                d = d[(d > 0) & (ts[1:] < 1e20)]
                if d.size:
                    tmin = min(tmin, float(d.min()))
            elif w.kind == WAVE_EXP:
                tmin = min(tmin, max(c[3], 1e-15), max(c[5], 1e-15))
            elif w.kind == WAVE_SFFM:
                if c[2] > 0:
                    tmin = min(tmin, 1.0 / (8.0 * c[2]))
    return float(tmin)


def common_period(cc: CompiledCircuit) -> float:
    """Least common period of every time-varying source, or nan: the
    eligibility gate of periodic window seeding. Damped or delayed sines,
    aperiodic pulses, PWL, EXP and SFFM disqualify."""
    periods = []
    for g in cc.groups:
        if g.waves is None:
            continue
        for w in g.waves:
            c = w.coeffs
            if w.kind == WAVE_DC:
                continue
            if w.kind == WAVE_SIN:
                if c[2] <= 0 or (len(c) > 3 and c[3] != 0) \
                        or (len(c) > 4 and c[4] != 0):
                    return float("nan")
                periods.append(1.0 / c[2])
            elif w.kind == WAVE_PULSE:
                per = c[6] if len(c) > 6 else float("inf")
                if not np.isfinite(per) or per >= 1e29:
                    return float("nan")
                periods.append(float(per))
            else:
                return float("nan")
    if not periods:
        return float("nan")
    P = max(periods)
    for p in periods:
        k = P / p
        if abs(k - round(k)) > 1e-9:
            return float("nan")
    return float(P)


def detect_period(xs, dt, min_cross=6, max_spread=0.02):
    """Oscillation period from a solved prefix xs [T, n], or None.

    Picks the unknown with the largest swing, finds rising crossings of its
    mid-level (sub-step resolution by linear interpolation), and accepts
    when the last few periods agree to `max_spread` relative. A swing below
    1e-3 of the signal level is solver noise, not an oscillation."""
    xs = np.asarray(xs)
    swing = xs.max(0) - xs.min(0)
    j = int(np.argmax(swing))
    v = xs[:, j]
    if swing[j] <= 1e-3 * max(1.0, float(np.abs(v).max())):
        return None
    s = v - 0.5 * (v.max() + v.min())
    idx = np.where((s[:-1] < 0) & (s[1:] >= 0))[0]
    if len(idx) < min_cross:
        return None
    frac = -s[idx] / (s[idx + 1] - s[idx])
    tc = (idx + frac) * dt
    per = np.diff(tc[-min(len(tc), 8):])
    P = float(np.mean(per))
    if P <= 2 * dt or float(np.std(per)) > max_spread * P:
        return None
    return P


def level_grids(W: int, coarsen: int = 8, coarse_min: int = 32):
    """Grid sizes coarsest -> finest of the seeding ladder (finest = W)."""
    gs = [W]
    if coarsen <= 1:
        return (W,)
    while gs[-1] % coarsen == 0 and gs[-1] // coarsen >= coarse_min:
        gs.append(gs[-1] // coarsen)
    return tuple(reversed(gs))


def _window_dx(R, D, Lm, active, n, lane_major, mixed_scan, mdv, is_v):
    """One window-Newton linear solve: D_k dx_k = -R_k - L_k dx_{k-1} for
    R [Wl, n], D and Lm [Wl, n, n] (Lm[0] = 0), points with active = 0
    ([Wl, 1]) frozen. Returns (dx [Wl, n], unclamped [Wl, 1]): the step
    after the global voltage-step clamp mdv, and whether it was left
    unclamped (convergence is never declared on a limited step).

    Lane-major branch (n <= 40): each row scaled by 1 / max|D_k row| (a
    floor of 1e-30), then ONE K1 launch over the window; the JAX
    `_gj_lanes` also floors each pivot at 1e-30, which K1 and its plain
    twin do not (they divide by the pivot they find: a scaled pivot below
    1e-30 is a singular point, whose non-finite step the caller rejects)."""
    Wl = R.shape[0]
    if lane_major:
        rmax = D.abs().amax(2, keepdim=True)
        rinv = 1.0 / torch.clamp(rmax, min=1e-30)
        X = gj_solve((D * rinv).contiguous(),
                     torch.cat([Lm * rinv, R[..., None] * rinv], -1))
        gate = active[:, 0] * (torch.arange(Wl, device=R.device) > 0)
        Ml64 = -X[..., :n] * gate[:, None, None]
        cl64 = -X[..., n] * active
        dx = (mixed_scan_affine if mixed_scan else scan_affine)(Ml64, cl64)
    else:
        sol = gj_solve(D.contiguous(), torch.cat([Lm, R[..., None]], -1))
        M = -sol[..., :n] * active[:, :, None]
        M[0] = 0.0
        dx = scan_affine(M, -sol[..., n] * active)
    if mdv > 0:
        vstep = torch.where(is_v[None, :], dx.abs(), 0.0).amax(
            1, keepdim=True)
        unclamped = vstep <= mdv
        dx = dx * torch.clamp(mdv / torch.clamp(vstep, min=1e-300), max=1.0)
    else:
        unclamped = torch.ones((dx.shape[0], 1), dtype=torch.bool,
                               device=dx.device)
    return dx, unclamped


class _Window:
    """What the window runners share: the assembler, the tolerances and
    the residual and Newton-update formulas of one window iteration."""

    def __init__(self, cc: CompiledCircuit, params, dyn0):
        self.cc, self.params, self.dyn0 = cc, params, dyn0
        self.assemble = make_assembler(cc)
        self.n = cc.n
        self.dev = cc.device
        # Big-VA (va_setup hoisted) circuits run the reference's slim
        # mode: convergence is only observed at a trip's entry, never
        # accepted on the step's own dx, so that the F/Q the loop carries
        # out are evaluated AT the accepted X
        self.big = any(g.model.va_setup is not None for g in cc.groups)
        self.lane_major = cc.n <= LANE_MAJOR_MAX
        self.atol = abstol_vector(cc)
        self.reltol = cc.spec.reltol
        self.max_dv = cc.spec.max_dv
        self.is_v = torch.as_tensor(cc.classes == CLASS_V, device=self.dev)

    def times(self, t0, dt, base, count):
        """t0 + dt * (base + [0..count)), base an exact float."""
        return t0 + dt * (base + torch.arange(count, dtype=DTYPE,
                                              device=self.dev))

    def init_lim(self, X):
        return self.assemble.init_lim(pad_state(X))

    def endpoint(self, x, lim, t):
        """(F, Q) of one point through the limited assembly path."""
        F, Q, _, _, _ = self.assemble(
            pad_state(x[None]), lim[None], self.params,
            self.dyn0._replace(time=torch.as_tensor(t, dtype=DTYPE,
                                                    device=self.dev)))
        return F[0], Q[0]

    def evaluate(self, X, lim, ok_dx_prev, tw, c0, Q_last, qd_last, be):
        """Assemble the window at X: its residual R, the acceptance and the
        frozen prefix. Returns (conv0, frozen, R, F, Q, G, C, limn), conv0
        whether every point was converged at entry."""
        F, Q, G, C, limn = self.assemble(pad_state(X), lim, self.params,
                                         self.dyn0._replace(time=tw))
        prevF = torch.zeros_like(F) if be else torch.cat(
            [-qd_last[None], F[:-1]])
        prevQ = torch.cat([Q_last[None], Q[:-1]])
        R = F + prevF + c0 * (Q - prevQ)
        # a point is converged iff the step INTO its current value was tiny
        # (carried ok_dx) or its residual here is at rounding level
        rowscale = (F.abs() + prevF.abs()
                    + c0 * (Q.abs() + prevQ.abs()))
        ok_res = R.abs() <= RES_EPS * rowscale + self.atol
        okp = (ok_dx_prev | ok_res).all(1, keepdim=True)
        # prefix freezing: once points 0..k converged they stop moving
        frozen = torch.cumprod(okp.to(DTYPE), 0)
        return frozen[-1, 0] > 0.5, frozen, R, F, Q, G, C, limn

    def step(self, X, ev, c0, be, mdv):
        """The Newton step from an `evaluate` result: one K1 launch and the
        scan. Returns (Xn, limn, ok_dx)."""
        _, frozen, R, _, _, G, C, limn = ev
        D = G + c0 * C
        Loff = (-c0) * C[:-1] if be else G[:-1] - c0 * C[:-1]
        Lm = torch.cat([torch.zeros_like(D[:1]), Loff])
        dx, uncl = _window_dx(R, D, Lm, 1.0 - frozen, self.n,
                              self.lane_major, True, mdv, self.is_v)
        Xn = X + dx
        finite = torch.isfinite(Xn).all(1, keepdim=True)
        Xn = torch.where(finite, Xn, X)
        ok_dx = ((dx.abs() <= self.reltol * torch.maximum(Xn.abs(), X.abs())
                  + self.atol) & finite & uncl)
        return Xn, limn, ok_dx


def make_pit_runner(cc: CompiledCircuit, params, dyn0, W: int, n_win: int,
                    max_iters: int = 40, coarsen: int = 8,
                    coarse_min: int = 32, rescue: bool = False):
    """Build the LADDER runner: run(carry, t0, dt) -> (xs [n_win*W, n],
    its [n_win], dones [n_win], carry, syncs), carry = (x, Q, qdot, lim)
    at the last point. Each window runs the coarse-to-fine seeding ladder
    from a constant seed; `rescue` inserts a same-grid backward-Euler level
    before the final trapezoidal one and takes its solution where trap
    fails. All n_win windows run, as the reference's scan runs them."""
    win = _Window(cc, params, dyn0)
    n = cc.n
    grids = level_grids(W, coarsen, coarse_min)
    assert not (rescue and win.big), "rescue runner unsupported in big mode"
    levels = [(Wl, li < len(grids) - 1) for li, Wl in enumerate(grids)]
    if rescue:
        levels.insert(len(levels) - 1, (W, True))
    miters = max(max_iters, 64)

    def newton_level(tw_l, c0_l, X0, Q_last, qd_last, be, mdv):
        """Window Newton at one grid level; trapezoidal, or backward Euler
        (`be`, the coarse seeding levels). Returns (X, lim, iters, done,
        F, Q) with F/Q of the last evaluation."""
        X, lim = X0, win.init_lim(X0)
        ok = torch.zeros(X0.shape, dtype=torch.bool, device=win.dev)
        it, done, syncs = 0, False, 0
        F = Q = None
        while not done and it < miters:
            ev = win.evaluate(X, lim, ok, tw_l, c0_l, Q_last, qd_last, be)
            conv0, F, Q = ev[0], ev[3], ev[4]
            Xn, limn, ok_dx = win.step(X, ev, c0_l, be, mdv)
            # accept-on-own-dx: every point's step already passes the dx
            # test (not in big mode)
            conv = conv0 if win.big else conv0 | ok_dx.all()
            X, lim, ok = Xn, limn, ok_dx
            it += 1
            done = bool(conv)
            syncs += 1
        return X, lim, it, done, F, Q, syncs

    def run(carry, t0, dt):
        x_last, Q_last, qd_last, _ = carry
        times = win.times(t0, dt, 1.0, n_win * W).reshape(n_win, W)
        xs, its, dones, syncs = [], [], [], 0
        for tw in times:
            X = None
            X_be = lim_be = done_be = None
            prev_Wl = None
            it_w = 0
            for Wl, be in levels:
                s = W // Wl
                c0_l = (1.0 if be else 2.0) / (dt * s)
                if X is None:
                    X0 = x_last.expand(Wl, n).clone()
                elif Wl == prev_Wl:
                    X0 = X
                else:
                    r = Wl // prev_Wl
                    prev = torch.cat([x_last[None], X[:-1]])
                    frac = ((torch.arange(Wl, dtype=DTYPE, device=win.dev)
                             % r) + 1.0) / r
                    X0 = (prev.repeat_interleave(r, 0)
                          + frac[:, None] * (X - prev).repeat_interleave(r, 0))
                # seed levels relax the voltage-step clamp
                mdv = win.max_dv if Wl == W else 8.0 * win.max_dv
                X, lim, it, done, Fl, Ql, sy = newton_level(
                    tw[s - 1::s], c0_l, X0, Q_last, qd_last, be, mdv)
                it_w += it
                syncs += sy
                if rescue and be and Wl == W:
                    X_be, lim_be, done_be = X, lim, done
                prev_Wl = Wl
            if rescue and done_be and not done:
                X, lim = X_be, lim_be
            if rescue:
                done = done or done_be
            if win.big:
                F1, Q1 = Fl[-1], Ql[-1]
            else:
                F1, Q1 = win.endpoint(X[-1], lim[-1], tw[-1])
            x_last, Q_last, qd_last = X[-1], Q1, -F1
            xs.append(X)
            its.append(it_w)
            dones.append(done)
        carry = (x_last, Q_last, qd_last, lim[-1])
        return torch.cat(xs), its, dones, carry, syncs

    return run


def make_flat_runner(cc: CompiledCircuit, params, dyn0, W: int, nw: int,
                     trips: int):
    """WAVEFORM-SEEDED window Newton with ONE pooled trip budget.

    run(q0, qd0, t0, dt, Xseed) -> (xs [w_done*W, n], trip_windows,
    trip_iters, w_done, Q_last, qd_last, X_exit, syncs). A trip is one
    Newton iteration of the current window w, seeded at the previous
    window's waveform; when the window has converged the trip ADVANCES
    instead: it banks the window, seeds window w+1 with its waveform and
    re-anchors the trapezoidal carry-in (Q, qdot = -F) at the converged
    endpoint. A converging iteration advances at once (accept-on-own-dx and
    a single-point assembly at the endpoint), except in big mode. If the
    budget runs out mid-window, X_exit carries the partial progress. w_done
    may exceed the caller's remaining windows (tail overshoot); the caller
    truncates."""
    win = _Window(cc, params, dyn0)
    n = cc.n

    def run(q0, qd0, t0, dt, Xseed):
        c0 = 2.0 / dt
        w = 0
        X, lim = Xseed, win.init_lim(Xseed)
        ok = torch.zeros((W, n), dtype=torch.bool, device=win.dev)
        Q_last, qd_last = q0, qd0
        banked, trip_w, trip_it, syncs = [], [], [], 0

        def advance(X_a, F1, Q1):
            return (X_a, win.init_lim(X_a),
                    torch.zeros((W, n), dtype=torch.bool, device=win.dev),
                    Q1, -F1)

        for _ in range(trips):
            if w >= nw:
                break
            tw = win.times(t0, dt, float(W) * w + 1.0, W)
            ev = win.evaluate(X, lim, ok, tw, c0, Q_last, qd_last, False)
            syncs += 1
            trip_w.append(w)
            if bool(ev[0]):
                # converged at entry: F/Q just computed AT the iterate
                banked.append(X)
                X, lim, ok, Q_last, qd_last = advance(X, ev[3][-1], ev[4][-1])
                trip_it.append(0)
                w += 1
                continue
            Xn, limn, ok_dx = win.step(X, ev, c0, False, win.max_dv)
            trip_it.append(1)
            syncs += 0 if win.big else 1
            if not win.big and bool(ok_dx.all()):
                F1, Q1 = win.endpoint(Xn[-1], limn[-1], tw[-1])
                banked.append(Xn)
                X, lim, ok, Q_last, qd_last = advance(Xn, F1, Q1)
                w += 1
            else:
                X, lim, ok = Xn, limn, ok_dx
        xs = torch.cat(banked) if banked else X[:0]
        return xs, trip_w, trip_it, w, Q_last, qd_last, X, syncs

    return run


@obs.entry
def tran_pit(cc: CompiledCircuit, tspan, dt, *, window: int = 1024,
             max_iters: int = 40, x0=None, uic: bool = False, ic=None,
             params=None, windows_per_exec: int = 64, coarsen: int = 8,
             periodic: str = "auto", osc: bool = False,
             osc_window: int = 64, osc_period: float | None = None,
             xseed=None) -> TranSolution:
    """Fixed-step trapezoidal transient via window-parallel Newton.

    Saves every step: ts = t0 + dt*[0..n_steps]. Same initial-condition
    semantics as `tran` (DC operating point at t0 in TRANOP mode, or `uic`
    start from zeros and `ic` pins). Windows are solved in groups of
    `windows_per_exec` (the reference's execution; also the flat runner's
    budget and the ladder's unit of salvage).

    periodic="auto": when every source is periodic with a common period P
    that divides into dt-steps, the window snaps to whole periods and every
    window after the first is seeded with the previous window's waveform;
    periodic="off" disables. osc=True: the autonomous-oscillator mode
    (serial steps until `detect_period` sees a stable period, then seeded
    windows snapped to it); osc_period pins the snapped period while the
    measurement agrees within 2 %. xseed [W, n]: window 0's seed on the
    periodic-seeded path in place of the serial `tran` (a run on one device
    replayed on another from the same seed).

    The solution carries `window` (the window length after snapping),
    `window_iters` (step offset, window-Newton iterations) per solved
    piece, `host_syncs`, `timings` of the operating point ("op"), the
    periodic seed's serial `tran` ("seed") and the windows ("windows"),
    each ending on a host sync, `k1_launches` of K1 over the same three
    parts (one per window-Newton iteration in "windows"), and `xseed`,
    window 0's seed on the periodic-seeded path (else None)."""
    if not supported(cc):
        raise ValueError("circuit not supported by the PIT runner")
    k1_0 = gj_solve.launches
    with obs.span("op"):
        spec = cc.spec
        dev = cc.device
        t0f, tstop = float(tspan[0]), float(tspan[1])
        n_steps = int(round((tstop - t0f) / dt))
        W = int(min(window, n_steps))
        psteps = 0
        if periodic == "auto":
            P = common_period(cc)
            if np.isfinite(P):
                k = P / dt
                if abs(k - round(k)) < 1e-6 and round(k) >= 8:
                    psteps = int(round(k))
        if psteps and n_steps >= 2 * psteps:
            W = psteps * max(1, W // psteps)
        else:
            psteps = 0
        n_win = (n_steps + W - 1) // W
        n_exec = min(int(windows_per_exec), n_win)
        use_seeded = bool(psteps) and n_win >= 2

        dyn_op = spec.dyn(dev, mode=MODE_TRANOP, time=t0f)
        if params is None:
            params = cc.params0()
        params = ensure_setup(cc, params, dyn_op)
        big = any(g.model.va_setup is not None for g in cc.groups)
        op_conv = True
        op_iters = 0
        if x0 is None:
            if uic:
                x0 = torch.zeros(cc.n, dtype=DTYPE, device=dev)
            else:
                op = dc(cc, params, mode=MODE_TRANOP, time=t0f)
                x0 = op.x
                op_conv = bool(op.converged)
                op_iters = int(op.iters)
        x0 = torch.as_tensor(x0, dtype=DTYPE, device=dev).clone()
        for node, v in (ic or {}).items():
            x0[cc.index_of(str(node))] = float(v)

        rhs = make_rhs_assembler(cc)
        assemble = make_assembler(cc)
        # the ladder's coarsest step is bounded by the fastest source feature
        tmin = fastest_timescale(cc)
        if np.isfinite(tmin):
            coarse_min = int(max(32, int(np.ceil(W * dt / max(tmin, dt)))))
        else:
            coarse_min = 32
        dyn0 = spec.dyn(dev, mode=MODE_TRAN, time=t0f)
        xs_parts, log = [], []
        st = dict(nn=0, all_done=True, syncs=0, k1_seed=0)
        Xseed0 = None

        def _carry_at(x_cur, t_cur, dynb=None):
            """Restart state at a solved trajectory point: on the trajectory
            of f(x) + dq/dt = 0, qdot = -f(x)."""
            dynb = dyn0 if dynb is None else dynb
            xp = pad_state(x_cur[None])
            F, Q = rhs(xp, params, dynb._replace(time=torch.as_tensor(
                t_cur, dtype=DTYPE, device=dev)))
            return (x_cur, Q[0], -F[0], assemble.init_lim(xp)[0])

        carry = _carry_at(x0, t0f, dyn_op)
    k1_op = gj_solve.launches

    ladders = {}

    def _ladder(Wx, n_w, resc=False, mi=max_iters):
        key = (Wx, n_w, resc, mi)
        if key not in ladders:
            ladders[key] = make_pit_runner(cc, params, dyn0, Wx, n_w, mi,
                                           coarsen, coarse_min, rescue=resc)
        return ladders[key]

    def _run_ladder(runx, o, Wx):
        """One ladder execution from the carry at step offset o."""
        xs_e, its, dones, carry2, sy = runx(carry, t0f + o * dt, dt)
        st["syncs"] += sy
        st["nn"] += sum(its)
        for k, it in enumerate(its):
            log.append((o + k * Wx, it))
        return xs_e, dones, carry2

    def _solve_steps_robust(o, Wx, resc=False):
        """Solve steps [o, o+Wx) as ONE ladder window, never accepting a
        diverged carry. On failure: the RESCUE ladder, then halving (floor
        64 steps). Returns False only if a floor-size rescue window still
        fails (accepted then, flagged through `fail`)."""
        nonlocal carry
        xs_e, dones, carry2 = _run_ladder(
            _ladder(Wx, 1, resc and not big), o, Wx)
        ok = all(dones)
        if ok or (Wx <= 64 and (resc or big)):
            carry = carry2
            xs_parts.append(xs_e)
            return ok
        if not resc and not big:
            return _solve_steps_robust(o, Wx, True)
        h = Wx // 2
        okl = _solve_steps_robust(o, h, resc)
        okr = _solve_steps_robust(o + h, Wx - h, resc)
        return okl and okr

    def _tail_rows(Wn):
        """The last Wn solved rows, across as many parts as needed."""
        out, got = [], 0
        for p in reversed(xs_parts):
            out.append(p)
            got += p.shape[0]
            if got >= Wn:
                break
        return torch.cat(list(reversed(out)))[-Wn:]

    def _flat_loop(Wb, nwb, off_steps, n_windows, Xseed, trips_per_win=3):
        """Drive the flat runner over n_windows windows of Wb steps from
        step offset off_steps. A zero-progress execution (seed outside the
        Newton basin) falls back to the robust ladder for that window,
        then seeding resumes. Returns the windows NOT completed."""
        nonlocal carry
        trips = max(trips_per_win * nwb + 4, 32)
        runf = make_flat_runner(cc, params, dyn0, Wb, nwb, trips)
        w = 0
        stall = 0
        while w < n_windows:
            o = off_steps + w * Wb
            te = t0f + o * dt
            xs_e, tw_, ti_, wv, Qc, qdc, Xexit, sy = runf(
                carry[1], carry[2], te, dt, Xseed)
            st["syncs"] += sy
            st["nn"] += sum(ti_)
            for k in range(nwb):
                its = sum(i for ww, i in zip(tw_, ti_) if ww == k)
                if its:
                    log.append((o + k * Wb, its))
            if wv == 0:
                if big:
                    return n_windows - w
                stall += 1
                if stall > 3:
                    return n_windows - w
                st["all_done"] = _solve_steps_robust(
                    off_steps + w * Wb, Wb, stall > 1) and st["all_done"]
                w += 1
                Xseed = _tail_rows(Wb)
                continue
            stall = 0
            take = min(wv, n_windows - w)
            xs_np = xs_e[: take * Wb]
            xs_parts.append(xs_np)
            if take < wv:
                # tail overshoot: re-anchor at the truncation point
                carry = _carry_at(xs_np[-1], te + take * Wb * dt)
            else:
                carry = (xs_np[-1], Qc, qdc, carry[3])
            w += take
            Xseed = Xexit
        return 0

    def _serial_chunk(CH, mi_osc, done_pts):
        nonlocal carry
        xs_e, dones, carry2 = _run_ladder(_ladder(1, CH, mi=mi_osc),
                                          done_pts, 1)
        # a failed single implicit step is a stuck DAE point: flag it
        carry = carry2
        xs_parts.append(xs_e)
        st["all_done"] = st["all_done"] and all(dones)

    if use_seeded:
        # window 0's seed: a serial transient at 8 dt on the window's grid
        k1 = gj_solve.launches
        with obs.span("seed"):
            if xseed is None:
                grid = t0f + dt * (1.0 + np.arange(W))
                s0 = serial_tran(cc, (t0f, t0f + W * dt), params, dt=8 * dt,
                                 dtmax=8 * dt, save_ts=grid, x0=carry[0])
                Xseed0 = s0.xs.contiguous()
                st["syncs"] += s0.host_syncs
            else:
                Xseed0 = torch.as_tensor(xseed, dtype=DTYPE,
                                         device=dev).clone()
        st["k1_seed"] = gj_solve.launches - k1
    with obs.span("windows"):
        if osc and not use_seeded and n_steps >= 2 * osc_window:
            # autonomous oscillator: phase A solves serial single-step
            # windows (CH per execution) while the host watches for a stable
            # period; phase B seeds windows snapped to ~m measured periods
            # with the last solved period tiled
            done_pts = 0
            P = None
            mi_osc = max(max_iters, 160)
            CH = int(min(128, n_steps))
            while done_pts + CH <= n_steps:
                _serial_chunk(CH, mi_osc, done_pts)
                done_pts += CH
                acc = torch.cat(xs_parts).cpu().numpy()
                P = detect_period(acc, dt, min_cross=4)
                if P is not None and done_pts >= int(round(P / dt)) + 2:
                    break
                P = None
            if P is not None:
                # the period quantized to 1/4 step
                pstep_f = round(P / dt * 4.0) / 4.0
                if osc_period is not None:
                    pinned = round(osc_period / dt * 4.0) / 4.0
                    if abs(pinned - pstep_f) <= 0.02 * pstep_f:
                        pstep_f = pinned
                    else:
                        warnings.warn(
                            f"osc_period pin {pinned} steps disagrees with "
                            f"the measured period {pstep_f} steps by >2%; "
                            "using the measurement", stacklevel=2)
                m = max(1, int(round(W / pstep_f)))
                Wb = int(round(m * pstep_f))
                rem = n_steps - done_pts
                # overshoot the remainder with full windows; the result is
                # truncated at n_steps + 1 rows
                n_winB = (rem + Wb - 1) // Wb if Wb >= 8 else 0
                if n_winB >= 1:
                    pi = max(2, int(round(pstep_f)))
                    tail = acc[-pi:]
                    reps = int(np.ceil(Wb / pi)) + 1
                    Xseed = torch.as_tensor(np.tile(tail, (reps, 1))[-Wb:],
                                            dtype=DTYPE, device=dev)
                    left = _flat_loop(Wb, min(n_exec, n_winB), done_pts,
                                      n_winB, Xseed,
                                      trips_per_win=4 if big else 3)
                    done_pts += (n_winB - left) * Wb
            # the trailing remainder, and the no-period fallback
            while done_pts < n_steps:
                _serial_chunk(CH, mi_osc, done_pts)
                done_pts += CH
        elif use_seeded:
            left = _flat_loop(W, min(n_exec, n_win), 0, n_win, Xseed0)
            while left > 0:
                # seeding gave up (repeated stalls): the robust ladder, one
                # window at a time
                st["all_done"] = _solve_steps_robust(
                    (n_win - left) * W, W) and st["all_done"]
                left -= 1
        else:
            run = _ladder(W, n_exec)
            done_w = 0
            while done_w < n_win:
                o = done_w * W
                te = t0f + o * dt
                xs_e, dones, carry_l = _run_ladder(run, o, W)
                if all(dones):
                    carry = carry_l
                    xs_parts.append(xs_e)
                    done_w += n_exec
                else:
                    # salvage the converged prefix; the hard window through
                    # the robust ladder (never accept a poisoned carry)
                    k = dones.index(False)
                    if k > 0:
                        xs_np = xs_e[: k * W]
                        xs_parts.append(xs_np)
                        carry = _carry_at(xs_np[-1], te + k * W * dt)
                    st["all_done"] = _solve_steps_robust(
                        (done_w + k) * W, W, True) and st["all_done"]
                    done_w += k + 1
        xs = torch.cat([x0[None, :]] + xs_parts)[:n_steps + 1]
        xs[-1, 0].item()          # the run's end, for the wall time
    ts = t0f + dt * np.arange(n_steps + 1)
    stats = TranStats(naccept=torch.tensor(n_steps),
                      nreject=torch.tensor(0),
                      nnewton=torch.tensor(st["nn"]),
                      fail=torch.tensor(not st["all_done"]))
    # the spans add "op", "windows" and, on the periodic-seeded path,
    # "seed" to these timings
    sol = TranSolution(cc, ts, xs, stats, op_converged=op_conv,
                       host_syncs=st["syncs"], op_iters=op_iters,
                       timings={"seed": 0.0})
    sol.window_iters = log
    sol.window = W
    sol.xseed = Xseed0
    sol.k1_launches = {"op": k1_op - k1_0, "seed": st["k1_seed"],
                       "windows": gj_solve.launches - k1_op - st["k1_seed"]}
    return sol


def serial_trap(cc: CompiledCircuit, tspan, dt, *, params=None, x0=None,
                max_iters: int = 96, chunk: int = 500):
    """The trapezoidal recursion `tran_pit` solves, solved one step at a
    time (single-step ladder windows, `chunk` steps per execution) from the
    same operating point: a witness of the window solver that shares no
    window coupling with it. Returns (xs [n_steps + 1, n], whether every
    step converged)."""
    dev, spec = cc.device, cc.spec
    t0f = float(tspan[0])
    n_steps = int(round((float(tspan[1]) - t0f) / dt))
    dyn_op = spec.dyn(dev, mode=MODE_TRANOP, time=t0f)
    params = ensure_setup(cc, cc.params0() if params is None else params,
                          dyn_op)
    if x0 is None:
        x0 = dc(cc, params, mode=MODE_TRANOP, time=t0f).x
    x0 = torch.as_tensor(x0, dtype=DTYPE, device=dev)
    xp = pad_state(x0[None])
    F, Q = make_rhs_assembler(cc)(xp, params, dyn_op._replace(
        time=torch.as_tensor(t0f, dtype=DTYPE, device=dev)))
    carry = (x0, Q[0], -F[0], make_assembler(cc).init_lim(xp)[0])
    dyn0 = spec.dyn(dev, mode=MODE_TRAN, time=t0f)
    runners, parts, ok, done = {}, [x0[None]], True, 0
    while done < n_steps:
        ch = min(chunk, n_steps - done)
        if ch not in runners:
            runners[ch] = make_pit_runner(cc, params, dyn0, 1, ch, max_iters)
        xs, _, dones, carry, _ = runners[ch](carry, t0f + done * dt, dt)
        parts.append(xs)
        ok = ok and all(dones)
        done += ch
    return torch.cat(parts), ok
