"""The plain reference simulator: modified nodal analysis of a parsed
netlist in NumPy, a Newton DC operating point and an adaptive trapezoidal
transient, batched over lanes (Monte Carlo samples or seeded jobs).

It imports nothing of the program under test. Every number is computed
in one dtype, float64 for the reference and float32 for the benchmark's
lower-precision control (`control.py`).

The devices and sources are the model modules of `registry.py`; this file
names none of them. Unknowns: the voltage of every node but ground, then
the internal unknowns that are currents (a V source's branch current),
then those that are voltages (a diode's internal anode), each in the
netlist's order. A device is a group of instances of one model, in the
order its first instance appears, with a terminal map conn [I, L] into the
unknowns (ground maps to n, a row that is dropped); the residual is
f(x) + dq(x)/dt = 0. The linear groups' G and C are stamped once; an
independent source adds its value at the time set (`set_time`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import devices as dv
from . import registry
from .netlist import GROUND, Netlist

GMIN = 1e-12
TRTOL = 7.0          # LTE slack, as SPICE's trtol
MAX_NEWTON = 50


@dataclasses.dataclass
class Group:
    kind: str                 # the model module of its first instance
    names: list
    conn: np.ndarray          # [I, L]
    params: dict              # name -> [B, I]
    module: object            # that module (registry.py)
    waves: list = None        # a source's waveforms, one per instance


class Circuit:
    """The MNA system of a netlist for B lanes. `overrides` maps
    'element.param' to values [B] (a Monte Carlo table)."""

    def __init__(self, net: Netlist, lanes: int = 1, overrides=None,
                 dtype=np.float64, temp_c: float = 27.0):
        self.dtype = np.dtype(dtype)
        self.B = lanes
        self.vt = dv.thermal_voltage(temp_c)
        mods = [registry.module(e.kind) for e in net.elements]
        nodes = {}
        for e in net.elements:
            for nd in e.nodes:
                if nd not in GROUND and nd not in nodes:
                    nodes[nd] = len(nodes)
        self.node_index = dict(nodes)
        n = len(nodes)
        # the internal unknowns by the program's name: currents, then
        # voltages
        self.internal_index = {}
        currents = []
        for cls in ("current", "voltage"):
            for e, mod in zip(net.elements, mods):
                for suffix, kind in mod.INTERNAL:
                    if kind == cls:
                        self.internal_index[e.name + suffix] = n
                        currents.append(cls == "current")
                        n += 1
        self.n = n
        self.classes = np.zeros(n, bool)          # True: a current unknown
        self.classes[len(nodes):] = currents
        overrides = dict(overrides or {})

        def idx(nd):
            return n if nd in GROUND else nodes[nd]

        def param(els, key, vals):
            vals = np.array(vals, np.float64)
            out = np.broadcast_to(vals, (lanes, len(els))).copy()
            for k, e in enumerate(els):
                ov = overrides.pop(f"{e.name}.{key}", None)
                if ov is not None:
                    out[:, k] = np.asarray(ov, np.float64)
            return out.astype(self.dtype)

        by = {}
        for e, mod in zip(net.elements, mods):
            by.setdefault(mod.evaluate, []).append((e, mod))
        self.groups = []
        for members in by.values():
            els = [e for e, _ in members]
            mod = members[0][1]
            resolved = []
            for e, m in members:
                p = {k: e.params.get(k, d) for k, d in m.PARAMS.items()}
                missing = [k for k, v in p.items() if v is None]
                if missing:
                    raise ValueError(f"{e.name}: {missing} not given")
                p.update(m.FIXED)
                if m.validate is not None:
                    m.validate(e.name, p)
                resolved.append(p)
            params = {k: param(els, k, [p[k] for p in resolved])
                      for k in resolved[0]}
            if mod.SOURCE:
                params["val"] = np.zeros((lanes, len(els)), self.dtype)
            conn = [[idx(nd) for nd in e.nodes]
                    + [self.internal_index[e.name + sfx]
                       for sfx, _ in m.INTERNAL] for e, m in members]
            self.groups.append(Group(
                mod.__name__.rsplit(".", 1)[1], [e.name for e in els],
                np.array(conn), params, mod,
                [e.wave for e in els] if mod.SOURCE else None))
        if overrides:
            raise KeyError(f"unknown parameters {sorted(overrides)}")
        # scatter plans: local entries -> the [n + 1] rows / [n + 1]^2
        # entries (row n is ground and is dropped)
        for g in self.groups:
            I, L = g.conn.shape
            n1 = n + 1
            rows = g.conn.reshape(-1)
            g.Sf = np.zeros((I * L, n1), self.dtype)
            g.Sf[np.arange(I * L), rows] = 1.0
            ent = (g.conn[:, :, None] * n1 + g.conn[:, None, :]).reshape(-1)
            g.Sj = np.zeros((I * L * L, n1 * n1), self.dtype)
            g.Sj[np.arange(I * L * L), ent] = 1.0
        self._sources = [g for g in self.groups if g.module.SOURCE]
        self._nonlinear = [g for g in self.groups if not g.module.LINEAR]
        lin = [g for g in self.groups if g.module.LINEAR]
        z = np.zeros((self.B, self.n), self.dtype)
        # f and q of a linear group are affine in x: G and C at any point
        self._Glin, self._Clin = self._assemble(z, lin)[2:4]
        self.set_time(0.0)

    def set_time(self, t: float):
        """The sources' values at time t."""
        for g in self._sources:
            g.params["val"][:] = np.asarray(
                [g.module.value(w, t) for w in g.waves], self.dtype)
        z = np.zeros((self.B, self.n), self.dtype)
        self._src = self._assemble(z, self._sources)[0]

    def breakpoints(self, t0: float, tstop: float) -> list:
        """The sources' corners in (t0, tstop), in order, as float64
        scalars, then tstop. (A float64 scalar is not weak under NumPy's
        promotion: the float32 control's steps after a corner take it.)"""
        out = set()
        for g in self._sources:
            for w in g.waves:
                out.update(g.module.corners(w, tstop))
        bps = np.asarray(sorted(out), np.float64)
        return [b for b in bps if t0 < b < tstop] + [tstop]

    def _assemble(self, x, groups, lims=None):
        B, n = x.shape
        n1 = n + 1
        F = np.zeros((B, n1), x.dtype)
        Q = np.zeros((B, n1), x.dtype)
        G = np.zeros((B, n1 * n1), x.dtype)
        C = np.zeros((B, n1 * n1), x.dtype)
        new_lims = []
        for k, g in enumerate(groups):
            u = self.local(x, g)
            ue = u
            if lims is not None and g.module.limit is not None:
                ue = g.module.limit(u, lims[k], g.params, self.vt).astype(
                    x.dtype)
            new_lims.append(ue)
            f, q, Gl, Cl = g.module.evaluate(ue, g.params, self.vt, GMIN)
            if ue is not u:
                du = (u - ue)[..., None, :]
                f = f + (Gl * du).sum(-1)
                q = q + (Cl * du).sum(-1)
            I, L = g.conn.shape
            F += f.reshape(B, I * L).astype(x.dtype) @ g.Sf
            Q += q.reshape(B, I * L).astype(x.dtype) @ g.Sf
            G += np.ascontiguousarray(Gl, x.dtype).reshape(B, -1) @ g.Sj
            C += np.ascontiguousarray(Cl, x.dtype).reshape(B, -1) @ g.Sj
        G = G.reshape(B, n1, n1)[:, :n, :n]
        C = C.reshape(B, n1, n1)[:, :n, :n]
        return F[:, :n], Q[:, :n], G, C, new_lims

    def init_lim(self, x):
        """The first evaluation points of the nonlinear devices: the
        state."""
        return [self.local(x, g) for g in self._nonlinear]

    def local(self, x, g):
        xp = np.concatenate([x, np.zeros((x.shape[0], 1), x.dtype)], 1)
        return xp[:, g.conn]

    def evaluate(self, x, lims=None):
        """F, Q [B, n] and G, C [B, n, n] at x, each limited device
        linearised at its limited point when `lims` (the previous
        evaluation points) is given; returns the new evaluation points."""
        F, Q, G, C, new_lims = self._assemble(x, self._nonlinear, lims)
        F = F + self._src + (self._Glin @ x[..., None])[..., 0]
        Q = Q + (self._Clin @ x[..., None])[..., 0]
        return F, Q, G + self._Glin, C + self._Clin, new_lims

    def atol(self):
        return np.where(self.classes, 1e-12, 1e-6).astype(self.dtype)


def _converged(dx, x_new, x_old, reltol, atol):
    tol = reltol * np.maximum(np.abs(x_new), np.abs(x_old)) + atol
    return (np.abs(dx) <= tol).all(-1)


def newton(cir: Circuit, x, c0=0.0, rhs=None, reltol=1e-4, gshunt=0.0,
           max_iters=MAX_NEWTON):
    """Solve F(x) + c0 Q(x) - rhs + gshunt x_v = 0 for every lane; returns
    (x, Q, converged [B], iterations)."""
    atol = cir.atol()
    lims = cir.init_lim(x)
    vmask = (~cir.classes).astype(x.dtype)
    conv = np.zeros(x.shape[0], bool)
    for it in range(1, max_iters + 1):
        F, Q, G, C, lims = cir.evaluate(x, lims)
        R = F + c0 * Q + gshunt * vmask * x
        J = G + c0 * C
        if gshunt:
            J = J + gshunt * np.diag(vmask)
        if rhs is not None:
            R = R - rhs
        try:
            dx = -np.linalg.solve(J, R[..., None])[..., 0]
        except np.linalg.LinAlgError:
            return x, Q, np.zeros(x.shape[0], bool), it
        # limit node-voltage steps to 5 V, as SPICE's damping does
        vstep = np.abs(dx * vmask).max(-1, keepdims=True)
        dx = dx * np.minimum(1.0, 5.0 / np.maximum(vstep, 1e-30)).astype(
            x.dtype)
        x_new = x + dx
        if not np.isfinite(x_new).all():
            return x, Q, np.zeros(x.shape[0], bool), it
        conv = _converged(dx, x_new, x, reltol, atol)
        x = x_new
        if conv.all():
            # the charge at the last iterate, to first order in its step
            return x, Q + (C @ dx[..., None])[..., 0], conv, it
    return x, Q, conv, max_iters


def operating_point(cir: Circuit, t0=0.0, reltol=1e-4):
    """DC operating point with the sources at t0: Newton from zero, then
    a gshunt ladder (1e-2 S down to none) where it fails."""
    cir.set_time(t0)
    x0 = np.zeros((cir.B, cir.n), cir.dtype)
    x, _, conv, _ = newton(cir, x0, reltol=reltol)
    if conv.all():
        return x, conv
    x = x0
    for gs in [10.0 ** -k for k in range(2, 13)] + [0.0]:
        x, _, conv, _ = newton(cir, x, reltol=reltol, gshunt=gs,
                               max_iters=4 * MAX_NEWTON)
    return x, conv


@dataclasses.dataclass
class Transient:
    xs: np.ndarray        # [B, n_save, n]
    final: np.ndarray     # [B, 3, n]: x, q and dq/dt at the last step
    ok: bool
    steps: int
    rejects: int
    newton: int


def transient(cir: Circuit, x0, tstop, save_ts, reltol=1e-5, t0=0.0,
              max_steps=2_000_000):
    """Adaptive trapezoidal integration of every lane from x0 [B, n] with
    one shared step (the smallest any lane needs): backward Euler on the
    first step and after each source corner, the LTE from divided
    differences of the state on rows with charge. Saves by linear
    interpolation onto save_ts."""
    dt_ = cir.dtype
    B, n = x0.shape
    x = np.asarray(x0, dt_).copy()
    atol = cir.atol()
    cir.set_time(t0)
    F0, Q0, _, C0, _ = cir.evaluate(x)
    diff = (np.abs(C0).sum(-1) > 0).any(0)
    q, qd = Q0, -F0
    span = tstop - t0
    hmax = span / 50.0
    hmin = span * 1e-14
    bps = cir.breakpoints(t0, tstop)
    save_ts = np.asarray(save_ts, np.float64)
    xs = np.zeros((B, len(save_ts), n), dt_)
    si = int(np.searchsorted(save_ts, t0 * (1 + 1e-12), side="right"))
    xs[:, :si] = x[:, None]
    hist = [(t0, x)]               # the last accepted points, newest last
    t, h = t0, min(span / 1000.0, hmax) / 10.0
    bi, be, steps, rejects, nnewton = 0, True, 0, 0, 0
    while t < tstop * (1 - 1e-12) and steps < max_steps:
        h = min(h, hmax)
        to_bp = bps[bi] - t
        hit = h >= to_bp * (1 - 1e-9)
        if hit:
            h = to_bp
        elif h > 0.5 * to_bp:
            h = 0.5 * to_bp
        t_new = t + h
        c0 = (1.0 if be else 2.0) / h
        rhs = c0 * q + (0.0 if be else qd)
        if len(hist) >= 2:
            (ta, xa), (tb, xb) = hist[-2], hist[-1]
            xp = xb + (xb - xa) * (h / (tb - ta))
        else:
            xp = x
        cir.set_time(t_new)
        xn, qn, conv, its = newton(cir, xp, c0, rhs, reltol=reltol)
        nnewton += its
        steps += 1
        if not conv.all():
            rejects += 1
            if h <= hmin:
                return Transient(xs, np.stack([x, q, qd], 1), False,
                                 steps, rejects, nnewton)
            h, be = h / 8.0, True
            continue
        err = 0.0
        if len(hist) >= 3:
            (t2, x2), (t1, x1) = hist[-3], hist[-2]
            d1a = (xn - x) / h
            d1b = (x - x1) / (t - t1)
            d1c = (x1 - x2) / (t1 - t2)
            d2a = (d1a - d1b) / (t_new - t1)
            d2b = (d1b - d1c) / (t - t2)
            if be:
                lte = h * h * np.abs(d2a)
            else:
                lte = 0.5 * h ** 3 * np.abs((d2a - d2b) / (t_new - t2))
            etol = TRTOL * (reltol * np.maximum(np.abs(xn), np.abs(x))
                            + atol)
            err = float((lte / etol)[:, diff].max())
        if not math.isfinite(err):
            err = math.inf
        if err > 1.0 and h > hmin:
            rejects += 1
            h = h * max(0.9 * err ** (-1.0 / 3.0), 0.1)
            continue
        # accept: save rows in (t, t_new] by linear interpolation
        s1 = int(np.searchsorted(save_ts, t_new * (1 + 1e-12),
                                 side="right"))
        if s1 > si:
            w = np.clip((save_ts[si:s1] - t) / h, 0.0, 1.0).astype(dt_)
            xs[:, si:s1] = x[:, None] + w[None, :, None] * (xn - x)[:, None]
            si = s1
        qd = c0 * qn - rhs
        q, x, t = qn, xn, t_new
        hist = (hist + [(t, x)])[-3:]
        fac = 2.0 if err == 0.0 else min(max(0.8 * err ** (-1.0 / 3.0),
                                             0.3), 2.0)
        h = h * fac
        be = False
        if hit:
            bi += 1
            be = True
            if bi < len(bps):
                h = min(h, 0.1 * (bps[bi] - t))
    ok = si == len(save_ts) and bool(np.isfinite(xs).all())
    return Transient(xs, np.stack([x, q, qd], 1), ok, steps, rejects,
                     nnewton)
