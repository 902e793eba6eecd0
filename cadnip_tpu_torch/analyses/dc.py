"""DC operating-point analysis and named solutions (PyTorch port of
`cadnip_tpu/analyses/dc.py`).

The chain is Newton -> gmin stepping -> source stepping
(`mna/newton.py::make_dc_solver`). Where it fails on some lane, `dc` runs
the rescue tiers of the JAX package in its order: pseudo-transient
continuation, then Levenberg-Marquardt (dense circuits only: on a
block-bordered-diagonal circuit the chain ends with the pseudo-transient
tier, as in the JAX package). Where they fail too, `dc` returns
`converged=False`; it does not guess. The pseudo-transient tier takes the
JAX package's choice of algorithm, which is keyed on the model: an
unbatched circuit with a hoisted Verilog-A setup pass (`va_setup`) steps
its pseudo-time from the host and confirms with the whole DC chain
(`_ptran_rescue_host`); every other call takes the fused tier
(`make_ptran_rescue`), which confirms with one plain Newton. Every entry
point computes the setup matrix of a hoisting model first
(`ensure_setup`), and the solution keeps the parameters it was solved
with.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..config import DTYPE
from ..mna.assemble import (RANK2_LEAVES, ensure_setup, make_rhs_assembler,
                            pad_state)
from ..mna.newton import (NewtonResult, make_dc_solver, make_lm_rescue,
                          make_ptran_rescue, make_system_assembler,
                          make_tran_newton)
from ..mna.spec import MODE_DCOP, MODE_TRANOP
from ..mna.structure import CompiledCircuit


def param_lanes(params):
    """Number of lanes B a parameter list carries, or None if no leaf has
    a lane axis ([B, n_inst], or [B, n_inst, width] for coefficients and
    the host-setup matrix)."""
    for d in params:
        for k, v in d.items():
            if isinstance(v, dict):
                b = param_lanes([v])
                if b is not None:
                    return b
            elif v.ndim > (2 if k in RANK2_LEAVES else 1):
                return v.shape[0]
    return None


class DCSolution:
    """Name-addressable operating point: sol['out'] is a node voltage,
    sol['v1#i'] a V-source or inductor branch current, sol.v('a','b') a
    difference. Batched solutions index the same way with a leading lane
    axis."""

    def __init__(self, cc: CompiledCircuit, x, converged, iters,
                 resnorm=None, params=None):
        self.cc = cc
        self.x = x
        self.converged = converged
        self.iters = iters
        self.resnorm = resnorm
        self.params = params

    def __getitem__(self, name):
        return self.x[..., self.cc.index_of(str(name))]

    def v(self, p, n=None):
        vp = self[p]
        return vp if n is None else vp - self[n]

    def i(self, source_name):
        """Branch current through a V source or inductor."""
        return self[f"{source_name}#i"]

    def keys(self):
        return self.cc.names.keys()

    def _eval_device(self, inst):
        """One instance's group, local unknowns, parameters, DynSpec and
        connections at the operating point."""
        if self.x.ndim != 1:
            raise ValueError("per-device evaluation needs an unbatched "
                             "solution; index one lane first")
        gi, slot = self.cc.inst_group[inst]
        g = self.cc.groups[gi]
        params = self.params if self.params is not None \
            else self.cc.params0()

        def one(v):
            return {k: one(w) for k, w in v.items()} \
                if isinstance(v, dict) else v[slot]

        p = {k: one(v) for k, v in params[gi].items()}
        u = pad_state(self.x)[torch.as_tensor(g.conn[slot],
                                              device=self.x.device)]
        return g, u, p, self.cc.spec.dyn(self.x.device), g.conn[slot]

    def currents(self, inst):
        """Terminal currents of a device at the operating point:
        {terminal_name: current flowing INTO the device}."""
        g, u, p, dyn, conn = self._eval_device(inst)
        f = g.model.residual(u, p, dyn)[0].cpu().numpy()
        return {t: float(f[conn == conn[i]].sum())
                for i, t in enumerate(g.model.terminals)}

    def op_info(self, inst):
        """Model-defined operating-point variables (gm, ids, ...) of one
        instance, if its model publishes them."""
        g, u, p, dyn, _ = self._eval_device(inst)
        if g.model.opvars is None:
            return {}
        return {k: float(v) for k, v in g.model.opvars(u, p, dyn).items()}

    def __repr__(self):
        conv = np.asarray(self.converged.cpu())
        stat = "converged" if conv.all() else "NOT CONVERGED"
        lines = [f"DCSolution({self.cc.title!r}, {stat}, "
                 f"iters={np.asarray(self.iters.cpu())})"]
        if self.x.ndim == 1:
            xs = self.x.cpu().numpy()
            for name, idx in sorted(self.cc.names.items(),
                                    key=lambda kv: kv[1])[:40]:
                lines.append(f"  {name:>16s} = {float(xs[idx]):.6g}")
        return "\n".join(lines)


def _cached(cc: CompiledCircuit, key, make):
    if key not in cc.cache:
        with obs.span("build"):
            cc.cache[key] = make(cc)
    return cc.cache[key]


def _get_dc_solver(cc: CompiledCircuit):
    return _cached(cc, "dc_solver", make_dc_solver)


def _all(flags) -> bool:
    """Whether every lane holds: a host read, timed as a wait."""
    with obs.span("sync"):
        return bool(flags.all())


def _take(r: NewtonResult, r2: NewtonResult, take=None) -> NewtonResult:
    """r2's lanes where `take` holds. Without a mask: wherever r2
    converged, with r2's iterations counted on every lane (the JAX
    package's merge of a rescue tier, `dc.py:141-145`). With one: r2's
    iterations count only on the taken lanes (the JAX package's dcsweep
    rescue, `sweeps.py:188-193`)."""
    if take is None:
        take, extra = r2.converged, r2.iters
    else:
        extra = torch.where(take, r2.iters, 0)
    return NewtonResult(x=torch.where(take[:, None], r2.x, r.x),
                        converged=r.converged | r2.converged,
                        iters=r.iters + extra,
                        resnorm=torch.where(take, r2.resnorm, r.resnorm))


def dc(cc: CompiledCircuit, params=None, x0=None, *, mode: int = MODE_DCOP,
       time: float = 0.0, nodeset: dict | None = None,
       rescue: bool = True) -> DCSolution:
    """DC operating point through the homotopy chain, then, only where a
    lane failed and `rescue` is set, the pseudo-transient tier from the
    initial guess and the Levenberg-Marquardt tier from the chain's point.
    A tier runs on every lane; its result is taken wherever it converged.

    Parameters with a lane axis ([B, n_inst] leaves, e.g. from `alter`
    with an array) give a batched solution with x [B, n]; otherwise x is
    [n]. nodeset: {node: voltage} initial-guess seeding (SPICE .nodeset)."""
    if params is None:
        params = cc.params0()
    B = param_lanes(params)
    x = torch.zeros((B or 1, cc.n), dtype=DTYPE, device=cc.device)
    if x0 is not None:
        x = x + torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
    for node, v in (nodeset or {}).items():
        x[:, cc.index_of(str(node))] = float(v)
    dyn = cc.spec.dyn(cc.device, mode=mode, time=time)
    params = ensure_setup(cc, params, dyn)
    r = _get_dc_solver(cc)(x, params, dyn)
    if rescue and not _all(r.converged):
        if B is None and any(g.model.va_setup is not None
                             for g in cc.groups):
            # built here, outside the tier's span, as the other builds
            _cached(cc, "rescue_parts", _make_rescue_parts)
            with obs.span("ptran"):
                r2 = _ptran_rescue_host(cc, x, params, dyn)
        else:
            ptran = _cached(cc, "dc_ptran_rescue", make_ptran_rescue)
            with obs.span("ptran"):
                r2 = ptran(x, params, dyn)
        r = _take(r, r2)
    if rescue and cc.bbd is None and not _all(r.converged):
        # LM after pseudo-transient: ptran's charge damping selects the
        # physically reachable basin on bistable circuits, while LM handles
        # the near-singular Jacobians of charge-free circuits. Dense
        # circuits only, as in the JAX package (`analyses/dc.py:146`)
        lm = _cached(cc, "dc_lm_rescue", make_lm_rescue)
        with obs.span("lm"):
            r = _take(r, lm(r.x, params, dyn))
    if B is None:
        return DCSolution(cc, r.x[0], r.converged[0], r.iters[0],
                          r.resnorm[0], params=params)
    return DCSolution(cc, r.x, r.converged, r.iters, r.resnorm,
                      params=params)


def _make_rescue_parts(cc: CompiledCircuit):
    assemble = make_system_assembler(cc)
    return (assemble, make_tran_newton(cc, assemble=assemble),
            make_rhs_assembler(cc))


def _ptran_rescue_host(cc: CompiledCircuit, x0, params, dyn, n_steps=15,
                       h0=1e-12, h1=1e3) -> NewtonResult:
    """Host-driven pseudo-transient rescue (the JAX package's tier for an
    unbatched circuit with a hoisted Verilog-A setup pass; reference
    PseudoTransient tier, `src/mna/solve.jl:463-527`): backward-Euler
    steps of geometrically growing h from x0 [1, n], each kept only where
    it converged finite, then the whole DC chain from the marched state.
    The iteration count adds the steps' Newton iterations to the chain's."""
    assemble, newton_t, rhs = _cached(cc, "rescue_parts", _make_rescue_parts)
    x = x0
    lim = assemble.init_lim(pad_state(x))
    _, q = rhs(pad_state(x), params, dyn)
    iters = 0
    for h in np.geomspace(h0, h1, n_steps):
        rr = newton_t(x, lim, params, dyn, 1.0 / h, q / h)
        iters += int(rr.iters[0])
        if bool(rr.converged[0]) and bool(torch.isfinite(rr.x).all()):
            x, lim, q = rr.x, rr.lim, rr.q
    r = _get_dc_solver(cc)(x, params, dyn)
    return r._replace(iters=r.iters + iters)


def op_tran(cc: CompiledCircuit, params=None, x0=None,
            t0: float = 0.0) -> DCSolution:
    """Operating point for transient start: time sources evaluated at t0
    (reference CedarTranOp, `src/mna/dcop.jl:98`)."""
    return dc(cc, params, x0, mode=MODE_TRANOP, time=t0)
