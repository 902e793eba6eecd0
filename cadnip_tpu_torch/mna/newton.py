"""Newton–Raphson with the SPICE DC robustness chain and its rescue tiers
(PyTorch port of `cadnip_tpu/mna/newton.py`), on the dense backend or the
block-bordered-diagonal one (`ops/bbd.py`) for a partitioned circuit.

Batch-first: the state is [B, n] with per-lane done masks, B = 1 being the
serial case. The JAX package's `lax.while_loop`s become Python loops that
step every lane still running and read the any-lane-running flag to the
host once per iteration; lanes that are done keep their state, which is
what JAX's batched while_loop does under vmap. Limiter state is carried
across iterations (SPICE limiter semantics).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..config import DTYPE, ITYPE
from ..ops.linalg import solve as dense_solve
from .assemble import make_assembler, make_rhs_assembler, pad_state
from .devices import CLASS_V
from .spec import DynSpec
from .structure import CompiledCircuit


def abstol_vector(cc: CompiledCircuit) -> torch.Tensor:
    """Per-unknown absolute tolerance by class (reference `build.jl:276`)."""
    s = cc.spec
    tab = np.array([s.vntol, s.abstol, s.chgtol])
    return torch.as_tensor(tab[cc.classes], dtype=DTYPE, device=cc.device)


def damp_step(dx, is_v, max_dv):
    """Scale each lane's WHOLE step so no voltage moves more than max_dv
    (scaling, not clipping, preserves the Newton direction). The scale
    carries no derivative, as under the JAX package's stop_gradient."""
    vstep = torch.amax(torch.where(is_v, dx.abs(), 0.0), dim=-1,
                       keepdim=True).detach()
    return dx * torch.clamp(max_dv / torch.clamp(vstep, min=1e-300),
                            max=1.0)


def _any(run) -> bool:
    """Whether any lane still runs: the Newton loop's one host read per
    iteration, where the host waits for the device's backlog (span
    "sync")."""
    with obs.span("sync"):
        return bool(run.any())


def _lane_col(v):
    """0-d or [B] tensor -> broadcastable [B or 1, 1]."""
    return torch.as_tensor(v).reshape(-1, 1)


class NewtonResult(NamedTuple):
    x: torch.Tensor          # [B, n]
    converged: torch.Tensor  # [B] bool
    iters: torch.Tensor      # [B] int64
    resnorm: torch.Tensor    # [B] max-abs KCL residual at the solution


def make_system_assembler(cc: CompiledCircuit):
    """The assembler of cc's backend: the BBD tensors of a partitioned
    circuit (built once per circuit: its host stamp maps are the costly
    part), else the dense matrices."""
    if cc.bbd is None:
        return make_assembler(cc)
    if "bbd_assembler" not in cc.cache:
        from .bbd_assemble import make_bbd_assembler
        cc.cache["bbd_assembler"] = make_bbd_assembler(cc, cc.bbd)
    return cc.cache["bbd_assembler"]


def _make_assemble_solve(cc: CompiledCircuit, assemble, method):
    """Returns (assemble, solve_J, matvec): solve_J(G, C, c0, rhs) solves
    (G + c0*C) dx = rhs per lane; matvec(M, v) applies M to v [B, n]. G, C
    and M are the backend's form: dense [B, n, n], or the BBD tensors
    (D, E, F, B), each with its lane axis."""
    if cc.bbd is not None:
        from ..ops.bbd import bbd_matvec, make_bbd_solver
        assemble = assemble or make_system_assembler(cc)
        key = ("bbd_solver", method)
        if key not in cc.cache:
            cc.cache[key] = make_bbd_solver(cc.bbd, cc.device, method,
                                            nested=cc.bbd_nested)
        bbd_solve = cc.cache[key]

        def solve_J(G, C, c0, rhs):
            c0 = torch.as_tensor(c0, dtype=DTYPE, device=rhs.device)
            J = tuple(g + c0.reshape((-1,) + (1,) * (g.ndim - 1)) * c
                      for g, c in zip(G, C))
            return bbd_solve(*J, rhs)

        def matvec(M, v):
            return bbd_matvec(cc.bbd, M, v)

        return assemble, solve_J, matvec
    assemble = assemble or make_assembler(cc)

    def solve_J(G, C, c0, rhs):
        c0 = torch.as_tensor(c0, dtype=DTYPE, device=G.device)
        return dense_solve(G + c0.reshape(-1, 1, 1) * C, rhs, method=method)

    def matvec(M, v):
        return (M @ v[..., None])[..., 0]

    return assemble, solve_J, matvec


def make_newton(cc: CompiledCircuit, assemble=None, method: str | None = None):
    """Build newton(x0 [B, n], params, dyn, active=None, lim0=None) ->
    NewtonResult. The limiter state starts from lim0, or from x0 if none
    is given; lanes outside `active` do not iterate."""
    spec = cc.spec
    assemble, solve_J, _ = _make_assemble_solve(cc, assemble, method)
    atol = abstol_vector(cc)
    is_v = torch.as_tensor(cc.classes == CLASS_V, device=cc.device)
    max_iters = spec.max_newton_iters

    def step(x, lim, params, dyn):
        with obs.span("assemble"):
            F, _, G, C, lim_new = assemble(pad_state(x), lim, params, dyn)
        with obs.span("solve"):
            dx = solve_J(G, C, 0.0, -F)
        if spec.max_dv > 0:
            dx = damp_step(dx, is_v, spec.max_dv)
        x_new = x + dx
        ok_dx = dx.abs() <= spec.reltol * torch.maximum(x_new.abs(),
                                                        x.abs()) + atol
        return x_new, lim_new, ok_dx.all(-1), F.abs().amax(-1)

    def newton(x0, params, dyn: DynSpec, active=None,
               lim0=None) -> NewtonResult:
        x = torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
        B = x.shape[0]
        lim = assemble.init_lim(pad_state(x)) if lim0 is None else lim0
        it = torch.zeros(B, dtype=ITYPE, device=x.device)
        done = torch.zeros(B, dtype=torch.bool, device=x.device)
        resnorm = torch.full((B,), float("inf"), dtype=DTYPE,
                             device=x.device)
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=x.device)
        while True:
            run = active & ~done & (it < max_iters)
            if not _any(run):
                break
            with obs.span("iter"):
                x_new, lim_new, ok, rn = step(x, lim, params, dyn)
                bad = ~torch.isfinite(x_new).all(-1)
                keep = (bad | ~run)[:, None]
                x = torch.where(keep, x, x_new)
                lim = torch.where(keep, lim, lim_new)
                it = it + run.to(ITYPE)
                done = torch.where(run, ok & ~bad, done)
                resnorm = torch.where(run, rn, resnorm)
        return NewtonResult(x=x, converged=done, iters=it, resnorm=resnorm)

    return newton


class TranNewtonResult(NamedTuple):
    x: torch.Tensor
    lim: torch.Tensor
    q: torch.Tensor          # charge vector at the solution
    f: torch.Tensor          # resistive residual at the solution
    converged: torch.Tensor
    iters: torch.Tensor


def make_tran_newton(cc: CompiledCircuit, assemble=None,
                     method: str | None = None):
    """Newton for one implicit integration step: solves
        f(x) + c0*q(x) - rhs_q = 0     with Jacobian  G + c0*C
    per lane (c0 0-d or [B], rhs_q [B, n])."""
    spec = cc.spec
    assemble, solve_J, matvec = _make_assemble_solve(cc, assemble, method)
    atol = abstol_vector(cc)
    is_v = torch.as_tensor(cc.classes == CLASS_V, device=cc.device)
    max_iters = spec.max_newton_iters

    def newton_t(x0, lim0, params, dyn: DynSpec, c0, rhs_q
                 ) -> TranNewtonResult:
        x = torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
        B, n = x.shape
        lim = lim0
        c0c = _lane_col(torch.as_tensor(c0, dtype=DTYPE, device=x.device))
        it = torch.zeros(B, dtype=ITYPE, device=x.device)
        done = torch.zeros(B, dtype=torch.bool, device=x.device)
        Qs = torch.zeros((B, n), dtype=DTYPE, device=x.device)
        Fs = torch.zeros((B, n), dtype=DTYPE, device=x.device)
        while True:
            run = ~done & (it < max_iters)
            if not _any(run):
                break
            with obs.span("iter"):
                with obs.span("assemble"):
                    F, Q, G, C, lim_new = assemble(pad_state(x), lim,
                                                   params, dyn)
                Ft = F + c0c * Q - rhs_q
                with obs.span("solve"):
                    dx = solve_J(G, C, c0c, -Ft)
                if spec.max_dv > 0:
                    dx = damp_step(dx, is_v, spec.max_dv)
                x_new = x + dx
                ok = (dx.abs() <= spec.reltol * torch.maximum(
                    x_new.abs(), x.abs()) + atol).all(-1)
                bad = ~torch.isfinite(x_new).all(-1)
                # first-order charge correction: q(x_new) ~= Q + C dx
                Qc = Q + matvec(C, dx)
                keep = (bad | ~run)[:, None]
                x = torch.where(keep, x, x_new)
                lim = torch.where(keep, lim, lim_new)
                r = run[:, None]
                Qs = torch.where(r, Qc, Qs)
                Fs = torch.where(r, F, Fs)
                it = it + run.to(ITYPE)
                done = torch.where(run, ok & ~bad, done)
        return TranNewtonResult(x=x, lim=lim, q=Qs, f=Fs, converged=done,
                                iters=it)

    return newton_t


def _make_be_march(cc: CompiledCircuit, method: str | None):
    """Build march(x0 [B, n], params, dyn, hs) -> (x, lim): one implicit
    Euler step of size h from the previous state for each h in hs, every
    lane at once. A lane whose step fails to converge keeps its state."""
    assemble = make_system_assembler(cc)
    newton_t = make_tran_newton(cc, assemble=assemble, method=method)
    rhs = make_rhs_assembler(cc)

    def march(x0, params, dyn: DynSpec, hs):
        x = torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
        lim = assemble.init_lim(pad_state(x))
        _, q = rhs(pad_state(x), params, dyn)
        for h in hs:
            r = newton_t(x, lim, params, dyn, 1.0 / h, q / h)
            ok = (r.converged & torch.isfinite(r.x).all(-1))[:, None]
            x = torch.where(ok, r.x, x)
            lim = torch.where(ok, r.lim, lim)
            q = torch.where(ok, r.q, q)
        return x, lim

    return march


def make_uic_warmup(cc: CompiledCircuit, method: str | None = None,
                    n_steps: int = 8):
    """Fixed small-step implicit-Euler warmup from a UIC initial state
    (reference CedarUICOp, `src/mna/dcop.jl:311-411`): projects the
    algebraic unknowns onto the constraint manifold while the tiny step
    freezes every differential state at its .ic value."""
    march = _make_be_march(cc, method)

    def warmup(x0, params, dyn: DynSpec, h):
        return march(x0, params, dyn, [h] * n_steps)[0]

    return warmup


# The rescue tiers' schedules, as the JAX package's builders default them
# (`cadnip_tpu/mna/newton.py:196-198, 216, 266-267`).
PTRAN_STEPS = [float(h) for h in np.geomspace(1e-12, 1e3, 15)]
LM_LAM0 = 1e-3
LM_ITERS_PER_NEWTON = 4          # LM's cap is 4 * spec.max_newton_iters


def make_ptran_rescue(cc: CompiledCircuit):
    """Pseudo-transient continuation rescue (the reference's
    PseudoTransient tier in CedarRobustNLSolve, `src/mna/solve.jl:463-527`):
    march backward-Euler steps with geometrically growing h, so that the
    circuit's own charges damp the iteration (as h -> inf the fixed point
    is the DC solution), then confirm with a plain Newton at the target
    conditions from the marched state and limiter state. Every lane
    marches; the result's iteration count is the confirming Newton's, as
    in the JAX package."""
    march = _make_be_march(cc, None)
    newton = make_newton(cc)

    def rescue(x0, params, dyn: DynSpec) -> NewtonResult:
        x, lim = march(x0, params, dyn, PTRAN_STEPS)
        return newton(x, params, dyn, lim0=lim)

    return rescue


def make_lm_rescue(cc: CompiledCircuit):
    """Levenberg-Marquardt damped Newton, the LM member of the reference's
    `CedarRobustNLSolve` polyalgorithm (`src/mna/solve.jl:463-472`).

    Solves (G + lam*diag(d)) dx = -F per lane, with d the Jacobian's row
    scales. A step that reduces ||F||_2 is accepted and shrinks that lane's
    lam toward plain Newton; a rejected step grows it toward steepest
    descent. A lane converges on an accepted, nearly undamped step
    (lam < 1e-6) that passes the usual dx test. Dense circuits only: the
    BBD backend's block form has no cheap diagonal-shift solve."""
    spec = cc.spec
    if cc.bbd is not None:
        raise ValueError("LM rescue supports the dense backend only")
    assemble, solve_J, _ = _make_assemble_solve(cc, None, None)
    atol = abstol_vector(cc)
    is_v = torch.as_tensor(cc.classes == CLASS_V, device=cc.device)
    max_iters = LM_ITERS_PER_NEWTON * spec.max_newton_iters

    def lm(x0, params, dyn: DynSpec) -> NewtonResult:
        x = torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
        B = x.shape[0]
        lim = assemble.init_lim(pad_state(x))
        lam = torch.full((B,), LM_LAM0, dtype=DTYPE, device=x.device)
        it = torch.zeros(B, dtype=ITYPE, device=x.device)
        done = torch.zeros(B, dtype=torch.bool, device=x.device)
        rn = torch.full((B,), float("inf"), dtype=DTYPE, device=x.device)
        while True:
            run = ~done & (it < max_iters)
            if not _any(run):
                break
            with obs.span("iter"):
                with obs.span("assemble"):
                    F, _, G, _, lim_new = assemble(pad_state(x), lim, params,
                                                   dyn)
                d = torch.clamp(G.abs().amax(-1), min=1e-12)
                with obs.span("solve"):
                    dx = solve_J(G, torch.diag_embed(d), lam, -F)
                if spec.max_dv > 0:
                    dx = damp_step(dx, is_v, spec.max_dv)
                x_t = x + dx
                with obs.span("assemble"):
                    F_t, _, _, _, lim_t = assemble(pad_state(x_t), lim_new,
                                                   params, dyn)
                f0 = (F * F).sum(-1)
                f1 = (F_t * F_t).sum(-1)
                better = ((f1 < f0) & torch.isfinite(x_t).all(-1)
                          & torch.isfinite(f1))
                small = (dx.abs() <= spec.reltol * torch.maximum(
                    x_t.abs(), x.abs()) + atol).all(-1)
                ok = better & (lam < 1e-6) & small
                r, b = run[:, None], better[:, None]
                x = torch.where(r & b, x_t, x)
                # the limiter anchor ALWAYS advances (SPICE practice): a frozen
                # anchor makes the companion-limited residual look converged at
                # a false solution, deadlocking the accept test
                lim = torch.where(r, torch.where(b, lim_t, lim_new), lim)
                lam = torch.where(run, torch.where(
                    better, torch.clamp(lam * 0.25, min=1e-12),
                    torch.clamp(lam * 8.0, max=1e10)), lam)
                rn = torch.where(run, torch.where(better, F_t.abs().amax(-1),
                                                  F.abs().amax(-1)), rn)
                it = it + run.to(ITYPE)
                done = torch.where(run, ok, done)
        return NewtonResult(x=x, converged=done, iters=it, resnorm=rn)

    return lm


def make_dc_solver(cc: CompiledCircuit, assemble=None,
                   method: str | None = None):
    """Full DC chain: Newton -> gmin (gshunt) stepping -> source stepping
    (reference `_dc_solve_with_fallbacks`, `solve.jl:871-929`), as one loop
    over a (gshunt, srcfact) homotopy schedule. A lane is solved when an
    entry at the target conditions (gshunt == spec.gshunt, srcfact == 1)
    converges; Newton runs on an entry only while some lane is not done."""
    spec = cc.spec
    newton = make_newton(cc, assemble=assemble, method=method)

    gl = list(np.geomspace(spec.gshunt_start, max(spec.gshunt, 1e-15),
                           spec.gmin_steps))
    ramp = list(np.linspace(1.0 / spec.src_steps, 1.0, spec.src_steps))
    sched_gs = [spec.gshunt] + gl + [spec.gshunt] + [spec.gshunt] * len(ramp)
    sched_sf = [1.0] * (2 + len(gl)) + ramp
    sched_fin = ([True] + [False] * len(gl) + [True]
                 + [False] * (len(ramp) - 1) + [True])
    # the tier of each entry, the span its Newton records under
    sched_tier = (["direct"] + ["gmin"] * (len(gl) + 1)
                  + ["source"] * len(ramp))

    def dc_solve(x0, params, dyn: DynSpec) -> NewtonResult:
        x = torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
        B = x.shape[0]
        done = torch.zeros(B, dtype=torch.bool, device=x.device)
        iters = torch.zeros(B, dtype=ITYPE, device=x.device)
        rn = torch.full((B,), float("inf"), dtype=DTYPE, device=x.device)
        for gs, sf, fin, tier in zip(sched_gs, sched_sf, sched_fin,
                                     sched_tier):
            with obs.span("sync"):
                if bool(done.all()):
                    break
            with obs.span(tier):
                d = dyn._replace(
                    gshunt=torch.as_tensor(gs, dtype=DTYPE, device=x.device),
                    srcfact=torch.as_tensor(sf, dtype=DTYPE,
                                            device=x.device))
                r = newton(x, params, d, active=~done)
                active = ~done
                x = torch.where(active[:, None], r.x, x)
                rn = torch.where(active, r.resnorm, rn)
                iters = iters + r.iters
                if fin:
                    done = done | (active & r.converged)
        return NewtonResult(x=x, converged=done, iters=iters, resnorm=rn)

    return dc_solve
