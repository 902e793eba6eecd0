"""Batched residual/Jacobian assembly (PyTorch port of
`cadnip_tpu/mna/assemble.py`, dense path).

Per device group: gather the local unknowns, evaluate the residual and its
local Jacobians with `torch.func` autodiff (vmapped over lanes x
instances), then scatter-add into the global system. Ground is a padding
slot (index n): gathers read 0.0 from it and rows/columns n are sliced
away.

The Jacobians come from reverse mode (`jacrev`), where the JAX package
linearizes forward. Both give the same matrix to rounding, and the device
functions are traceable by either. Reverse mode is the faster of the two
in torch: its forward mode takes a slow path, with shape checks in
Python, for every operation whose operand carries no tangent (every
parameter and literal of a device function). On the CPU, measured on the
DFF's 26-instance MOS group, that is 11.3 ms for vmap(jacfwd) against
2.3 ms for vmap(jacrev) per evaluation.

Every tensor carries a leading lane axis B: x_pad is [B, n+1], the limiter
state [B, n_lim], parameters [n_inst] (shared) or [B, n_inst] (per lane),
DynSpec fields 0-d or [B]. B = 1 is the serial case.

Verilog-A groups take two more paths, as in the JAX package: a model with
`$limit` sites (`residual_lim`) carries one limiter state per probe branch
and anchors its companion at the limited point through the site hooks
(`_group_eval_sites`); a model with a hoisted setup pass (`va_setup`)
takes central-difference Jacobians (`_group_eval_fd`). `ensure_setup`
computes the setup matrix `p["__setup__"]` ([n_inst, K]) at every solver
entry.

The scatter is deterministic: on CUDA, `index_add_`/`scatter_add_` on f64
use atomics whose summation order changes from run to run. Instead the host
builds, once per circuit, a padded [U, Kmax] gather plan per destination
(pad slots read an appended zero) and the device sums over the last axis.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacrev, vmap

from .. import obs
from ..config import DTYPE, ITYPE
from .devices import CLASS_V
from .spec import DynSpec
from .structure import CompiledCircuit


def pad_state(x):
    """Append the ground slot (0.0)."""
    return torch.cat([x, torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype,
                                     device=x.device)], dim=-1)


def make_sorted_scatter(idx_arrays, out_size, device, skip=None):
    """Host-precomputed deterministic scatter-add plan.

    The flattened stamp destinations of every group are concatenated and
    stably sorted once; destination u gathers its contributions through
    row u of a [U, Kmax] index table (pad entries point at an appended
    zero) and sums them over the last axis. Entries whose destination is
    `skip` (a trash slot) take no part. Returns
    scatter(vals_list) -> [B, out_size] for values of shape [B, ...]."""
    idx = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                          for a in idx_arrays])
    keep = (np.arange(len(idx)) if skip is None
            else np.flatnonzero(idx != skip))
    perm = keep[np.argsort(idx[keep], kind="stable")]
    uniq, starts, counts = np.unique(idx[perm], return_index=True,
                                     return_counts=True)
    seg = np.repeat(np.arange(len(uniq)), counts)
    pos = np.arange(len(perm)) - starts[seg]
    plan = np.full((len(uniq), int(counts.max(initial=1))), len(idx),
                   np.int64)
    plan[seg, pos] = perm
    plan_t = torch.as_tensor(plan, dtype=ITYPE, device=device)
    uniq_t = torch.as_tensor(uniq, dtype=ITYPE, device=device)

    def scatter(vals_list):
        B = vals_list[0].shape[0]
        vals = torch.cat([v.reshape(B, -1) for v in vals_list]
                         + [torch.zeros((B, 1), dtype=DTYPE, device=device)],
                         dim=1)
        out = torch.zeros((B, out_size), dtype=DTYPE, device=device)
        out[:, uniq_t] = vals[:, plan_t].sum(dim=-1)
        return out

    return scatter


def ensure_setup(cc: CompiledCircuit, params, dyn=None):
    """Inject the host-setup value matrix p['__setup__'] for every group
    whose model hoists its setup pass (big VA models, see
    DeviceModel.va_setup). Called at the solver entry points so altered or
    swept parameters are honored; results are cached per (group, params,
    temperature). A no-op when no group hoists, or when the parameters are
    a torch.func transform's tensors (the residual then runs its setup
    pass inline)."""
    if not any(g.model.va_setup is not None for g in cc.groups):
        return params
    if dyn is None:
        dyn = cc.spec.dyn(cc.device)
    try:
        temp = float(dyn.temp)
    except (RuntimeError, ValueError, TypeError):
        return params
    out = list(params)
    cache = cc.cache.setdefault("__setup_cache__", {})
    for gi, g in enumerate(cc.groups):
        if g.model.va_setup is None:
            continue
        p = dict(out[gi])
        try:
            arrs = {k: v.detach().cpu().numpy() for k, v in p.items()
                    if k != "__setup__"}
        except (RuntimeError, ValueError):
            continue      # transformed params: leave the inline setup path
        fp = (gi, temp, tuple(sorted(
            (k, v.tobytes()) for k, v in arrs.items())))
        mat = cache.get(fp)
        if mat is None:
            mat = cache[fp] = g.model.va_setup(arrs, dyn)
        p["__setup__"] = torch.as_tensor(mat, dtype=DTYPE, device=cc.device)
        out[gi] = p
    return out


#: leaves whose unbatched rank is 2: waveform coefficients [n_inst, width]
#: and the host-setup matrix [n_inst, K]
RANK2_LEAVES = ("coeffs", "__setup__")


def _lane_params(p, B, I):
    """Flatten a group's parameter dict to [B*I, ...] leaves: a leaf of the
    unbatched rank ([n_inst], or [n_inst, width] for `RANK2_LEAVES` leaves) is
    shared by every lane; one more axis means one value per lane."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _lane_params(v, B, I)
            continue
        base = 2 if k in RANK2_LEAVES else 1
        if v.ndim == base:
            v = v.expand((B,) + v.shape)
        out[k] = v.reshape((B * I,) + tuple(v.shape[2:]))
    return out


def _lane_dyn(dyn: DynSpec, B, I):
    """DynSpec fields (0-d or [B]) -> [B*I], one entry per lane-instance."""
    return DynSpec(*(torch.as_tensor(f).reshape(-1, 1).expand(B, I)
                     .reshape(-1) for f in dyn))


def _lim_seed(model, conn, x_pad):
    """Initial limiter state [B, size] of one group.

    Node-moving models seed with a copy of the gathered state; site-based
    VA models seed each branch variable with its branch voltage (the
    reference's tracking-row semantics, `vasim.jl:3097-3140`)."""
    B = x_pad.shape[0]
    if model.residual_lim is None:
        return x_pad[:, conn].reshape(B, -1)
    cols = []
    for (pl, nl) in model.lim_branches:
        vp = x_pad[:, conn[:, pl]]
        vn = x_pad[:, conn[:, nl]] if nl is not None else 0.0
        cols.append(vp - vn)
    return torch.stack(cols, dim=2).reshape(B, -1)


def _group_eval_sites(model, u, w_prev, p, dyn):
    """VA `$limit` site-based limiting for ONE instance (reference dual
    slots + lim_rhs, `vasim.jl:3012-3146`).

    w_prev [n_branches]: per-branch limiter state (last evaluation
    voltages). The residual_lim interpreter returns straight-through
    passthroughs (value at the limited point, conductance wired to the
    nodes); the companion anchoring F += (dF/dw_site)(vnew - w_site) is the
    derivative along the site hooks d in that direction. The JAX package
    takes it as one extra tangent of its linearization; here the one
    reverse pass that gives the Jacobian in u also gives the d-columns,
    and their product with vnew - w_site is the same directional
    derivative without a second evaluation of the device."""
    zd = torch.zeros(model.n_lim_sites, dtype=u.dtype, device=u.device)

    def fq(uu, dd):
        (f, q), aux = model.residual_lim(uu, dd, w_prev, p, dyn)
        return (f, q), ((f, q), aux)

    ((J, Jd), (C, Cd)), ((f, q), (w_new, vnew, wsite)) = jacrev(
        fq, argnums=(0, 1), has_aux=True)(u, zd)
    delta = vnew - wsite
    return f + Jd @ delta, q + Cd @ delta, J, C, w_new


#: central-difference step of `va_setup` models, relative to 1 + |u|
_FD_H = 1e-4


def _group_eval_fd(model, u, p, dyn):
    """Central-difference local Jacobian for ONE instance of a big VA model
    (PSP/BSIM class, `va_setup` hoisted), as the JAX package computes it:
    the 2 n_local perturbed points ride one batched evaluation, h =
    1e-4 (1 + |u|). Newton converges on the exact residual; the Jacobian
    carries a truncation error of about (h / n vt)^2 / 6 relative."""
    nl = u.shape[0]
    f0, q0 = model.residual(u, p, dyn)
    h = _FD_H * (1.0 + torch.abs(u))
    E = torch.eye(nl, dtype=u.dtype, device=u.device) * h[None, :]
    U = torch.cat([u[None, :] + E, u[None, :] - E], 0)
    fs, qs = vmap(lambda uu: model.residual(uu, p, dyn))(U)
    inv2h = 1.0 / (2.0 * h)
    J = (fs[:nl] - fs[nl:]).T * inv2h[None, :]
    C = (qs[:nl] - qs[nl:]).T * inv2h[None, :]
    return f0, q0, J, C, u


def _group_eval(model, u, u_lim_prev, p, dyn):
    """Residual, charge and their local Jacobians for ONE instance, with
    limiting applied and the companion anchored at the limited point.

    `u_lim_prev` is the point the device was limited to on the PREVIOUS
    Newton iteration (SPICE limiter-state semantics); for a `$limit` VA
    model it is the per-branch limiter state."""
    if model.residual_lim is not None:
        return _group_eval_sites(model, u, u_lim_prev, p, dyn)
    if model.va_setup is not None:
        return _group_eval_fd(model, u, p, dyn)
    u_eval = (model.limit(u, u_lim_prev, p, dyn)
              if model.limit is not None else u)

    def fq(uu):
        f, q = model.residual(uu, p, dyn)
        return (f, q), (f, q)

    (J, C), (f, q) = jacrev(fq, has_aux=True)(u_eval)
    du = u - u_eval
    return f + J @ du, q + C @ du, J, C, u_eval


class GroupEvaluator:
    """The gather -> vmapped evaluation half of an assembly, shared by the
    dense assembler and the block-bordered-diagonal one
    (`mna/bbd_assemble.py`): `evaluate(x_pad, lim, params, dyn, dly)` gives
    per group the flattened [B, ...] residual, charge, local Jacobians and
    limiter state, which each assembler scatters into its own form.

    `dly` [B, n_delay] holds the absdelay history values of the transient
    runner, instance-major per group with delay sites (`dly_slices`); each
    such group reads its slice as p["__dly__"] [n_inst, n_sites]."""

    def __init__(self, cc: CompiledCircuit):
        dev = cc.device
        self.device = dev
        self.consts = []
        self.dly_slices = []
        lim_off = 0
        dly_off = 0
        for g in cc.groups:
            S = g.model.n_delay_sites
            self.dly_slices.append(
                (dly_off, dly_off + g.conn.shape[0] * S, S) if S else None)
            dly_off += g.conn.shape[0] * S
            conn = torch.as_tensor(g.conn, dtype=ITYPE, device=dev)
            sl = None
            if g.model.residual_lim is not None:
                nb = len(g.model.lim_branches)
                sl = (lim_off, lim_off + g.conn.shape[0] * nb, nb)
                lim_off += g.conn.shape[0] * nb
            elif g.model.limit is not None:
                sl = (lim_off, lim_off + g.conn.size, g.conn.shape[1])
                lim_off += g.conn.size
            batched = vmap(lambda u, ul, p, d, _m=g.model:
                           _group_eval(_m, u, ul, p, d))
            self.consts.append((g.model, conn, sl, batched))
        self.n_lim = lim_off
        self.n_delay = dly_off

    def init_lim(self, x_pad):
        parts = [_lim_seed(model, conn, x_pad)
                 for model, conn, sl, _ in self.consts if sl is not None]
        if not parts:
            return torch.zeros((x_pad.shape[0], 0), dtype=DTYPE,
                               device=self.device)
        return torch.cat(parts, dim=1)

    def eval_group(self, gi, x_pad, lim, p, dyn: DynSpec, dly=None):
        """Group gi alone -> (f, q, J, C, lim_part) per lane-instance."""
        _, conn, sl, batched = self.consts[gi]
        B = x_pad.shape[0]
        I, L = conn.shape
        u = x_pad[:, conn].reshape(B * I, L)
        u_lim_prev = (lim[:, sl[0]:sl[1]].reshape(B * I, sl[2])
                      if sl is not None else u)
        lp = _lane_params(p, B, I)
        dsl = self.dly_slices[gi]
        if dsl is not None and dly is not None:
            # the delayed-expression history values, per instance
            lp["__dly__"] = dly[:, dsl[0]:dsl[1]].reshape(B * I, dsl[2])
        return batched(u, u_lim_prev, lp, _lane_dyn(dyn, B, I))

    def evaluate(self, x_pad, lim, params, dyn: DynSpec, dly=None):
        """(fs, qs, Js, Cs, lim_new): per group [B, ...] lists, flattened
        instance-major, and the new limiter state [B, n_lim]."""
        B = x_pad.shape[0]
        fs, qs, Js, Cs, lims = [], [], [], [], []
        for gi, p in enumerate(params):
            f, q, J, C, u_eval = self.eval_group(gi, x_pad, lim, p, dyn,
                                                 dly)
            if self.consts[gi][2] is not None:
                lims.append(u_eval.reshape(B, -1))
            fs.append(f.reshape(B, -1))
            qs.append(q.reshape(B, -1))
            Js.append(J.reshape(B, -1))
            Cs.append(C.reshape(B, -1))
        return fs, qs, Js, Cs, torch.cat(lims, dim=1) if lims else lim


def make_assembler(cc: CompiledCircuit):
    """Build assemble(x_pad, lim, params, dyn, dly=None) -> (F, Q, G, C,
    lim_new).

    x_pad is [B, n+1] (ground slot last, always 0). F/Q are [B, n]; G/C
    dense [B, n, n]. `lim` [B, n_lim] holds each limited device's last
    evaluation point, concatenated over groups; `dly` [B, n_delay] the
    absdelay history values (None: every delay is the identity). The
    function also carries `init_lim(x_pad)`, `n_lim`, `n_delay` and
    `eval_group(gi, x_pad, lim, p, dyn)`,
    which evaluates group gi alone -> (f, q, J, C, lim_part) per
    lane-instance (what the assembly scatters; used to time a group)."""
    n = cc.n
    np1 = n + 1
    dev = cc.device
    ev = GroupEvaluator(cc)
    fq_scatter = make_sorted_scatter([g.conn for g in cc.groups], np1, dev)
    gc_scatter = make_sorted_scatter(
        [(g.conn[:, :, None] * np1 + g.conn[:, None, :]).reshape(-1)
         for g in cc.groups], np1 * np1, dev)
    # gshunt lands on node-voltage diagonals only (reference build.jl)
    vmask = torch.as_tensor(cc.classes == CLASS_V, dtype=DTYPE, device=dev)

    def assemble(x_pad, lim, params, dyn: DynSpec, dly=None):
        B = x_pad.shape[0]
        with obs.span("eval"):
            fs, qs, Js, Cs, lim_new = ev.evaluate(x_pad, lim, params, dyn,
                                                  dly)
        with obs.span("scatter"):
            F = fq_scatter(fs)[:, :n]
            Q = fq_scatter(qs)[:, :n]
            G = gc_scatter(Js).reshape(B, np1, np1)[:, :n, :n]
            C = gc_scatter(Cs).reshape(B, np1, np1)[:, :n, :n]
            # gshunt homotopy shunts on node diagonals (residual AND
            # jacobian)
            gs = torch.as_tensor(dyn.gshunt).reshape(-1, 1) * vmask
            F = F + gs * x_pad[:, :n]
            G = G + torch.diag_embed(gs.expand(B, n))
        return F, Q, G, C, lim_new

    assemble.init_lim = ev.init_lim
    assemble.n_lim = ev.n_lim
    assemble.n_delay = ev.n_delay
    assemble.eval_group = ev.eval_group
    return assemble


class DelayMeta:
    """Delay-history metadata of a circuit with absdelay devices: `size`
    (delay sites over all instances) and `probe(x_pad, params, dyn) ->
    (vals, taus)`, each [B, size]: the instantaneous values and delays of
    every absdelay'd expression, in the flat order of the assembler's
    `dly` (instance-major per group)."""

    def __init__(self, cc: CompiledCircuit):
        self.groups = []
        self.size = 0
        for gi, g in enumerate(cc.groups):
            if not g.model.n_delay_sites:
                continue
            self.groups.append((gi, torch.as_tensor(
                g.conn, dtype=ITYPE, device=cc.device),
                vmap(g.model.delay_probe)))
            self.size += g.conn.shape[0] * g.model.n_delay_sites

    def probe(self, x_pad, params, dyn: DynSpec):
        B = x_pad.shape[0]
        vals, taus = [], []
        for gi, conn, probe in self.groups:
            I, L = conn.shape
            v, t = probe(x_pad[:, conn].reshape(B * I, L),
                         _lane_params(params[gi], B, I),
                         _lane_dyn(dyn, B, I))
            vals.append(v.reshape(B, -1))
            taus.append(t.reshape(B, -1))
        return torch.cat(vals, dim=1), torch.cat(taus, dim=1)


def make_delay_meta(cc: CompiledCircuit):
    """A DelayMeta for a circuit with absdelay sites, else None."""
    if not any(g.model.n_delay_sites for g in cc.groups):
        return None
    return DelayMeta(cc)


def make_ac_rhs(cc: CompiledCircuit):
    """Build b_ac(params) -> (br, bi), each [n]: the small-signal excitation
    vector of the sources with nonzero acmag, +sign * acmag at angle
    acphase (degrees) on each row of their model's `ac_rhs`. Unbatched
    parameters ([n_inst] leaves)."""
    n = cc.n
    terms = [(gi, local, sign) for gi, g in enumerate(cc.groups)
             for local, sign in g.model.ac_rhs]
    scatter = make_sorted_scatter([cc.groups[gi].conn[:, local]
                                   for gi, local, _ in terms], n + 1,
                                  cc.device) if terms else None

    def b_ac(params):
        if not terms:
            z = torch.zeros(n, dtype=DTYPE, device=cc.device)
            return z, z.clone()
        re, im = [], []
        for gi, _, sign in terms:
            mag = params[gi]["acmag"]
            ph = params[gi]["acphase"] * (torch.pi / 180.0)
            re.append((sign * mag * torch.cos(ph))[None])
            im.append((sign * mag * torch.sin(ph))[None])
        return scatter(re)[0, :n], scatter(im)[0, :n]

    return b_ac


def make_rhs_assembler(cc: CompiledCircuit):
    """Residual-only assembly: rhs(x_pad, params, dyn) -> (F, Q), no
    Jacobians and no limiting. Used for the consistent initial qdot."""
    n = cc.n
    np1 = n + 1
    dev = cc.device
    consts = []
    for g in cc.groups:
        consts.append((torch.as_tensor(g.conn, dtype=ITYPE, device=dev),
                       vmap(g.model.residual)))
    scatter = make_sorted_scatter([g.conn for g in cc.groups], np1, dev)
    vmask = torch.as_tensor(cc.classes == CLASS_V, dtype=DTYPE, device=dev)

    def rhs(x_pad, params, dyn: DynSpec):
        B = x_pad.shape[0]
        fs, qs = [], []
        with obs.span("eval"):
            for (conn, res), p in zip(consts, params):
                I, L = conn.shape
                f, q = res(x_pad[:, conn].reshape(B * I, L),
                           _lane_params(p, B, I), _lane_dyn(dyn, B, I))
                fs.append(f.reshape(B, -1))
                qs.append(q.reshape(B, -1))
        with obs.span("scatter"):
            gs = torch.as_tensor(dyn.gshunt).reshape(-1, 1) * vmask
            F = scatter(fs)[:, :n] + gs * x_pad[:, :n]
            return F, scatter(qs)[:, :n]

    return rhs
