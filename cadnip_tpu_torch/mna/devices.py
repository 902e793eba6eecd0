"""Built-in device models as pure residual functions (PyTorch port of
`cadnip_tpu/mna/devices.py`).

A device is a pure function

    residual(u_local, params, dyn) -> (f_local, q_local)

of one instance's local unknowns (terminal voltages, then internal unknowns
such as branch currents): `f` is the resistive current out of each row,
`q` the charge whose time derivative adds to it. G = df/du and C = dq/du
come from `torch.func` autodiff, vmapped over instances by the assembler.
Newton limiting is the optional hook

    limit(u, u_prev, params, dyn) -> u_eval

and the assembler anchors the companion model at `u_eval`.

Noise is a third optional channel, `noise(u, p, dyn) -> psd`: each
instance's white noise-current PSDs between the local node pairs of
`noise_pairs`, with an optional 1/f channel `flicker(u, p, dyn) -> (num,
exp)` (S = num / f**exp); `analyses/noise.py` reads both. `opvars(u, p,
dyn) -> {name: value}` publishes operating-point variables (`op_info`).
Sources with `ac_rhs` drive the AC excitation vector (`make_ac_rhs`).

Verilog-A models (`va/codegen.py`) are DeviceModels too, with the
extra hooks below: site-based `$limit` (`residual_lim`), node collapse,
per-signature specialization and the hoisted host setup pass.

Every function here is branch-free: `torch.where` instead of `if` on a
tensor, no `.item()`, and `torch.stack` only over tensors, so that
`torch.func.jacfwd`, `jacrev` and `vmap` can trace it.

Every built-in model of the JAX package: resistor, capacitor, inductor,
mutual inductance, V and I sources, the four controlled sources (E, G, F,
H), the diode (with and without series rs), the BJT and the level-1
MOSFET.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .spec import KB, MODE_DCOP, QE, DynSpec
from .waveforms import eval_wave

# unknown classes: select the per-class absolute tolerance
CLASS_V = 0   # node voltage      -> vntol
CLASS_I = 1   # branch current    -> abstol
CLASS_Q = 2   # charge-like state -> chgtol


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceModel:
    """Static description of a device class. Hash/eq by identity: each
    model object defines one vmapped evaluation group."""

    name: str
    terminals: tuple                      # external terminal names
    residual: Callable                    # (u, p, dyn) -> (f, q)
    internals: tuple = ()                 # (name, CLASS_*) extra unknowns
    defaults: dict = dataclasses.field(default_factory=dict)
    limit: Optional[Callable] = None      # (u, u_prev, p, dyn) -> u_eval
    noise: Optional[Callable] = None      # (u, p, dyn) -> white PSDs [n_pairs]
    noise_pairs: tuple = ()               # ((p_idx, n_idx), ...) per psd entry
    # optional 1/f channel: (u, p, dyn) -> (num [n_pairs], exp [n_pairs]);
    # S_flicker(f) = num / f**exp
    flicker: Optional[Callable] = None
    ac_source: bool = False               # contributes to the AC rhs
    # ((local_idx, sign), ...): rows receiving +sign*acmag∠acphase in b_ac
    ac_rhs: tuple = ()
    # residual is affine in u (f = A u - b(t), q = C u)
    linear: bool = False
    # optional operating-point info: (u, p, dyn) -> dict of named scalars
    opvars: Optional[Callable] = None
    # parameter names baked into structure (VA loop bounds, laplace
    # coefficients): per-instance overrides cannot take effect -> warn
    structural_params: tuple = ()
    # VA `$limit` site-based limiting (reference vasim.jl:3012-3146 dual
    # slots + lim_rhs): residual_lim(u, d, w, p, dyn) -> ((f, q), aux) where
    # w [n_lim_branches] is per-branch limiter state (previous evaluation
    # voltages), d [n_lim_sites] is the companion-linearization hook, and
    # aux = (w_new, vnew, wsite). `limit` above stays the node-moving hook
    # of the built-in devices.
    residual_lim: Optional[Callable] = None
    lim_branches: tuple = ()              # ((p_local, n_local|None), ...)
    n_lim_sites: int = 0
    # VA `absdelay` transport-delay sites (reference DDE path,
    # `src/mna/delay.jl:20-28`): delay_probe(u, p, dyn) -> (vals, taus),
    # each [n_delay_sites]: the current value of every delayed expression
    # and its delay. The transient runner records vals into a history ring
    # and feeds the residual the interpolated past values as p["__dly__"].
    n_delay_sites: int = 0
    delay_probe: Optional[Callable] = None
    # VA node collapse (reference detect_short_circuits, vasim.jl:2723):
    # ((internal_name, target), ...) where target is a terminal name,
    # another internal name (chains resolve transitively), or None for
    # ground. The elaborator wires the collapsed internal's conn column to
    # the target's global unknown instead of allocating a fresh one.
    collapses: tuple = ()
    # (overrides: dict) -> DeviceModel specialized for that parameter
    # signature (set on base VA models with collapse candidates or a host
    # setup pass; the frontend calls it per instance)
    va_specialize: Optional[Callable] = None
    # Host-setup hoisting for big VA models (PSP/BSIM class): the
    # (params, temperature)-only setup pass evaluated eagerly on the CPU
    # once per solve. va_setup(p_arrays, dyn) -> [..., n_inst, K] value
    # matrix the residual reads back through p['__setup__'];
    # `mna/assemble.py::ensure_setup` injects it at every solver entry.
    va_setup: Optional[Callable] = None
    # the VACompiler of a Verilog-A model: its unknown layout, parameter
    # order and statements, from which `va/cuda.py` emits K2's device
    # function
    va_compiler: Optional[object] = None

    @property
    def n_terminals(self):
        return len(self.terminals)

    @property
    def n_local(self):
        return len(self.terminals) + len(self.internals)


# ---------------------------------------------------------------------------
# helpers

def _src_value(p, dyn: DynSpec):
    """Independent-source value respecting analysis mode and srcfact: DCOP
    uses the DC value; TRANOP/TRAN evaluate the waveform at dyn.time."""
    w = p["wave"]
    vt = eval_wave(w["kind"], w["coeffs"], w["ncoef"], dyn.time)
    v = torch.where(dyn.mode == MODE_DCOP, w["dc"], vt)
    return v * dyn.srcfact


def _z(u):
    return torch.zeros_like(u)


# ---------------------------------------------------------------------------
# linear two-terminal devices

def _resistor_residual(u, p, dyn):
    g = 1.0 / p["r"]
    i = g * (u[0] - u[1])
    return torch.stack([i, -i]), _z(u)


def _resistor_noise(u, p, dyn):
    # thermal: S_i = 4kT/R (one source between the two terminals)
    return torch.stack([4.0 * KB * dyn.temp / p["r"]])


RESISTOR = DeviceModel(
    name="resistor", terminals=("p", "n"), residual=_resistor_residual,
    defaults={"r": 1e3}, noise=_resistor_noise, noise_pairs=((0, 1),),
    linear=True)


def _capacitor_residual(u, p, dyn):
    q = p["c"] * (u[0] - u[1])
    return _z(u), torch.stack([q, -q])


CAPACITOR = DeviceModel(
    name="capacitor", terminals=("p", "n"), residual=_capacitor_residual,
    defaults={"c": 1e-12}, linear=True)


def _inductor_residual(u, p, dyn):
    # unknowns: [vp, vn, i]; branch row: vp - vn - L di/dt = 0
    vp, vn, i = u[0], u[1], u[2]
    f = torch.stack([i, -i, vp - vn])
    q = torch.stack([0.0 * i, 0.0 * i, -p["l"] * i])
    return f, q


INDUCTOR = DeviceModel(
    name="inductor", terminals=("p", "n"), residual=_inductor_residual,
    internals=(("i", CLASS_I),), defaults={"l": 1e-9}, linear=True)


def _mutual_residual(u, p, dyn):
    # u = [i1, i2]: adds -M*i_other to each inductor's branch (flux) row
    m = p["m"]
    return _z(u), torch.stack([-m * u[1], -m * u[0]])


MUTUAL = DeviceModel(
    name="mutual", terminals=("isense1", "isense2"),
    residual=_mutual_residual, defaults={"m": 0.0}, linear=True)


# ---------------------------------------------------------------------------
# independent sources

def _vsource_residual(u, p, dyn):
    vp, vn, i = u[0], u[1], u[2]
    v = _src_value(p, dyn)
    return torch.stack([i, -i, vp - vn - v]), _z(u)


VSOURCE = DeviceModel(
    name="vsource", terminals=("p", "n"), residual=_vsource_residual,
    internals=(("i", CLASS_I),),
    defaults={"acmag": 0.0, "acphase": 0.0}, ac_source=True,
    ac_rhs=((2, 1.0),), linear=True)


def _isource_residual(u, p, dyn):
    i = _src_value(p, dyn)
    return torch.stack([i, -i]), _z(u)


ISOURCE = DeviceModel(
    name="isource", terminals=("p", "n"), residual=_isource_residual,
    defaults={"acmag": 0.0, "acphase": 0.0}, ac_source=True,
    ac_rhs=((0, -1.0), (1, 1.0)), linear=True)


# ---------------------------------------------------------------------------
# controlled sources (E/G/F/H). The current-controlled ones sense the branch
# current of a V source or inductor: that unknown is wired in as an extra
# local connection at elaboration time.

def _vcvs_residual(u, p, dyn):
    vp, vn, vcp, vcn, i = u[0], u[1], u[2], u[3], u[4]
    f = torch.stack([i, -i, 0 * i, 0 * i, vp - vn - p["gain"] * (vcp - vcn)])
    return f, _z(u)


VCVS = DeviceModel(
    name="vcvs", terminals=("p", "n", "cp", "cn"), residual=_vcvs_residual,
    internals=(("i", CLASS_I),), defaults={"gain": 1.0}, linear=True)


def _vccs_residual(u, p, dyn):
    vp, vn, vcp, vcn = u[0], u[1], u[2], u[3]
    i = p["gm"] * (vcp - vcn)
    return torch.stack([i, -i, 0 * i, 0 * i]), _z(u)


VCCS = DeviceModel(
    name="vccs", terminals=("p", "n", "cp", "cn"), residual=_vccs_residual,
    defaults={"gm": 1.0}, linear=True)


def _cccs_residual(u, p, dyn):
    # u = [vp, vn, i_sense]; i_sense is the sensed branch current, a
    # read-only coupling: this device adds nothing to the sensed row
    i = p["gain"] * u[2]
    return torch.stack([i, -i, 0 * u[2]]), _z(u)


CCCS = DeviceModel(
    name="cccs", terminals=("p", "n", "isense"), residual=_cccs_residual,
    defaults={"gain": 1.0}, linear=True)


def _ccvs_residual(u, p, dyn):
    vp, vn, isense, i = u[0], u[1], u[2], u[3]
    f = torch.stack([i, -i, 0 * i, vp - vn - p["r"] * isense])
    return f, _z(u)


CCVS = DeviceModel(
    name="ccvs", terminals=("p", "n", "isense"), residual=_ccvs_residual,
    internals=(("i", CLASS_I),), defaults={"r": 1.0}, linear=True)


# ---------------------------------------------------------------------------
# diode (SPICE level-1 junction): forward exponential + breakdown +
# junction and diffusion charge; pnjlim limiting

def _powx(x, p):
    """x**p for strictly-positive x via exp(p*log(x)), as the JAX
    package computes it (every call site guards the base positive)."""
    return torch.exp(p * torch.log(torch.clamp(x, min=1e-30)))


def _diode_ivq(vd, p, dyn):
    vt = p["n"] * dyn.vt
    is_ = p["is"] * p["area"]
    x = torch.clip(vd / vt, -80.0, 80.0)
    idf = is_ * (torch.exp(x) - 1.0)
    # breakdown: exponential onset below -bv (bv<=0 disables)
    bv = p["bv"]
    xb = torch.clip(-(vd + bv) / dyn.vt, -80.0, 80.0)
    ibr = torch.where(bv > 0.0, -p["ibv"] * torch.exp(xb), 0.0 * xb)
    i = idf + ibr + dyn.gmin * vd
    # junction charge (standard fc linearization) + diffusion charge
    cj0, vj, m, fc = p["cjo"] * p["area"], p["vj"], p["m"], p["fc"]
    fcv = fc * vj
    qj_below = cj0 * vj / (1.0 - m) * (1.0 - _powx(
        torch.clamp(1.0 - torch.minimum(vd, fcv) / vj, min=1e-6), 1.0 - m))
    f1 = cj0 * vj / (1.0 - m) * (1.0 - _powx(1.0 - fc, 1.0 - m))
    f2 = _powx(1.0 - fc, -1.0 - m)
    qj_above = f1 + cj0 * f2 * ((1.0 - fc * (1.0 + m)) * (vd - fcv)
                                + 0.5 * m / vj * (vd * vd - fcv * fcv))
    qj = torch.where(vd < fcv, qj_below, qj_above)
    q = qj + p["tt"] * idf
    return i, q


def _diode_residual(u, p, dyn):
    i, q = _diode_ivq(u[0] - u[1], p, dyn)
    return torch.stack([i, -i]), torch.stack([q, -q])


def pnjlim(vnew, vold, vt, vcrit):
    """SPICE3 junction-voltage limiter (reference `devices.jl:1169-1189`)."""
    big = (vnew > vcrit) & (torch.abs(vnew - vold) > 2.0 * vt)
    arg = 1.0 + (vnew - vold) / vt
    v_pos = torch.where(
        arg > 0.0, vold + vt * torch.log(torch.clamp(arg, min=1e-300)),
        vcrit + 0.0 * arg)
    v_neg = vt * torch.log(torch.clamp(vnew / vt, min=1e-300))
    vlim = torch.where(vold > 0.0, v_pos, v_neg)
    return torch.where(big, vlim, vnew)


def fetlim(vnew, vold, vto):
    """SPICE3 FET gate-voltage limiter (DEVfetlim), branch-free."""
    vtsthi = torch.abs(2.0 * (vold - vto)) + 2.0
    vtstlo = torch.abs(vold - vto) + 1.0
    vtox = vto + 3.5
    delv = vnew - vold
    # vold >= vtox ("on")
    on_dec = torch.where(vnew >= vtox,
                         torch.where(-delv > vtstlo, vold - vtstlo, vnew),
                         torch.maximum(vnew, vto + 2.0))
    on_inc = torch.where(delv >= vtsthi, vold + vtsthi, vnew)
    on = torch.where(delv <= 0.0, on_dec, on_inc)
    # vto <= vold < vtox ("middle")
    mid = torch.where(delv <= 0.0, torch.maximum(vnew, vto - 0.5),
                      torch.minimum(vnew, vto + 4.0))
    # vold < vto ("off")
    off_dec = torch.where(-delv > vtsthi, vold - vtsthi, vnew)
    off_inc = torch.where(vnew <= vto + 0.5,
                          torch.where(delv > vtstlo, vold + vtstlo, vnew),
                          vto + 0.5 + 0.0 * vnew)
    off = torch.where(delv <= 0.0, off_dec, off_inc)
    return torch.where(vold >= vto,
                       torch.where(vold >= vtox, on, mid), off)


def limvds(vnew, vold):
    """SPICE3 drain-source voltage limiter (DEVlimvds), branch-free."""
    hi = torch.where(vnew > vold, torch.minimum(vnew, 3.0 * vold + 2.0),
                     torch.where(vnew < 3.5, torch.clamp(vnew, min=2.0),
                                 vnew))
    lo = torch.where(vnew > vold, torch.clamp(vnew, max=4.0),
                     torch.clamp(vnew, min=-0.5))
    return torch.where(vold >= 3.5, hi, lo)


def _vcrit(p, dyn):
    vt = p["n"] * dyn.vt
    return vt * torch.log(vt / (math.sqrt(2.0) * torch.clamp(
        p["is"] * p["area"], min=1e-300)))


def _diode_limit(u, u_prev, p, dyn):
    vd = pnjlim(u[0] - u[1], u_prev[0] - u_prev[1], p["n"] * dyn.vt,
                _vcrit(p, dyn))
    # move the limited junction delta onto the anode side
    return torch.stack([u[1] + vd, u[1]])


_DIODE_DEFAULTS = {"is": 1e-14, "n": 1.0, "rs": 0.0, "cjo": 0.0, "vj": 1.0,
                   "m": 0.5, "fc": 0.5, "tt": 0.0, "bv": 0.0, "ibv": 1e-3,
                   "area": 1.0, "kf": 0.0, "af": 1.0}

def _diode_noise(u, p, dyn):
    # shot noise 2qId (flicker kf*Id^af/f is the flicker channel's)
    i, _ = _diode_ivq(u[0] - u[1], p, dyn)
    return torch.stack([2.0 * QE * torch.abs(i)])


def _diode_flicker(u, p, dyn):
    i, _ = _diode_ivq(u[0] - u[1], p, dyn)
    return (torch.stack([p["kf"] * torch.pow(torch.abs(i), p["af"])]),
            torch.stack([torch.ones_like(i)]))


DIODE = DeviceModel(
    name="diode", terminals=("p", "n"), residual=_diode_residual,
    defaults=dict(_DIODE_DEFAULTS), limit=_diode_limit,
    noise=_diode_noise, noise_pairs=((0, 1),), flicker=_diode_flicker)


def _diode_rs_residual(u, p, dyn):
    # u = [vp, vn, vint]; rs between p and the internal anode
    vp, vn, vi = u[0], u[1], u[2]
    g = 1.0 / torch.clamp(p["rs"], min=1e-12)
    ir = g * (vp - vi)
    i, q = _diode_ivq(vi - vn, p, dyn)
    f = torch.stack([ir, -i, i - ir])
    qv = torch.stack([0.0 * q, -q, q])
    return f, qv


def _diode_rs_limit(u, u_prev, p, dyn):
    # pnjlim on the internal junction (vint - vn)
    vd = pnjlim(u[2] - u[1], u_prev[2] - u_prev[1], p["n"] * dyn.vt,
                _vcrit(p, dyn))
    return torch.stack([u[0], u[1], u[1] + vd])


def _diode_rs_noise(u, p, dyn):
    i, _ = _diode_ivq(u[2] - u[1], p, dyn)
    return torch.stack([2.0 * QE * torch.abs(i),
                        4.0 * KB * dyn.temp / torch.clamp(p["rs"], min=1e-12)])


DIODE_RS = DeviceModel(
    name="diode_rs", terminals=("p", "n"), residual=_diode_rs_residual,
    internals=(("int", CLASS_V),), defaults=dict(_DIODE_DEFAULTS),
    limit=_diode_rs_limit, noise=_diode_rs_noise,
    noise_pairs=((2, 1), (0, 2)))


# ---------------------------------------------------------------------------
# BJT: Ebers-Moll transport formulation with Early effect and junction +
# diffusion charge (a Gummel-Poon subset: bf/br/is/vaf/var currents,
# cje/cjc depletion caps, tf/tr diffusion charge). Terminals c, b, e.

def _junction_q(v, cj0, vj, m, fc):
    fcv = fc * vj
    q_below = cj0 * vj / (1.0 - m) * (1.0 - _powx(
        torch.clamp(1.0 - torch.minimum(v, fcv) / vj, min=1e-6), 1.0 - m))
    f1 = cj0 * vj / (1.0 - m) * (1.0 - _powx(1.0 - fc, 1.0 - m))
    f2 = _powx(1.0 - fc, -1.0 - m)
    q_above = f1 + cj0 * f2 * ((1.0 - fc * (1.0 + m)) * (v - fcv)
                               + 0.5 * m / vj * (v * v - fcv * fcv))
    return torch.where(v < fcv, q_below, q_above)


def _bjt_currents(vbe, vbc, p, dyn):
    vt = dyn.vt
    is_ = p["is"] * p["area"]
    ex_be = torch.exp(torch.clip(vbe / (p["nf"] * vt), -80.0, 80.0))
    ex_bc = torch.exp(torch.clip(vbc / (p["nr"] * vt), -80.0, 80.0))
    icc = is_ * (ex_be - 1.0)
    iec = is_ * (ex_bc - 1.0)
    # Early + Webster (high-injection) base charge factor
    qb_inv = (1.0 - vbc / p["vaf"] - vbe / p["var"])
    qb = 1.0 / torch.clamp(qb_inv, min=0.1)
    it = (icc - iec) / qb
    ib = icc / p["bf"] + iec / p["br"]
    ic = it - iec / p["br"]
    ie = -(it + icc / p["bf"])
    return ic, ib, ie, icc, iec


def _bjt_residual(u, p, dyn):
    ty = p["type"]   # +1 npn, -1 pnp
    vc, vb, ve = ty * u[0], ty * u[1], ty * u[2]
    vbe = vb - ve
    vbc = vb - vc
    ic, ib, ie, icc, iec = _bjt_currents(vbe, vbc, p, dyn)
    gm = dyn.gmin
    f = torch.stack([ty * (ic + gm * (vc - vb)),
                     ty * (ib - gm * (vc - vb) - gm * (ve - vb)),
                     ty * (ie + gm * (ve - vb))])
    qbe = (_junction_q(vbe, p["cje"] * p["area"], p["vje"], p["mje"],
                       p["fc"]) + p["tf"] * icc)
    qbc = (_junction_q(vbc, p["cjc"] * p["area"], p["vjc"], p["mjc"],
                       p["fc"]) + p["tr"] * iec)
    q = torch.stack([-ty * qbc, ty * (qbe + qbc), -ty * qbe])
    return f, q


def _bjt_limit(u, u_prev, p, dyn):
    ty = p["type"]
    vt = dyn.vt
    is_ = p["is"] * p["area"]
    vcrit = vt * torch.log(vt / (math.sqrt(2.0) * torch.clamp(is_,
                                                              min=1e-300)))
    vbe = pnjlim(ty * (u[1] - u[2]), ty * (u_prev[1] - u_prev[2]), vt, vcrit)
    vbc = pnjlim(ty * (u[1] - u[0]), ty * (u_prev[1] - u_prev[0]), vt, vcrit)
    # keep the base voltage, move emitter and collector to honour the
    # limited junctions
    return torch.stack([u[1] - ty * vbc, u[1], u[1] - ty * vbe])


def _bjt_noise(u, p, dyn):
    ty = p["type"]
    vc, vb, ve = ty * u[0], ty * u[1], ty * u[2]
    ic, ib, _, _, _ = _bjt_currents(vb - ve, vb - vc, p, dyn)
    return torch.stack([2.0 * QE * torch.abs(ic), 2.0 * QE * torch.abs(ib)])


BJT = DeviceModel(
    name="bjt", terminals=("c", "b", "e"), residual=_bjt_residual,
    defaults={"type": 1.0, "is": 1e-16, "bf": 100.0, "br": 1.0,
              "nf": 1.0, "nr": 1.0, "vaf": 1e12, "var": 1e12,
              "cje": 0.0, "vje": 0.75, "mje": 0.33,
              "cjc": 0.0, "vjc": 0.75, "mjc": 0.33,
              "tf": 0.0, "tr": 0.0, "fc": 0.5, "area": 1.0},
    limit=_bjt_limit, noise=_bjt_noise, noise_pairs=((0, 2), (1, 2)))


# ---------------------------------------------------------------------------
# MOSFET level 1 (square law with channel-length modulation), 4-terminal
# with fixed overlap and junction capacitances

def _mos1_ids(vgs, vds, p, vth):
    beta = p["kp"] * p["w"] / p["l"]
    vov = vgs - vth
    clm = 1.0 + p["lambda"] * vds
    i_sat = 0.5 * beta * vov * vov * clm
    i_tri = beta * (vov - 0.5 * vds) * vds * clm
    i_on = torch.where(vds > vov, i_sat, i_tri)
    return torch.where(vov <= 0.0, 0.0 * i_on, i_on)


def _limexp_dev(x):
    """Overflow-safe exp with linear continuation above x=80."""
    xc = torch.clamp(x, max=80.0)
    return torch.exp(xc) * (1.0 + torch.clamp(x - 80.0, min=0.0))


def _mos1_residual(u, p, dyn):
    # u = [vd, vg, vs, vb]; `type` is +1 NMOS / -1 PMOS
    ty = p["type"]
    vd, vg, vs, vb = ty * u[0], ty * u[1], ty * u[2], ty * u[3]
    # source/drain swap for reverse operation (square law is symmetric)
    fwd = vd >= vs
    vgs = torch.where(fwd, vg - vs, vg - vd)
    vds = torch.abs(vd - vs)
    # vto is negative for PMOS; in the sign-flipped frame the effective
    # threshold is ty*vto
    sgn = 2.0 * fwd.to(u.dtype) - 1.0
    ids = _mos1_ids(vgs, vds, p, ty * p["vth"]) * sgn * ty
    ids = ids + dyn.gmin * (u[0] - u[2])
    # bulk junction diodes (ngspice MOS1load drain-bulk / source-bulk)
    vt = dyn.vt
    isat = p["is"]
    ibd = isat * (_limexp_dev((vb - vd) / vt) - 1.0) + dyn.gmin * (vb - vd)
    ibs = isat * (_limexp_dev((vb - vs) / vt) - 1.0) + dyn.gmin * (vb - vs)
    f = torch.stack([ids - ty * ibd, 0.0 * ids, -ids - ty * ibs,
                     ty * (ibd + ibs)])
    # fixed gate caps (cgs, cgd, cgb) plus junction caps to bulk (cbd, cbs)
    qgs = p["cgs"] * (u[1] - u[2])
    qgd = p["cgd"] * (u[1] - u[0])
    qgb = p["cgb"] * (u[1] - u[3])
    qbd = p["cbd"] * (u[3] - u[0])
    qbs = p["cbs"] * (u[3] - u[2])
    q = torch.stack([-qgd - qbd, qgs + qgd + qgb, -qgs - qbs,
                     -qgb + qbd + qbs])
    return f, q


def _mos1_limit(u, u_prev, p, dyn):
    """SPICE MOS Newton limiting: fetlim on the (oriented) gate overdrive,
    limvds on the drain-source step, then pnjlim on the bulk junctions
    (ngspice MOS1load order)."""
    ty = p["type"]
    vd, vg, vs, vb = ty * u[0], ty * u[1], ty * u[2], ty * u[3]
    vdp, vgp, vsp = ty * u_prev[0], ty * u_prev[1], ty * u_prev[2]
    vto = ty * p["vth"]
    fwd = vd >= vs
    src = torch.where(fwd, vs, vd)
    src_p = torch.where(fwd, vsp, vdp)
    vgs_l = fetlim(vg - src, vgp - src_p, vto)
    vds_l = limvds(torch.abs(vd - vs), torch.abs(vdp - vsp))
    vg2 = src + vgs_l
    vdrain2 = src + vds_l          # oriented drain terminal
    vd2 = torch.where(fwd, vdrain2, vd)
    vs2 = torch.where(fwd, vs, vdrain2)
    vbp = ty * u_prev[3]
    vt = dyn.vt
    vcrit = vt * torch.log(vt / (1.41421356 * p["is"]))
    vbd_l = pnjlim(vb - vd2, vbp - ty * u_prev[0], vt, vcrit)
    vbs_l = pnjlim(vb - vs2, vbp - ty * u_prev[2], vt, vcrit)
    vd3 = vb - vbd_l
    vs3 = vb - vbs_l
    return torch.stack([ty * vd3, ty * vg2, ty * vs3, ty * vb])


def _mos1_noise(u, p, dyn):
    # channel thermal noise 8/3 kT gm
    ty = p["type"]
    vd, vg, vs = ty * u[0], ty * u[1], ty * u[2]
    fwd = vd >= vs
    vgs = torch.where(fwd, vg - vs, vg - vd)
    vov = torch.clamp(vgs - ty * p["vth"], min=0.0)
    gm = p["kp"] * p["w"] / p["l"] * vov
    return torch.stack([8.0 / 3.0 * KB * dyn.temp * gm])


def _mos1_opvars(u, p, dyn):
    ty = p["type"]
    vd, vg, vs = ty * u[0], ty * u[1], ty * u[2]
    fwd = vd >= vs
    vgs = torch.where(fwd, vg - vs, vg - vd)
    vds = torch.abs(vd - vs)
    vth = ty * p["vth"]
    vov = torch.clamp(vgs - vth, min=0.0)
    beta = p["kp"] * p["w"] / p["l"]
    ids = _mos1_ids(vgs, vds, p, vth)
    gm = torch.where(vds > vov, beta * vov, beta * vds)
    gds = torch.where(vds > vov,
                      0.5 * beta * vov * vov * p["lambda"],
                      beta * (vov - vds))
    return {"ids": ids, "vgs": vgs, "vds": vds, "vth": vth, "gm": gm,
            "gds": gds, "vdsat": vov}


MOSFET1 = DeviceModel(
    name="mos1", terminals=("d", "g", "s", "b"), residual=_mos1_residual,
    defaults={"type": 1.0, "vth": 0.7, "kp": 110e-6, "lambda": 0.0,
              "w": 1e-6, "l": 1e-6, "cgs": 0.0, "cgd": 0.0, "cgb": 0.0,
              "cbd": 0.0, "cbs": 0.0, "is": 1e-14},
    limit=_mos1_limit,
    noise=_mos1_noise, noise_pairs=((0, 2),), opvars=_mos1_opvars)


BUILTINS = {m.name: m for m in
            (RESISTOR, CAPACITOR, INDUCTOR, VSOURCE, ISOURCE, VCVS, VCCS,
             CCCS, CCVS, DIODE, DIODE_RS, BJT, MOSFET1, MUTUAL)}
