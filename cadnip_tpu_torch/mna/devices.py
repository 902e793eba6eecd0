"""Built-in device models as pure residual functions (PyTorch port of
`cadnip_tpu/mna/devices.py`, the subset the DFF transient needs).

A device is a pure function

    residual(u_local, params, dyn) -> (f_local, q_local)

of one instance's local unknowns (terminal voltages, then internal unknowns
such as branch currents): `f` is the resistive current out of each row,
`q` the charge whose time derivative adds to it. G = df/du and C = dq/du
come from `torch.func` autodiff, vmapped over instances by the assembler.
Newton limiting is the optional hook

    limit(u, u_prev, params, dyn) -> u_eval

and the assembler anchors the companion model at `u_eval`.

Every function here is branch-free: `torch.where` instead of `if` on a
tensor, no `.item()`, and `torch.stack` only over tensors, so that
`torch.func.jacfwd`, `jacrev` and `vmap` can trace it.

Ported: resistor, capacitor, V and I sources, the diode (with and without
series rs) and the level-1 MOSFET. The inductor, mutual inductance,
controlled sources, BJT and the noise/flicker/op-info channels raise
`NotImplementedError` (ROADMAP, modules still to port, item 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .spec import MODE_DCOP, DynSpec
from .waveforms import eval_wave

# unknown classes: select the per-class absolute tolerance
CLASS_V = 0   # node voltage      -> vntol
CLASS_I = 1   # branch current    -> abstol
CLASS_Q = 2   # charge-like state -> chgtol

_DEFERRED = ("is not ported to cadnip_tpu_torch yet (ROADMAP, modules still "
             "to port, item 1)")


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
    # Verilog-A hooks of the JAX package. The port has no VA compiler yet,
    # so they stay unset; the assembler refuses a model that sets them.
    residual_lim: Optional[Callable] = None
    va_setup: Optional[Callable] = None
    n_delay_sites: int = 0

    @property
    def n_terminals(self):
        return len(self.terminals)

    @property
    def n_local(self):
        return len(self.terminals) + len(self.internals)


def deferred(what: str):
    """Raise for a device or channel the port does not have yet."""
    raise NotImplementedError(f"{what} {_DEFERRED}")


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


RESISTOR = DeviceModel(
    name="resistor", terminals=("p", "n"), residual=_resistor_residual,
    defaults={"r": 1e3})


def _capacitor_residual(u, p, dyn):
    q = p["c"] * (u[0] - u[1])
    return _z(u), torch.stack([q, -q])


CAPACITOR = DeviceModel(
    name="capacitor", terminals=("p", "n"), residual=_capacitor_residual,
    defaults={"c": 1e-12})


# ---------------------------------------------------------------------------
# independent sources

def _vsource_residual(u, p, dyn):
    vp, vn, i = u[0], u[1], u[2]
    v = _src_value(p, dyn)
    return torch.stack([i, -i, vp - vn - v]), _z(u)


VSOURCE = DeviceModel(
    name="vsource", terminals=("p", "n"), residual=_vsource_residual,
    internals=(("i", CLASS_I),),
    defaults={"acmag": 0.0, "acphase": 0.0})


def _isource_residual(u, p, dyn):
    i = _src_value(p, dyn)
    return torch.stack([i, -i]), _z(u)


ISOURCE = DeviceModel(
    name="isource", terminals=("p", "n"), residual=_isource_residual,
    defaults={"acmag": 0.0, "acphase": 0.0})


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

DIODE = DeviceModel(
    name="diode", terminals=("p", "n"), residual=_diode_residual,
    defaults=dict(_DIODE_DEFAULTS), limit=_diode_limit)


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


DIODE_RS = DeviceModel(
    name="diode_rs", terminals=("p", "n"), residual=_diode_rs_residual,
    internals=(("int", CLASS_V),), defaults=dict(_DIODE_DEFAULTS),
    limit=_diode_rs_limit)


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


MOSFET1 = DeviceModel(
    name="mos1", terminals=("d", "g", "s", "b"), residual=_mos1_residual,
    defaults={"type": 1.0, "vth": 0.7, "kp": 110e-6, "lambda": 0.0,
              "w": 1e-6, "l": 1e-6, "cgs": 0.0, "cgd": 0.0, "cgb": 0.0,
              "cbd": 0.0, "cbs": 0.0, "is": 1e-14},
    limit=_mos1_limit)


BUILTINS = {m.name: m for m in (RESISTOR, CAPACITOR, VSOURCE, ISOURCE,
                                DIODE, DIODE_RS, MOSFET1)}
