"""The level-1 MOSFET's equations, behind the `.model` types `nmos` and
`pmos` (`nmos.py`, `pmos.py`), which set its polarity `type`; terminals
d g s b.

The textbook SPICE level-1 MOSFET: the Shichman-Hodges square law with
channel-length modulation, drain and source swapped when vds < 0, bulk
junction diodes, fixed overlap and junction capacitances (as this
simulator's level-1 card reads them, cgso / cgdo / cbd / cbs are
capacitances of the device, not per width or area). gmin is added across
each junction and across the channel. A card may say `level=1` and no
other level.
"""
from __future__ import annotations

import numpy as np

from .. import devices as dv

LETTER = "m"
CARD = True
TERMINALS = ("d", "g", "s", "b")
PARAMS = {"vto": 0.0, "kp": 2e-5, "lambda": 0.0, "cgso": 0.0, "cgdo": 0.0,
          "cgbo": 0.0, "cbd": 0.0, "cbs": 0.0, "is": 1e-14, "w": 1e-4,
          "l": 1e-4}
INSTANCE = ("w", "l")
SELECT = {"level": 1.0}


def evaluate(u, p, vt, gmin):
    ty = p["type"]
    v = ty[..., None] * u
    vd, vg, vs, vb = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    fwd = vd >= vs
    vgs = np.where(fwd, vg - vs, vg - vd)
    vds = np.abs(vd - vs)
    vov = vgs - ty * p["vto"]
    beta = p["kp"] * p["w"] / p["l"]
    lam = p["lambda"]
    clm = 1.0 + lam * vds
    on = vov > 0.0
    sat = vds > vov
    ids0 = np.where(on, np.where(sat, 0.5 * beta * vov * vov * clm,
                                 beta * (vov - 0.5 * vds) * vds * clm), 0.0)
    gm = np.where(on, np.where(sat, beta * vov * clm, beta * vds * clm), 0.0)
    gds = np.where(on, np.where(
        sat, 0.5 * beta * vov * vov * lam,
        beta * ((vov - vds) * clm + (vov - 0.5 * vds) * vds * lam)), 0.0)
    sgn = np.where(fwd, 1.0, -1.0).astype(u.dtype)
    ids = ids0 * sgn * ty + gmin * (u[..., 0] - u[..., 2])
    z = np.zeros_like(gm)
    # d ids / d (u_d, u_g, u_s, u_b)
    ch = np.stack([np.where(fwd, gds, gm + gds) + gmin,
                   np.where(fwd, gm, -gm),
                   np.where(fwd, -gm - gds, -gds) - gmin, z], -1)
    isat = p["is"]
    ebd, dbd = dv.exp_lin((vb - vd) / vt)
    ebs, dbs = dv.exp_lin((vb - vs) / vt)
    ibd = isat * (ebd - 1.0) + gmin * (vb - vd)
    ibs = isat * (ebs - 1.0) + gmin * (vb - vs)
    gbd = isat * dbd / vt + gmin
    gbs = isat * dbs / vt + gmin
    f = np.stack([ids - ty * ibd, z, -ids - ty * ibs, ty * (ibd + ibs)], -1)
    G = np.zeros(u.shape + (4,), u.dtype)
    G[..., 0, :] = ch
    G[..., 0, 0] += gbd
    G[..., 0, 3] -= gbd
    G[..., 2, :] = -ch
    G[..., 2, 2] += gbs
    G[..., 2, 3] -= gbs
    G[..., 3, 0] = -gbd
    G[..., 3, 2] = -gbs
    G[..., 3, 3] = gbd + gbs
    ud, ug, us, ub = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    cgs, cgd, cgb = p["cgso"], p["cgdo"], p["cgbo"]
    cbd, cbs = p["cbd"], p["cbs"]
    qgs, qgd, qgb = cgs * (ug - us), cgd * (ug - ud), cgb * (ug - ub)
    qbd, qbs = cbd * (ub - ud), cbs * (ub - us)
    q = np.stack([-qgd - qbd, qgs + qgd + qgb, -qgs - qbs,
                  -qgb + qbd + qbs], -1)
    Cm = np.zeros(p["cgso"].shape + (4, 4), u.dtype)
    Cm[..., 0, 0] = cgd + cbd
    Cm[..., 0, 1] = -cgd
    Cm[..., 0, 3] = -cbd
    Cm[..., 1, 0] = -cgd
    Cm[..., 1, 1] = cgs + cgd + cgb
    Cm[..., 1, 2] = -cgs
    Cm[..., 1, 3] = -cgb
    Cm[..., 2, 1] = -cgs
    Cm[..., 2, 2] = cgs + cbs
    Cm[..., 2, 3] = -cbs
    Cm[..., 3, 0] = -cbd
    Cm[..., 3, 1] = -cgb
    Cm[..., 3, 2] = -cbs
    Cm[..., 3, 3] = cgb + cbd + cbs
    return f, q, G, np.broadcast_to(Cm, G.shape)


def limit(u, uold, p, vt):
    ty = p["type"]
    v, vo = ty[..., None] * u, ty[..., None] * uold
    vd, vg, vs, vb = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    fwd = vd >= vs
    src = np.where(fwd, vs, vd)
    src_o = np.where(fwd, vo[..., 2], vo[..., 0])
    vgs = dv.fetlim(vg - src, vo[..., 1] - src_o, ty * p["vto"])
    vds = dv.limvds(np.abs(vd - vs), np.abs(vo[..., 0] - vo[..., 2]))
    drain = src + vds
    vd2 = np.where(fwd, drain, vd)
    vs2 = np.where(fwd, vs, drain)
    vcrit = vt * np.log(vt / (dv.SQRT2 * p["is"]))
    vbd = dv.pnjlim(vb - vd2, vo[..., 3] - vo[..., 0], vt, vcrit)
    vbs = dv.pnjlim(vb - vs2, vo[..., 3] - vo[..., 2], vt, vcrit)
    out = np.stack([vb - vbd, src + vgs, vb - vbs, vb], -1)
    return ty[..., None] * out
