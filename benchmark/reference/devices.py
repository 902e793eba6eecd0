"""Device equations of the plain reference, in NumPy, batched over lanes.

Each model maps local terminal voltages u [B, I, L] (lanes, instances,
terminals) and parameters (arrays that broadcast to [B, I]) to the
resistive currents f and charges q leaving each terminal [B, I, L] and
their Jacobians G = df/du and C = dq/du [B, I, L, L], written out by hand.
Limiters map a Newton iterate and the previous evaluation point to the
point at which the model is evaluated (SPICE3's pnjlim, fetlim, limvds).

The equations are the textbook SPICE level-1 MOSFET (Shichman-Hodges
square law with channel-length modulation, drain and source swapped when
vds < 0, bulk junction diodes, fixed overlap and junction capacitances:
as this simulator's level-1 card reads them, cgso / cgdo / cbd / cbs are
capacitances of the device, not per width or area) and the SPICE junction
diode with series resistance, breakdown and depletion charge linearised
above fc * vj. gmin is added across each junction and across the channel.
"""
from __future__ import annotations

import math

import numpy as np

SQRT2 = math.sqrt(2.0)
KB = 1.380649e-23
QE = 1.602176634e-19
EXP_MAX = 80.0


def thermal_voltage(temp_c: float) -> float:
    return KB * (temp_c + 273.15) / QE


def pnjlim(vnew, vold, vt, vcrit):
    """SPICE3 junction limiter."""
    big = (vnew > vcrit) & (np.abs(vnew - vold) > 2.0 * vt)
    arg = 1.0 + (vnew - vold) / vt
    with np.errstate(divide="ignore", invalid="ignore"):
        up = np.where(arg > 0.0,
                      vold + vt * np.log(np.maximum(arg, 1e-300)), vcrit)
        fresh = vt * np.log(np.maximum(vnew / vt, 1e-300))
    lim = np.where(vold > 0.0, up, fresh)
    return np.where(big, lim, vnew).astype(vnew.dtype)


def fetlim(vnew, vold, vto):
    """SPICE3 gate-voltage limiter (DEVfetlim)."""
    vtsthi = np.abs(2.0 * (vold - vto)) + 2.0
    vtstlo = np.abs(vold - vto) + 1.0
    vtox = vto + 3.5
    delv = vnew - vold
    on = np.where(
        delv <= 0.0,
        np.where(vnew >= vtox, np.where(-delv > vtstlo, vold - vtstlo, vnew),
                 np.maximum(vnew, vto + 2.0)),
        np.where(delv >= vtsthi, vold + vtsthi, vnew))
    mid = np.where(delv <= 0.0, np.maximum(vnew, vto - 0.5),
                   np.minimum(vnew, vto + 4.0))
    off = np.where(
        delv <= 0.0, np.where(-delv > vtsthi, vold - vtsthi, vnew),
        np.where(vnew <= vto + 0.5,
                 np.where(delv > vtstlo, vold + vtstlo, vnew),
                 vto + 0.5 + 0.0 * vnew))
    return np.where(vold >= vto, np.where(vold >= vtox, on, mid),
                    off).astype(vnew.dtype)


def limvds(vnew, vold):
    """SPICE3 drain-source limiter (DEVlimvds)."""
    hi = np.where(vnew > vold, np.minimum(vnew, 3.0 * vold + 2.0),
                  np.where(vnew < 3.5, np.maximum(vnew, 2.0), vnew))
    lo = np.where(vnew > vold, np.minimum(vnew, 4.0),
                  np.maximum(vnew, -0.5))
    return np.where(vold >= 3.5, hi, lo).astype(vnew.dtype)


def _exp_lin(x):
    """exp with linear continuation above EXP_MAX, and its derivative."""
    e = np.exp(np.minimum(x, EXP_MAX))
    return e * (1.0 + np.maximum(x - EXP_MAX, 0.0)), e


# ---------------------------------------------------------------------------
# level-1 MOSFET, terminals d g s b

def mos1_eval(u, p, vt, gmin):
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
    ebd, dbd = _exp_lin((vb - vd) / vt)
    ebs, dbs = _exp_lin((vb - vs) / vt)
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


def mos1_limit(u, uold, p, vt):
    ty = p["type"]
    v, vo = ty[..., None] * u, ty[..., None] * uold
    vd, vg, vs, vb = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    fwd = vd >= vs
    src = np.where(fwd, vs, vd)
    src_o = np.where(fwd, vo[..., 2], vo[..., 0])
    vgs = fetlim(vg - src, vo[..., 1] - src_o, ty * p["vto"])
    vds = limvds(np.abs(vd - vs), np.abs(vo[..., 0] - vo[..., 2]))
    drain = src + vds
    vd2 = np.where(fwd, drain, vd)
    vs2 = np.where(fwd, vs, drain)
    vcrit = vt * np.log(vt / (SQRT2 * p["is"]))
    vbd = pnjlim(vb - vd2, vo[..., 3] - vo[..., 0], vt, vcrit)
    vbs = pnjlim(vb - vs2, vo[..., 3] - vo[..., 2], vt, vcrit)
    out = np.stack([vb - vbd, src + vgs, vb - vbs, vb], -1)
    return ty[..., None] * out


# ---------------------------------------------------------------------------
# junction diode with series resistance, terminals p n and the internal
# anode (rs > 0)

def diode_iq(vd, p, vt, gmin):
    vtn = p["n"] * vt
    is_ = p["is"] * p["area"]
    x = vd / vtn
    inside = np.abs(x) < EXP_MAX
    e = np.exp(np.clip(x, -EXP_MAX, EXP_MAX))
    idf = is_ * (e - 1.0)
    gdf = np.where(inside, is_ * e / vtn, 0.0)
    bv = p["bv"]
    xb = -(vd + bv) / vt
    eb = np.exp(np.clip(xb, -EXP_MAX, EXP_MAX))
    has_bv = bv > 0.0
    ibr = np.where(has_bv, -p["ibv"] * eb, 0.0)
    gbr = np.where(has_bv & (np.abs(xb) < EXP_MAX), p["ibv"] * eb / vt, 0.0)
    i = idf + ibr + gmin * vd
    g = gdf + gbr + gmin
    cj0, vj, m, fc = p["cjo"] * p["area"], p["vj"], p["m"], p["fc"]
    fcv = fc * vj
    below = vd < fcv
    arg = np.maximum(1.0 - np.minimum(vd, fcv) / vj, 1e-6)
    qb = cj0 * vj / (1.0 - m) * (1.0 - arg ** (1.0 - m))
    cb = cj0 * arg ** (-m)
    f1 = cj0 * vj / (1.0 - m) * (1.0 - (1.0 - fc) ** (1.0 - m))
    f2 = (1.0 - fc) ** (-1.0 - m)
    qa = f1 + cj0 * f2 * ((1.0 - fc * (1.0 + m)) * (vd - fcv)
                          + 0.5 * m / vj * (vd * vd - fcv * fcv))
    ca = cj0 * f2 * ((1.0 - fc * (1.0 + m)) + m * vd / vj)
    q = np.where(below, qb, qa) + p["tt"] * idf
    c = np.where(below, cb, ca) + p["tt"] * gdf
    return i, g, q, c


def diode_eval(u, p, vt, gmin):
    vp, vn, vi = u[..., 0], u[..., 1], u[..., 2]
    grs = 1.0 / p["rs"]
    ir = grs * (vp - vi)
    i, g, q, c = diode_iq(vi - vn, p, vt, gmin)
    z = np.zeros_like(i)
    f = np.stack([ir, -i, i - ir], -1)
    qv = np.stack([z, -q, q], -1)
    G = np.zeros(u.shape + (3,), u.dtype)
    G[..., 0, 0] = grs
    G[..., 0, 2] = -grs
    G[..., 1, 1] = g
    G[..., 1, 2] = -g
    G[..., 2, 0] = -grs
    G[..., 2, 1] = -g
    G[..., 2, 2] = g + grs
    C = np.zeros_like(G)
    C[..., 1, 1] = c
    C[..., 1, 2] = -c
    C[..., 2, 1] = -c
    C[..., 2, 2] = c
    return f, qv, G, C


def diode_limit(u, uold, p, vt):
    vtn = p["n"] * vt
    vcrit = vtn * np.log(vtn / (SQRT2 * p["is"] * p["area"]))
    vd = pnjlim(u[..., 2] - u[..., 1], uold[..., 2] - uold[..., 1], vtn, vcrit)
    return np.stack([u[..., 0], u[..., 1], u[..., 1] + vd], -1)


MOS1_DEFAULTS = {"vto": 0.0, "kp": 2e-5, "lambda": 0.0, "cgso": 0.0,
                 "cgdo": 0.0, "cgbo": 0.0, "cbd": 0.0, "cbs": 0.0,
                 "is": 1e-14, "w": 1e-4, "l": 1e-4}
DIODE_DEFAULTS = {"is": 1e-14, "n": 1.0, "rs": 0.0, "cjo": 0.0, "vj": 1.0,
                  "m": 0.5, "fc": 0.5, "tt": 0.0, "bv": 0.0, "ibv": 1e-3,
                  "area": 1.0}
