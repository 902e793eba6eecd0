"""The SPICE junction diode with series resistance, behind the `.model`
type `d`: `dNAME anode cathode model [area]`; terminals p n and the
internal anode, which the program names `<name>#int` (the reference needs
rs > 0). Breakdown, and the depletion charge linearised above fc * vj;
gmin across the junction.
"""
from __future__ import annotations

import numpy as np

from .. import devices as dv

LETTER = "d"
CARD = True
TERMINALS = ("p", "n")
INTERNAL = (("#int", "voltage"),)
PARAMS = {"is": 1e-14, "n": 1.0, "rs": 0.0, "cjo": 0.0, "vj": 1.0,
          "m": 0.5, "fc": 0.5, "tt": 0.0, "bv": 0.0, "ibv": 1e-3,
          "area": 1.0}
INSTANCE = ("area",)
VALUE = "area"


def validate(name, p):
    if p["rs"] <= 0.0:
        raise ValueError(f"{name}: the reference needs rs > 0")


def diode_iq(vd, p, vt, gmin):
    vtn = p["n"] * vt
    is_ = p["is"] * p["area"]
    x = vd / vtn
    inside = np.abs(x) < dv.EXP_MAX
    e = np.exp(np.clip(x, -dv.EXP_MAX, dv.EXP_MAX))
    idf = is_ * (e - 1.0)
    gdf = np.where(inside, is_ * e / vtn, 0.0)
    bv = p["bv"]
    xb = -(vd + bv) / vt
    eb = np.exp(np.clip(xb, -dv.EXP_MAX, dv.EXP_MAX))
    has_bv = bv > 0.0
    ibr = np.where(has_bv, -p["ibv"] * eb, 0.0)
    gbr = np.where(has_bv & (np.abs(xb) < dv.EXP_MAX), p["ibv"] * eb / vt,
                   0.0)
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


def evaluate(u, p, vt, gmin):
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


def limit(u, uold, p, vt):
    vtn = p["n"] * vt
    vcrit = vtn * np.log(vtn / (dv.SQRT2 * p["is"] * p["area"]))
    vd = dv.pnjlim(u[..., 2] - u[..., 1], uold[..., 2] - uold[..., 1], vtn,
                   vcrit)
    return np.stack([u[..., 0], u[..., 1], u[..., 1] + vd], -1)
