"""The EKV 2.6-style long-channel MOSFET, `.model NAME ekv26 (...)`, as the
Verilog-A module `ekv26` states it (the program's `models/ekv.py`, EKV_VA,
which a deck loads by `.hdl`); terminals d g s b. Written out by hand in
NumPy from that text; nothing compiles the Verilog-A.

With vg, vd, vs the gate, drain and source voltages over the bulk times
`sign` (+1 NMOS, -1 PMOS), vp = (vg - vto) / n the pinch-off voltage and
F(x) = ln(1 + limexp(x / 2))^2 (limexp: exp, continued linearly above 80):

  i_f = F((vp - vs) / vt),  i_r = F((vp - vd) / vt)
  ids = 2 n beta vt^2 (i_f - i_r) (1 + lambda |vd - vs|),  beta = kp w / l

flowing from d to s times `sign`. The channel charge qch = -w l cox n vt
(sqrt(i_f) + sqrt(i_r)) is split 50/50 between drain and source, the gate
holds -qch (each against the bulk, times `sign`), and the overlap charges
are cgso w V(g, s) and cgdo w V(g, d). |x| takes the derivative +1 at 0, as
the program's `abs` does. The module's noise terms (channel thermal and
flicker noise, `kf` and `af`) are left out: they enter neither the
currents nor the charges. No gmin: the Verilog-A text has none.
"""
from __future__ import annotations

import numpy as np

from .. import devices as dv

LETTER = "m"
CARD = True
TERMINALS = ("d", "g", "s", "b")
PARAMS = {"sign": 1.0, "vto": 0.5, "n": 1.3, "kp": 200e-6, "lambda": 0.0,
          "w": 1e-6, "l": 1e-6, "cox": 3e-3, "cgso": 1e-10, "cgdo": 1e-10,
          "kf": 0.0, "af": 1.0}
INSTANCE = ("w", "l")


def validate(name, p):
    if p["sign"] not in (1.0, -1.0):
        raise ValueError(f"{name}: ekv26's sign is +1 or -1, not {p['sign']}")


def evaluate(u, p, vt, gmin):
    sg = p["sign"]
    vb = u[..., 3]
    vd, vg, vs = (sg * (u[..., k] - vb) for k in (0, 1, 2))
    n, w, l = p["n"], p["w"], p["l"]
    beta = p["kp"] * w / l
    vp = (vg - p["vto"]) / n
    # x = ln(1 + limexp(z)), z = (vp - v) / (2 vt); h = dx/dz
    ef, def_ = dv.exp_lin((vp - vs) / (2.0 * vt))
    er, der = dv.exp_lin((vp - vd) / (2.0 * vt))
    xf, xr = np.log1p(ef), np.log1p(er)
    hf, hr = def_ / (1.0 + ef), der / (1.0 + er)
    isq = 2.0 * n * beta * vt * vt
    dif = xf * xf - xr * xr
    vds = vd - vs
    s = np.where(vds >= 0.0, 1.0, -1.0).astype(u.dtype)
    a = 1.0 + p["lambda"] * s * vds
    ids = isq * dif * a
    # d ids / d (vd, vg, vs), with dz/dvg = 1 / (2 n vt), dz/dv = -1 / (2 vt)
    k = 1.0 / (2.0 * vt)
    gd = isq * (a * 2.0 * xr * hr * k + dif * p["lambda"] * s)
    gg = isq * a * 2.0 * (xf * hf - xr * hr) * k / n
    gs = isq * (-a * 2.0 * xf * hf * k - dif * p["lambda"] * s)
    # the same over the terminal voltages (d, g, s, b)
    gt = np.stack([gd, gg, gs, -(gd + gg + gs)], -1) * sg[..., None]
    f_d = sg * ids
    z = np.zeros_like(f_d)
    f = np.stack([f_d, z, -f_d, z], -1)
    G = np.zeros(u.shape + (4,), u.dtype)
    G[..., 0, :] = sg[..., None] * gt
    G[..., 2, :] = -sg[..., None] * gt

    # charges: Q1 = sign qg on (g, b), Q2 = Q3 = sign qch / 2 on (d, b) and
    # (s, b), Q4 = cgso w V(g, s), Q5 = cgdo w V(g, d)
    kq = -w * l * p["cox"] * n * vt
    qch = kq * (xf + xr)
    cd, cg, cs = -kq * hr * k, kq * (hf + hr) * k / n, -kq * hf * k
    ct = np.stack([cd, cg, cs, -(cd + cg + cs)], -1) * sg[..., None]
    q1, q2 = -sg * qch, 0.5 * sg * qch
    c1, c2 = -sg[..., None] * ct, 0.5 * sg[..., None] * ct
    cgs, cgd = p["cgso"] * w, p["cgdo"] * w
    ud, ug, us = u[..., 0], u[..., 1], u[..., 2]
    q4, q5 = cgs * (ug - us), cgd * (ug - ud)
    q = np.stack([q2 - q5, q1 + q4 + q5, q2 - q4, -(q1 + 2.0 * q2)], -1)
    c4 = np.stack([z, z + cgs, z - cgs, z], -1)
    c5 = np.stack([z - cgd, z + cgd, z, z], -1)
    C = np.stack([c2 - c5, c1 + c4 + c5, c2 - c4, -(c1 + 2.0 * c2)], -2)
    return f, q, G, C
