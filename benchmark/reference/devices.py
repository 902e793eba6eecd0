"""Numerics that the reference's device models share (`models/`): the
thermal voltage, SPICE3's limiters (pnjlim, fetlim, limvds), which map a
Newton iterate and the previous evaluation point to the point at which a
model is evaluated, and exp with a linear continuation.
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


def exp_lin(x):
    """exp with linear continuation above EXP_MAX, and its derivative."""
    e = np.exp(np.minimum(x, EXP_MAX))
    return e * (1.0 + np.maximum(x - EXP_MAX, 0.0)), e
