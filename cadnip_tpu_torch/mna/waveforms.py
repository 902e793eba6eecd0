"""Time-dependent source waveforms (DC / PULSE / SIN / PWL / EXP / SFFM).

PyTorch port of `cadnip_tpu/mna/waveforms.py`. Every independent source
carries one `Waveform`, packed as (int kind code, fixed-width coefficient
vector). `eval_wave` evaluates any mix of kinds: every branch is computed
and the result selected with `torch.where` on the kind (the JAX package
dispatches with `lax.switch`), so it stays traceable by `torch.func`.

Host-side, each waveform publishes its `breakpoints()` — the kink times a
transient integrator must land on exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..config import DTYPE, ITYPE

WAVE_DC = 0
WAVE_PULSE = 1
WAVE_SIN = 2
WAVE_PWL = 3
WAVE_EXP = 4
WAVE_SFFM = 5

_MIN_COEFFS = 8


@dataclasses.dataclass(frozen=True)
class Waveform:
    kind: int
    coeffs: tuple            # raw python floats, variable length
    dc: float = 0.0          # DC analysis value

    def breakpoints(self, tstop: float) -> np.ndarray:
        return _breakpoints(self, tstop)


def DC(value: float = 0.0) -> Waveform:
    return Waveform(WAVE_DC, (float(value),), dc=float(value))


def Pulse(v1, v2, td=0.0, tr=1e-9, tf=1e-9, pw=np.inf, per=np.inf
          ) -> Waveform:
    """SPICE PULSE(v1 v2 td tr tf pw per)."""
    return Waveform(WAVE_PULSE,
                    tuple(float(x) for x in (v1, v2, td, tr, tf, pw, per)),
                    dc=float(v1))


def Sin(vo, va, freq, td=0.0, theta=0.0, phase_deg=0.0) -> Waveform:
    """SPICE SIN(vo va freq td theta phase)."""
    return Waveform(WAVE_SIN,
                    tuple(float(x) for x in (vo, va, freq, td, theta,
                                             phase_deg)),
                    dc=float(vo))


def PWL(points: Sequence[float]) -> Waveform:
    """SPICE PWL(t1 v1 t2 v2 ...). Flat extrapolation beyond the ends."""
    pts = tuple(float(x) for x in points)
    if len(pts) < 2 or len(pts) % 2:
        raise ValueError("PWL needs an even number of >= 2 values")
    return Waveform(WAVE_PWL, pts, dc=pts[1])


def Exp(v1, v2, td1=0.0, tau1=1e-9, td2=1e-9, tau2=1e-9) -> Waveform:
    return Waveform(WAVE_EXP,
                    tuple(float(x) for x in (v1, v2, td1, tau1, td2, tau2)),
                    dc=float(v1))


def Sffm(vo, va, fc, mdi=0.0, fs=0.0) -> Waveform:
    return Waveform(WAVE_SFFM,
                    tuple(float(x) for x in (vo, va, fc, mdi, fs)),
                    dc=float(vo))


# ---------------------------------------------------------------------------
# packing: list of Waveforms -> {kind [n], coeffs [n, width], ncoef, dc}

def pack_waveforms(waves: Sequence[Waveform], *, device):
    width = max(_MIN_COEFFS, max((len(w.coeffs) for w in waves), default=0))
    width += width % 2  # keep even so PWL (t,v) pairs split cleanly
    kinds = np.array([w.kind for w in waves], np.int64)
    ncoef = np.array([len(w.coeffs) for w in waves], np.int64)
    coeffs = np.zeros((len(waves), width), np.float64)
    for i, w in enumerate(waves):
        c = np.asarray(w.coeffs, np.float64)
        if w.kind == WAVE_PULSE:
            # replace inf pw/per with huge-but-finite so arithmetic stays
            # clean
            c = np.where(np.isinf(c), 1e30, c)
        coeffs[i, :len(c)] = c
        if w.kind == WAVE_PWL:
            # pad the tail by repeating the final (t, v) with strictly
            # increasing times so the interpolation stays flat
            tl, vl = c[-2], c[-1]
            for j in range(len(c), width - 1, 2):
                coeffs[i, j] = tl + 1e25 * (j - len(c) + 2)
                coeffs[i, j + 1] = vl
    dc = np.array([w.dc for w in waves], np.float64)
    return {"kind": torch.as_tensor(kinds, dtype=ITYPE, device=device),
            "coeffs": torch.as_tensor(coeffs, dtype=DTYPE, device=device),
            "ncoef": torch.as_tensor(ncoef, dtype=ITYPE, device=device),
            "dc": torch.as_tensor(dc, dtype=DTYPE, device=device)}


# ---------------------------------------------------------------------------
# traced evaluation. Coefficients are [..., width]; t broadcasts against the
# leading axes. Python-float literals keep every op f64 (no float32 traps).

def _eval_dc(t, c):
    return c[..., 0] + 0.0 * t


def _eval_pulse(t, c):
    v1, v2, td = c[..., 0], c[..., 1], c[..., 2]
    tr = torch.clamp(c[..., 3], min=1e-15)
    tf = torch.clamp(c[..., 4], min=1e-15)
    pw = c[..., 5]
    per = torch.clamp(c[..., 6], min=1e-15)
    # jnp.mod is a floored modulo: torch.remainder, not torch.fmod
    tl = torch.where(t < td, -1.0, torch.remainder(t - td, per))
    up = v1 + (v2 - v1) * torch.clip(tl / tr, 0.0, 1.0)
    dn = v2 + (v1 - v2) * torch.clip((tl - tr - pw) / tf, 0.0, 1.0)
    v = torch.where(tl < tr + pw, up, dn)
    return torch.where(tl < 0.0, v1, v)


def _eval_sin(t, c):
    vo, va, fr, td, theta, ph = (c[..., 0], c[..., 1], c[..., 2], c[..., 3],
                                 c[..., 4], c[..., 5])
    tl = t - td
    ramp = vo + va * torch.sin(2 * math.pi * ph / 360.0)
    wave = vo + va * torch.exp(-tl * theta) * torch.sin(
        2 * math.pi * (fr * tl + ph / 360.0))
    return torch.where(tl < 0.0, ramp, wave)


def _eval_pwl(t, c):
    # jnp.interp with flat extrapolation; padded tail times are huge and
    # strictly increasing, so one searchsorted covers the whole vector.
    # Gathers (not t[i] indexing) keep it traceable under torch.func.
    x = (t + 0.0 * c[..., 0]).unsqueeze(-1)
    ts = c[..., 0::2].expand(x.shape[:-1] + (-1,)).contiguous()
    vs = c[..., 1::2].expand(x.shape[:-1] + (-1,)).contiguous()
    m = ts.shape[-1]
    i = torch.clamp(torch.searchsorted(ts, x, right=True), 1, m - 1)
    t_hi, t_lo = ts.gather(-1, i), ts.gather(-1, i - 1)
    v_hi, v_lo = vs.gather(-1, i), vs.gather(-1, i - 1)
    dx = t_hi - t_lo
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float64).eps))
    f = torch.where(dx0, v_lo,
                    v_lo + ((x - t_lo) / torch.where(dx0, 1.0, dx))
                    * (v_hi - v_lo))
    f = torch.where(x < ts[..., :1], vs[..., :1], f)
    f = torch.where(x > ts[..., -1:], vs[..., -1:], f)
    return f[..., 0]


def _eval_exp(t, c):
    v1, v2, td1, td2 = c[..., 0], c[..., 1], c[..., 2], c[..., 4]
    tau1 = torch.clamp(c[..., 3], min=1e-15)
    tau2 = torch.clamp(c[..., 5], min=1e-15)
    rise = (v2 - v1) * (1.0 - torch.exp(
        -torch.clamp(t - td1, min=0.0) / tau1))
    fall = (v1 - v2) * (1.0 - torch.exp(
        -torch.clamp(t - td2, min=0.0) / tau2))
    return (v1 + torch.where(t > td1, rise, 0.0)
            + torch.where(t > td2, fall, 0.0))


def _eval_sffm(t, c):
    vo, va, fc, mdi, fs = (c[..., 0], c[..., 1], c[..., 2], c[..., 3],
                           c[..., 4])
    return vo + va * torch.sin(2 * math.pi * fc * t
                               + mdi * torch.sin(2 * math.pi * fs * t))


_EVALS = [_eval_dc, _eval_pulse, _eval_sin, _eval_pwl, _eval_exp,
          _eval_sffm]


def eval_wave(kind, coeffs, ncoef, t):
    """Evaluate packed waveforms at time t.

    A Python-int kind dispatches statically; a tensor kind evaluates every
    branch and selects with `torch.where` (the counterpart of the JAX
    package's `lax.switch`, branch-free for `torch.func`)."""
    if isinstance(kind, int):
        return _EVALS[kind](t, coeffs)
    out = _EVALS[0](t, coeffs)
    for k in range(1, len(_EVALS)):
        out = torch.where(kind == k, _EVALS[k](t, coeffs), out)
    return out


# ---------------------------------------------------------------------------
# host-side breakpoints

def _breakpoints(w: Waveform, tstop: float) -> np.ndarray:
    c = np.asarray(w.coeffs, np.float64)
    if w.kind == WAVE_PULSE:
        v1, v2, td, tr, tf, pw, per = c
        edges = np.array([0.0, tr, tr + pw, tr + pw + tf])
        if not np.isfinite(per) or per >= 1e29:
            bps = td + edges
        else:
            n = int(np.floor(max(tstop - td, 0.0) / per)) + 1
            bps = (td + edges[None, :]
                   + per * np.arange(n + 1)[:, None]).ravel()
        return bps[(bps >= 0) & (bps <= tstop)]
    if w.kind == WAVE_PWL:
        ts = c[0::2]
        return ts[(ts >= 0) & (ts <= tstop)]
    if w.kind == WAVE_SIN:
        td = c[3]
        return np.array([td]) if 0 <= td <= tstop else np.empty(0)
    if w.kind == WAVE_EXP:
        td1, td2 = c[2], c[4]
        bps = np.array([td1, td2])
        return bps[(bps >= 0) & (bps <= tstop)]
    return np.empty(0)
