"""The waveforms of the reference's independent sources (`models/v.py`,
`models/i.py`): the value part of a source's line, its value at time t and
its corners, the times at which the integrator has to step.

  [dc] v | dc=v                ("dc", v)
  sin vo va freq td theta ph   ("sin", vo, va, freq, td, theta, ph)
  pwl t0 v0 t1 v1 ...          ("pwl", t0, v0, t1, v1, ...)
  pulse v1 v2 td tr tf pw per  ("pulse", v1, v2, td, tr, tf, pw, per)

A transient waveform sets the value at every time, the operating point's
too; a DC value beside it is read past. SIN's omitted values are 0. PWL is
held flat beyond its ends. PULSE reads as SPICE3 reads it: td 0 where
omitted, and tr and tf the `.tran` card's step, pw and per its stop time,
where they are omitted or 0; so a PULSE that leaves one of those out needs
the deck's `.tran` card.
"""
from __future__ import annotations

import math

import numpy as np

from .netlist import value as number

KINDS = ("sin", "pwl", "pulse")


def parse_wave(toks, tran):
    """The waveform of a source line's tokens after its nodes (lower
    case, parentheses gone, `k=v` joined). tran: the `.tran` card's (step,
    stop), or None."""
    dc, i = 0.0, 0
    if i < len(toks) and toks[i].startswith("dc="):
        dc = number(toks[i][3:])
        i += 1
    elif i < len(toks) and toks[i] == "dc":
        i += 1
    if i < len(toks) and toks[i] not in KINDS:
        dc = number(toks[i])
        i += 1
    if i >= len(toks):
        return ("dc", dc)
    kind, args = toks[i], [number(t) for t in toks[i + 1:]]
    if kind not in KINDS:
        raise ValueError(f"unsupported source {kind!r}")
    if kind == "sin":
        if not 3 <= len(args) <= 6:
            raise ValueError("SIN needs 3 to 6 values")
        return ("sin", *(args + [0.0] * 3)[:6])
    if kind == "pwl":
        if len(args) % 2 or not args:
            raise ValueError("PWL needs time/value pairs")
        return ("pwl", *args)
    if not 2 <= len(args) <= 7:
        raise ValueError("PULSE needs 2 to 7 values")
    v1, v2, td, tr, tf, pw, per = args + [0.0] * (7 - len(args))
    if not (tr and tf and pw and per):
        if tran is None:
            raise ValueError("a PULSE without tr, tf, pw or per takes "
                             "them from the .tran card, and there is none")
        step, stop = tran
        tr, tf = tr or step, tf or step
        pw, per = pw or stop, per or stop
    return ("pulse", v1, v2, td, tr, tf, pw, per)


def value(wave, t):
    """The waveform's value at time t."""
    kind = wave[0]
    if kind == "dc":
        return wave[1]
    if kind == "sin":
        vo, va, fr, td, theta, ph = wave[1:7]
        if t < td:
            return vo + va * math.sin(2.0 * math.pi * ph / 360.0)
        tl = t - td
        return vo + va * math.exp(-tl * theta) * math.sin(
            2.0 * math.pi * (fr * tl + ph / 360.0))
    if kind == "pwl":
        ts, vs = np.asarray(wave[1::2]), np.asarray(wave[2::2])
        return float(np.interp(t, ts, vs))
    v1, v2, td, tr, tf, pw, per = wave[1:8]
    tl = t - td
    if tl > per:
        tl -= per * math.floor(tl / per)
    if tl <= 0.0 or tl >= tr + pw + tf:
        return v1
    if tl >= tr + pw:
        return v2 + (v1 - v2) * (tl - tr - pw) / tf
    if tl >= tr:
        return v2
    return v1 + (v2 - v1) * tl / tr


def corners(wave, tstop):
    """The waveform's corners in (0, tstop): PWL's times, SIN's delay,
    PULSE's four edges in every period."""
    kind = wave[0]
    if kind == "pwl":
        out = list(wave[1::2])
    elif kind == "sin":
        out = [wave[4]]
    elif kind == "pulse":
        _, _, td, tr, tf, pw, per = wave[1:8]
        out, k = [], 0
        while td + k * per < tstop:
            t = td + k * per
            out += [t, t + tr, t + tr + pw, t + tr + pw + tf]
            k += 1
    else:
        out = []
    return [t for t in out if 0.0 < t < tstop]
