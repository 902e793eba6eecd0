""".meas/.measure card evaluation over transient (and AC/DC-sweep)
solutions (the port's copy of `cadnip_tpu/analyses/measure.py`, which is
numpy only): ngspice-style post-processing (the reference parses these in
its lossless CST, `NyanSpectreNetlistParser`; evaluation here follows the
public ngspice .meas semantics):

  .meas tran NAME avg|rms|min|max|pp|integ EXPR [from=F] [to=T]
  .meas tran NAME find EXPR at=T
  .meas tran NAME find EXPR when EXPR2=VAL [rise=N|fall=N|cross=N|last]
  .meas tran NAME when EXPR=VAL [rise=N|fall=N|cross=N|last] [td=T]
  .meas tran NAME trig EXPR val=V [rise=N|fall=N|cross=N] [td=T]
                  targ EXPR val=V [rise=N|fall=N|cross=N] [td=T]
  .meas tran NAME param = EXPR          (arithmetic over prior results)

EXPR is v(node[,node2]), i(vsource), a number, or a previously measured
name. Results land in simulate()'s output under 'meas'. A solution's
tensors (on the card or the host) are read as numpy arrays.
"""
from __future__ import annotations

import re

import numpy as np


class MeasError(ValueError):
    pass


_SIG = r"(?:[vi]\s*\([^)]*\)|[-+]?[\w.{}*/+()]+)"


def _num(tok, env):
    from ..frontend.expressions import eval_expr, parse_expr
    try:
        return float(tok)
    except ValueError:
        return float(eval_expr(parse_expr(tok), env))


class _Env(dict):
    def __contains__(self, k):
        return dict.__contains__(self, k.lower())

    def __getitem__(self, k):
        return dict.get(self, k.lower())


def _host(v):
    """A solution's values as a numpy array (tensors leave their device)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _signal(expr, sol, env):
    """Evaluate a measurement signal expression over the save grid."""
    e = expr.strip().lower()
    m = re.match(r"^v\s*\(\s*([^,)\s]+)\s*(?:,\s*([^)\s]+))?\s*\)$", e)
    if m:
        v = _host(sol[m.group(1)])
        if m.group(2):
            v = v - _host(sol[m.group(2)])
        return v
    m = re.match(r"^i\s*\(\s*([^)\s]+)\s*\)$", e)
    if m:
        return _host(sol[f"{m.group(1)}#i"])
    # scalar expression (numbers, prior results)
    return np.full(len(_host(sol.ts)), _num(e, env))


def _crossings(ts, y, val, kind, nth, td=0.0):
    """Times where y crosses val (linear interpolation); kind in
    rise/fall/cross; nth is 1-based or -1 for LAST."""
    y = np.asarray(y, float)
    d = y - val
    s = np.signbit(d)
    idx = np.nonzero(s[:-1] != s[1:])[0]
    times = []
    for i in idx:
        frac = d[i] / (d[i] - d[i + 1])
        t = ts[i] + frac * (ts[i + 1] - ts[i])
        if t < td:
            continue
        rising = y[i + 1] > y[i]
        if kind == "rise" and not rising:
            continue
        if kind == "fall" and rising:
            continue
        times.append(t)
    if not times:
        raise MeasError(f"no {kind} crossing of {val}")
    if nth == -1:
        return times[-1]
    if nth > len(times):
        raise MeasError(f"only {len(times)} {kind} crossings, "
                        f"wanted #{nth}")
    return times[nth - 1]


def _edge_opts(text):
    kind, nth, td = "cross", 1, 0.0
    m = re.search(r"\brise\s*=\s*(last|\d+)", text)
    if m:
        kind = "rise"
        nth = -1 if m.group(1) == "last" else int(m.group(1))
    m = re.search(r"\bfall\s*=\s*(last|\d+)", text)
    if m:
        kind = "fall"
        nth = -1 if m.group(1) == "last" else int(m.group(1))
    m = re.search(r"\bcross\s*=\s*(last|\d+)", text)
    if m:
        kind = "cross"
        nth = -1 if m.group(1) == "last" else int(m.group(1))
    m = re.search(r"\btd\s*=\s*([\w.+-]+)", text)
    if m:
        from ..frontend.expressions import parse_number
        td = parse_number(m.group(1)) or float(m.group(1))
    return kind, nth, td


def eval_meas(line, sol, results):
    """Evaluate one .meas card line against a solution; returns
    (name, value). `results` holds prior measurements (usable in
    param expressions and bounds)."""
    from ..frontend.expressions import parse_number
    env = _Env({k.lower(): v for k, v in results.items()})

    body = re.sub(r"^\.\s*meas(?:ure)?\s+\w+\s+", "", line.strip(),
                  flags=re.I)
    m = re.match(r"^(\w+)\s+(.*)$", body, re.S)
    if not m:
        raise MeasError(f"malformed .meas: {line!r}")
    name, rest = m.group(1), m.group(2).strip()
    low = rest.lower()
    ts = _host(sol.ts).astype(float)

    def window(y):
        f = re.search(r"\bfrom\s*=\s*([\w.+-]+)", low)
        t = re.search(r"\bto\s*=\s*([\w.+-]+)", low)
        t0 = (parse_number(f.group(1)) if f else ts[0])
        t1 = (parse_number(t.group(1)) if t else ts[-1])
        mask = (ts >= t0) & (ts <= t1)
        return ts[mask], np.asarray(y)[mask]

    m = re.match(r"^(avg|rms|min|max|pp|integ)\s+(" + _SIG + ")", low)
    if m:
        op, sig = m.group(1), m.group(2)
        tw, yw = window(_signal(sig, sol, env))
        if op == "avg":
            val = np.trapezoid(yw, tw) / max(tw[-1] - tw[0], 1e-300)
        elif op == "rms":
            val = np.sqrt(np.trapezoid(yw * yw, tw)
                          / max(tw[-1] - tw[0], 1e-300))
        elif op == "min":
            val = yw.min()
        elif op == "max":
            val = yw.max()
        elif op == "pp":
            val = yw.max() - yw.min()
        else:
            val = np.trapezoid(yw, tw)
        return name, float(val)

    m = re.match(r"^find\s+(" + _SIG + r")\s+at\s*=\s*([\w.+-]+)", low)
    if m:
        y = _signal(m.group(1), sol, env)
        t = parse_number(m.group(2))
        return name, float(np.interp(t, ts, y))

    m = re.match(r"^find\s+(" + _SIG + r")\s+when\s+(" + _SIG
                 + r")\s*=\s*([\w.+-]+)(.*)$", low, re.S)
    if m:
        y = _signal(m.group(1), sol, env)
        y2 = _signal(m.group(2), sol, env)
        val = _num(m.group(3), env)
        kind, nth, td = _edge_opts(m.group(4))
        tc = _crossings(ts, y2, val, kind, nth, td)
        return name, float(np.interp(tc, ts, y))

    m = re.match(r"^when\s+(" + _SIG + r")\s*=\s*([\w.+-]+)(.*)$", low,
                 re.S)
    if m:
        y = _signal(m.group(1), sol, env)
        val = _num(m.group(2), env)
        kind, nth, td = _edge_opts(m.group(3))
        return name, float(_crossings(ts, y, val, kind, nth, td))

    m = re.match(r"^trig\s+(" + _SIG + r")\s+val\s*=\s*([\w.+-]+)"
                 r"(.*?)\btarg\s+(" + _SIG + r")\s+val\s*=\s*([\w.+-]+)"
                 r"(.*)$", low, re.S)
    if m:
        y1 = _signal(m.group(1), sol, env)
        v1 = _num(m.group(2), env)
        k1, n1, td1 = _edge_opts(m.group(3))
        y2 = _signal(m.group(4), sol, env)
        v2 = _num(m.group(5), env)
        k2, n2, td2 = _edge_opts(m.group(6))
        t_trig = _crossings(ts, y1, v1, k1, n1, td1)
        t_targ = _crossings(ts, y2, v2, k2, n2, td2)
        return name, float(t_targ - t_trig)

    m = re.match(r"^param\s*=?\s*(.*)$", rest, re.I | re.S)
    if m:
        from ..frontend.expressions import eval_expr, parse_expr
        expr = m.group(1).strip().strip("'\"")
        return name, float(eval_expr(parse_expr(expr), env))

    raise MeasError(f"unsupported .meas form: {line!r}")
