"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference (`benchmark/reference`), which takes the
same netlist text and Monte Carlo values and nothing the program made.

A unit is one netlist with B lanes (a sweep's table, or one job's text
with B = 1) and what the program returned for it, in the program's own
layout (`names`: unknown name -> column; a node by its name, an internal
unknown by the name its reference model declares, such as a V source's
branch current "<v>#i" or a diode's internal anode "<d>#int"):

  x0     [B, n]           the operating point (the first save row)
  final  [B, 3, n]        x, q and dq/dt at the end (where returned)
  xs     [m, n_save, n]   the saved waveforms of the lanes `sampled`

The numbers:

  op_kcl_A     the largest, over every lane and job, of each operating
               point's largest KCL residual |f(x0)|, in amperes, with the
               sources at t = 0 (device equations and the DC solve): one
               lane or job at fault is enough to read high
  final_kcl_A  the largest |f(x_T) + dq/dt_T| at tstop: the last step's
               implicit equation (device equations, the last solve, and
               the precision of the state the transient ends in)
  wave_max     the largest distance, over the save rows and nodes, of the
               waveform from the reference's own transient from the same
               state, over the configuration's voltage scale (the
               integration, its step control and every solve on the way),
               as far as two integrators' truncation errors let it: a
               float32 solve moves it less than that. With the check's `window` set, the reference integrates
               one window of that length whose start the seed draws
               (`window_start`), from the program's own saved state there
               (the first window from the operating point).
"""
from __future__ import annotations

import time

import numpy as np

from ..reference import mna, netlist


def port_names(cir: mna.Circuit) -> dict:
    """The program's name of each reference unknown: a node by its name,
    an internal unknown by the name its model module gives it."""
    return {**cir.node_index, **cir.internal_index}


def to_reference(cir: mna.Circuit, names: dict, arr) -> np.ndarray:
    """Reorder the last axis of `arr` from the program's layout to the
    reference's."""
    arr = np.asarray(arr, np.float64)
    out = np.zeros(arr.shape[:-1] + (cir.n,))
    for nm, ri in port_names(cir).items():
        if nm not in names:
            raise KeyError(f"the program returned no unknown {nm!r}")
        out[..., ri] = arr[..., names[nm]]
    return out


def judge(unit: dict, cfg: dict, check: dict) -> dict:
    """The numbers of one unit (see the module's docstring)."""
    net = netlist.parse(unit["text"])
    ov = unit.get("overrides") or {}
    x0p = np.asarray(unit["x0"], np.float64)
    B = x0p.shape[0]
    cir = mna.Circuit(net, B, ov)
    x0 = to_reference(cir, unit["names"], x0p)
    out = {}
    cir.set_time(0.0)
    out["op_kcl_lanes"] = np.abs(cir.evaluate(x0)[0]).max(-1)
    if unit.get("final") is not None:
        fin = to_reference(cir, unit["names"], unit["final"])
        cir.set_time(unit["tstop"])
        F = cir.evaluate(fin[:, 0])[0]
        out["final_kcl_A"] = float(np.abs(F + fin[:, 2]).max())
    if unit.get("xs") is not None:
        lanes = np.asarray(unit["sampled"])
        sub = {k: np.asarray(v)[lanes] for k, v in ov.items()}
        rc = mna.Circuit(net, len(lanes), sub)
        xs = to_reference(rc, unit["names"], unit["xs"])
        ts = np.asarray(unit["ts"])
        t0, t1 = ts[0], unit["tstop"]
        if check.get("window"):
            t0 = unit["window_start"]
            t1 = min(t0 + check["window"], unit["tstop"])
        rows = np.flatnonzero((ts >= t0 * (1 - 1e-12))
                              & (ts <= t1 * (1 + 1e-12)))
        t = time.perf_counter()
        tr = mna.transient(rc, xs[:, rows[0]], ts[rows[-1]], ts[rows],
                           reltol=check["reltol"], t0=ts[rows[0]])
        nodes = list(rc.node_index.values())
        d = np.abs(xs[:, rows][..., nodes] - tr.xs[..., nodes]) \
            / cfg["scale_v"]
        out["wave_max"] = float(d.max()) if tr.ok else float("inf")
        out["reference_s"] = time.perf_counter() - t
        out["reference_steps"] = tr.steps
    return out


def combine(results: list) -> dict:
    """The numbers over the units: the worst of each (the median of the
    operating points' residuals beside them, as a note)."""
    out = {}
    kcl = np.concatenate([r.pop("op_kcl_lanes") for r in results])
    out["op_kcl_A"] = float(kcl.max())
    out["reference_op_kcl_median_A"] = float(np.median(kcl))
    for r in results:
        for k, v in r.items():
            if k.startswith("reference_"):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, -np.inf), v)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers with a limit;
    a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name, float("nan"))
        rows.append((name, v, lim))
        ok = ok and bool(np.isfinite(v)) and v <= lim
    return ok, rows
