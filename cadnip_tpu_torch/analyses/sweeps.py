"""Parameter sweeps and Monte Carlo as batched solves (PyTorch port of
`cadnip_tpu/analyses/sweeps.py`).

A sweep is a table {"inst.param": values[B]}; `batch_params` turns it into
parameters with a leading lane axis on the swept leaves, and the DC chain
or the transient then runs every point at once as one batch of B lanes
(the JAX package vmaps the same solvers). On a CUDA circuit each Newton
iteration of all B lanes is one launch of kernel K1 over a grid of B
systems.

Sweep composition mirrors the reference API: Sweep (1-D), ProductSweep
(cartesian), TandemSweep (zip), SerialSweep (concat).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..config import DTYPE
from ..mna.assemble import ensure_setup
from ..mna.spec import MODE_DCOP
from ..mna.structure import CompiledCircuit
from .dc import DCSolution, _get_dc_solver, _take
from .tran import TranStats, tran


@dataclasses.dataclass(frozen=True)
class Sweep:
    """One swept parameter: Sweep('r1.r', values)."""
    name: str
    values: tuple

    def table(self):
        return {self.name: np.asarray(self.values, np.float64)}


def _merge_tables(tables, mode):
    if mode == "product":
        names, grids = [], []
        for t in tables:
            for k, v in t.items():
                names.append(k)
                grids.append(v)
        mesh = np.meshgrid(*grids, indexing="ij")
        return {k: m.reshape(-1) for k, m in zip(names, mesh)}
    if mode == "tandem":
        out = {}
        length = None
        for t in tables:
            for k, v in t.items():
                if length is None:
                    length = len(v)
                if len(v) != length:
                    raise ValueError("TandemSweep axes must share length")
                out[k] = v
        return out
    if mode == "serial":
        keys = set()
        for t in tables:
            keys |= set(t)
        out = {k: [] for k in keys}
        for t in tables:
            length = len(next(iter(t.values())))
            for k in keys:
                if k in t:
                    out[k].append(np.asarray(t[k]))
                else:
                    out[k].append(np.full(length, np.nan))
        return {k: np.concatenate(v) for k, v in out.items()}
    raise ValueError(mode)


@dataclasses.dataclass(frozen=True)
class ProductSweep:
    sweeps: tuple

    def __init__(self, *sweeps):
        object.__setattr__(self, "sweeps", tuple(sweeps))

    def table(self):
        return _merge_tables([s.table() for s in self.sweeps], "product")


@dataclasses.dataclass(frozen=True)
class TandemSweep:
    sweeps: tuple

    def __init__(self, *sweeps):
        object.__setattr__(self, "sweeps", tuple(sweeps))

    def table(self):
        return _merge_tables([s.table() for s in self.sweeps], "tandem")


@dataclasses.dataclass(frozen=True)
class SerialSweep:
    sweeps: tuple

    def __init__(self, *sweeps):
        object.__setattr__(self, "sweeps", tuple(sweeps))

    def table(self):
        return _merge_tables([s.table() for s in self.sweeps], "serial")


def _table(sweep) -> dict:
    if hasattr(sweep, "table"):
        return sweep.table()
    return {k: np.asarray(v) for k, v in sweep.items()}


def _base_value(cc: CompiledCircuit, params, name) -> float:
    """The value of 'inst.param' in params (lane 0 of a batched leaf)."""
    gi, pn, slot = cc.param_slots[name]
    holder = params[gi]
    if "." in pn:
        head, pn = pn.split(".", 1)
        holder = holder[head]
    arr = holder[pn]
    return float(arr[slot] if arr.ndim == 1 else arr[0, slot])


def batch_params(cc: CompiledCircuit, table: dict, params=None):
    """Turn {name: values[B]} into parameters whose swept leaves are
    [B, n_inst]; the other leaves (waveform tables included) stay shared.
    NaN entries (from SerialSweep) keep the base value for that point.
    The hoisted host setup of Verilog-A models runs after the batching
    (`ensure_setup`), so swept parameters re-enter it: its matrix is
    [B, n_inst, K] where a group's parameter is swept."""
    if params is None:
        params = cc.params0()
    batch = None
    over = {}
    for name, vals in table.items():
        vals = np.asarray(vals, np.float64)
        if batch is None:
            batch = len(vals)
        elif len(vals) != batch:
            raise ValueError("all sweep axes must have equal length")
        over[name] = np.where(np.isnan(vals), _base_value(cc, params, name),
                              vals)
    return ensure_setup(cc, cc.alter(params, **over))


def dcsweep(cc: CompiledCircuit, sweep, params=None, *, mode=MODE_DCOP,
            x0=None) -> DCSolution:
    """Batched DC sweep: a DCSolution whose arrays carry a leading sweep
    axis. `sweep` is a Sweep/Product/Tandem/SerialSweep or a
    {name: values} table."""
    table = _table(sweep)
    bparams = batch_params(cc, table, params)
    B = len(next(iter(table.values())))
    solver = _get_dc_solver(cc)
    x = torch.zeros((B, cc.n), dtype=DTYPE, device=cc.device)
    if x0 is not None:
        x = x + torch.as_tensor(x0, dtype=DTYPE, device=cc.device)
    dyn = cc.spec.dyn(cc.device, mode=mode)
    r = solver(x, bparams, dyn)
    conv = r.converged.cpu().numpy()
    if conv.any() and not conv.all():
        # per-lane continuation rescue (reference warm-start sweeps,
        # `src/sweeps.jl:492-532`, in batch form): rerun every lane seeded
        # from its nearest CONVERGED neighbour's solution and take the
        # result on the lanes that had failed
        lanes = np.arange(B)
        good = lanes[conv]
        nearest = good[np.argmin(np.abs(lanes[:, None] - good[None, :]),
                                 axis=1)]
        r2 = solver(r.x[torch.as_tensor(nearest, device=cc.device)],
                    bparams, dyn)
        r = _take(r, r2, take=~r.converged & r2.converged)
    sol = DCSolution(cc, r.x, r.converged, r.iters, r.resnorm,
                     params=bparams)
    sol.table = table
    return sol


def transweep(cc: CompiledCircuit, sweep, tspan, params=None, *,
              chunk: int | None = None, **tran_kw):
    """Batched transient sweep (corners / Monte Carlo): every sweep point
    integrates with its own adaptive steps, all lanes in one host loop.

    chunk: split very wide sweeps into sequential batches of this size
    (bounds device memory); the last chunk is padded by repeating the
    final point."""
    table = _table(sweep)
    n_pts = len(next(iter(table.values())))
    if chunk is not None and n_pts > chunk:
        sols = []
        for s0 in range(0, n_pts, chunk):
            sub = {k: v[s0:s0 + chunk] for k, v in table.items()}
            pad = chunk - len(next(iter(sub.values())))
            if pad:
                sub = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                       for k, v in sub.items()}
            sols.append(transweep(cc, sub, tspan, params, **tran_kw))

        def cat(get):
            return torch.cat([get(s) for s in sols])[:n_pts]

        first = sols[0]
        first.xs = cat(lambda s: s.xs)
        first.stats = TranStats(*(cat(lambda s, f=f: getattr(s.stats, f))
                                  for f in TranStats._fields))
        first.op_converged = cat(lambda s: s.op_converged)
        first.op_iters = cat(lambda s: s.op_iters)
        first.host_syncs = sum(s.host_syncs for s in sols)
        first.timings = obs.merge(s.timings for s in sols)
        first.table = table
        return first
    sol = tran(cc, tspan, params=batch_params(cc, table, params), **tran_kw)
    sol.table = table
    return sol


def montecarlo_table(cc: CompiledCircuit, spreads: dict, n: int,
                     seed: int = 0) -> dict:
    """Gaussian Monte Carlo table: spreads maps 'inst.param' -> (mean, sigma)
    or sigma (relative to the default value) — the `agauss` analogue. The
    draws are the JAX package's: one `default_rng(seed)`, names in order."""
    rng = np.random.default_rng(seed)
    table = {}
    p0 = cc.params0()
    for name, spread in spreads.items():
        if isinstance(spread, tuple):
            mean, sigma = spread
        else:
            mean = _base_value(cc, p0, name)
            sigma = spread * abs(mean)
        table[name] = rng.normal(mean, sigma, n)
    return table
