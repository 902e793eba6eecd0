"""Parameter sweeps split over several devices (PyTorch port of
`cadnip_tpu/parallel/mesh.py`).

A circuit solve is sequential, but sweep points are independent: the
sweep's table is padded to a multiple of the mesh size (repeating the
last point), cut into contiguous shards, one per mesh entry, and each
shard runs the batched solver on its device. Nothing is exchanged inside
a solve; the results are gathered onto the circuit's device at the end,
the padding dropped.

The mesh is a tuple of torch devices (`sweep_mesh`); an entry may repeat
a device, and shards on one device run one after another. Each distinct
device gets its own copy of the compiled circuit (the structure is host
data, so the copy is the same circuit with that device and an empty
cache) and its own host thread, so that the work of several cards
overlaps. Every lane steps on its own and K1 solves each lane's system
alone, so a lane of a sharded run takes the unsharded run's steps on the
same device type. Its values equal the unsharded run's bit for bit
wherever no kernel on the path rounds by the batch's size; on the CPU the
DFF's lanes part in the last bits from its latch edge on (1.1e-11 V over
16 lanes in two shards, at equal counts).

The JAX package partitions one jitted program with GSPMD over a
`jax.sharding.Mesh`; its sharded DC sweep, like this one, has no
neighbour rescue (the port's `dcsweep` has).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from .. import obs
from ..config import DTYPE, resolve_device
from ..mna.structure import CompiledCircuit
from ..analyses.dc import DCSolution, _get_dc_solver
from ..analyses.sweeps import _table, batch_params
from ..analyses.tran import TranStats, tran


def _norm(device) -> torch.device:
    """A torch device with its index: "cuda" names the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sweep_mesh(devices=None) -> tuple:
    """The devices a sweep is split over: every card of
    `torch.cuda.device_count()` by default (raises without one), else the
    given devices in order, repeats allowed (("cpu",) * 3 gives three
    shards on the host)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("sweep_mesh: no CUDA device is available; "
                               "pass the devices, e.g. (\"cpu\",) * 2")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(_norm(d) for d in devices)
    if not mesh:
        raise ValueError("sweep_mesh: the mesh needs at least one device")
    return mesh


def _pad_batch(table: dict, n_dev: int):
    """Pad every sweep axis to a multiple of the device count (extra points
    repeat the last value and are dropped from the result)."""
    b = len(next(iter(table.values())))
    pad = (-b) % n_dev
    if pad == 0:
        return table, b
    return {k: np.concatenate([v, np.repeat(v[-1:], pad)])
            for k, v in table.items()}, b


def _to(tree, dev):
    """A parameter list (lists and dicts of tensors) on `dev`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


def _on(cc: CompiledCircuit, dev: torch.device) -> CompiledCircuit:
    """cc compiled for `dev`: cc itself on its own device, else a copy
    with that device and a cache of its own (kept in cc's cache)."""
    if dev == _norm(cc.device):
        return cc
    key = ("mesh_copy", str(dev))
    if key not in cc.cache:
        cc.cache[key] = dataclasses.replace(cc, device=dev, cache={})
    return cc.cache[key]


def _run_shards(cc, mesh, table, params, run):
    """Split the padded table into len(mesh) contiguous shards and return
    run(shard_cc, shard_params) of each, in mesh order: the shards of one
    device one after another, each distinct device on a host thread of
    its own."""
    n_dev = len(mesh)
    size = len(next(iter(table.values()))) // n_dev
    jobs = {}
    for i, dev in enumerate(mesh):
        sub = {k: v[i * size:(i + 1) * size] for k, v in table.items()}
        jobs.setdefault(dev, []).append((i, sub))

    def device_work(dev):
        # a kernel launches on its host thread's current card
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            scc = _on(cc, dev)
            p = None if params is None else _to(params, dev)
            return [(i, run(scc, batch_params(scc, sub, p)))
                    for i, sub in jobs[dev]]

    if len(jobs) == 1:
        done = device_work(mesh[0])
    else:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = [pool.submit(device_work, dev) for dev in jobs]
            done = [r for f in futures for r in f.result()]
    return [r for _, r in sorted(done, key=lambda ir: ir[0])]


def _gather(cc, parts, n_real):
    """The lanes of every shard, in order, on cc's device, without the
    padding."""
    return torch.cat([p.to(cc.device) for p in parts])[:n_real]


def sharded_dcsweep(cc: CompiledCircuit, sweep, params=None, *, mesh=None,
                    x0=None) -> DCSolution:
    """dcsweep with the lanes split over `mesh` (default `sweep_mesh()`):
    the plain DC chain (`make_dc_solver`) per shard, without dcsweep's
    neighbour rescue."""
    table = _table(sweep)
    mesh = sweep_mesh(mesh)
    table, n_real = _pad_batch(table, len(mesh))
    size = len(next(iter(table.values()))) // len(mesh)

    def run(scc, bparams):
        x = torch.zeros((size, scc.n), dtype=DTYPE, device=scc.device)
        if x0 is not None:
            x = x + torch.as_tensor(x0, dtype=DTYPE, device=scc.device)
        return _get_dc_solver(scc)(x, bparams, scc.spec.dyn(scc.device))

    rs = _run_shards(cc, mesh, table, params, run)
    sol = DCSolution(cc, *(_gather(cc, [getattr(r, f) for r in rs], n_real)
                           for f in ("x", "converged", "iters", "resnorm")))
    sol.table = {k: v[:n_real] for k, v in table.items()}
    return sol


def sharded_transweep(cc: CompiledCircuit, sweep, tspan, params=None, *,
                      mesh=None, **tran_kw):
    """transweep with the lanes split over `mesh` (default `sweep_mesh()`):
    `tran` per shard with the shard's batched parameters. The waveforms,
    stats, operating points and traces are gathered per lane;
    `host_syncs` and `timings` are summed over the shards."""
    table = _table(sweep)
    mesh = sweep_mesh(mesh)
    table, n_real = _pad_batch(table, len(mesh))
    sols = _run_shards(
        cc, mesh, table, params,
        lambda scc, bparams: tran(scc, tspan, params=bparams, **tran_kw))

    def cat(get):
        return _gather(cc, [get(s) for s in sols], n_real)

    sol = sols[0]
    sol.cc = cc
    sol.xs = cat(lambda s: s.xs)
    sol.stats = TranStats(*(cat(lambda s, f=f: getattr(s.stats, f))
                            for f in TranStats._fields))
    sol.op_converged = cat(lambda s: s.op_converged)
    sol.op_iters = cat(lambda s: s.op_iters)
    if sol.trace is not None:
        sol.trace = (cat(lambda s: s.trace[0]), cat(lambda s: s.trace[1]))
    sol.host_syncs = sum(s.host_syncs for s in sols)
    sol.timings = obs.merge(s.timings for s in sols)
    sol.table = {k: v[:n_real] for k, v in table.items()}
    return sol
