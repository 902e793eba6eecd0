"""Entry `vmem_tran`: one job is one seeded netlist, from its text to its
waveform on the device: `cadnip_tpu_torch.parse_spice`, then
`cadnip_tpu_torch.vmem_tran` (the DC operating point on the host loop,
then the whole transient in one launch of the fused kernel K2).

Keys of the traffic mix or the workload's `params`: tstop, dt (the
transient), pool (the draws: see `core/traffic.py`), profile (the
traced part: "job", the default, one whole further job; "given_op", the
further job's text parsed and run from the last job's operating point,
which leaves out a DC solve whose tens of thousands of launches would
take the profiler minutes to stop).

Besides each job's host wall, the entry times K2 alone: the host wall of
the port's `ops.vmem_tran.integrate` (the kernel's launch and the host
sync that ends it), from a sync before it, kept as the job's `tran_s`.
"""
from __future__ import annotations

import importlib
import time

import numpy as np

from ..core import traffic as tf


class Jobs:
    def __init__(self, ctx):
        import torch
        import cadnip_tpu_torch as ct
        self.torch, self.ct, self.ctx = torch, ct, ctx
        self.tr = ctx.traffic
        self.dev = torch.device("cuda", 0) if ctx.device is None \
            else torch.device(ctx.device)
        self.reservoir = []        # (job index, xs on the device)
        self.seen = 0
        self.m = ctx.check["jobs"]
        self.gen = tf.rng(ctx.seed, tf.CHECK_STREAM)
        self.last_x0 = None
        self.k2 = importlib.import_module("cadnip_tpu_torch.ops.vmem_tran")
        self._integrate = self.k2.integrate
        self.k2.integrate = self._timed_integrate
        self.tran_s = 0.0

    def _timed_integrate(self, S):
        self._sync()
        t = time.perf_counter()
        r = self._integrate(S)
        self._sync()
        self.tran_s += time.perf_counter() - t
        return r

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def _one(self, text, x0=None):
        t = time.perf_counter()
        cc = self.ct.parse_spice(text, device=self.dev)
        t_parse = time.perf_counter() - t
        sol = self.ct.vmem_tran(cc, (0.0, self.tr["tstop"]),
                                dt=self.tr["dt"], x0=x0)
        self._sync()
        return cc, sol, t_parse, time.perf_counter() - t

    def warm_up(self):
        self._one(tf.render(self.ctx.cfg))

    def _keep(self, k, xs):
        """Reservoir sampling: a uniform sample of m of the jobs so far,
        drawn from the seed, held on the device."""
        self.seen += 1
        if len(self.reservoir) < self.m:
            self.reservoir.append((k, xs))
            return
        j = int(self.gen.integers(0, self.seen))
        if j < self.m:
            self.reservoir[j] = (k, xs)

    def job(self, k: int) -> dict:
        text = tf.job_netlist(self.ctx.cfg, self.ctx.seed, k,
                              self.tr.get("pool"))
        t_tran = self.tran_s
        cc, sol, t_parse, wall = self._one(text)
        st = sol.stats
        ok = (bool(sol.op_converged) and not bool(st.fail)
              and bool(self.torch.isfinite(sol.xs).all()))
        self._keep(k, sol.xs)
        self.last_x0 = sol.xs[0].clone()
        cyc = sol.phase_cycles
        return {"wall": wall, "lanes": 1, "converged": int(ok),
                "parse_s": t_parse, "tran_s": self.tran_s - t_tran,
                "timings": dict(sol.timings),
                "nnewton": int(st.nnewton), "n_save": int(sol.xs.shape[0]),
                "cycles": None if cyc is None else float(sum(cyc.values())),
                "text": text, "names": dict(cc.names),
                "x0": sol.xs[0].cpu().numpy()[None],
                "final": sol.final.cpu().numpy()[None],
                "ts": np.asarray(sol.ts)}

    def profile(self) -> dict:
        text = tf.job_netlist(self.ctx.cfg, self.ctx.seed, 2 ** 40,
                              self.tr.get("pool"))
        x0 = self.last_x0 if self.tr.get("profile") == "given_op" \
            else None
        _, sol, _, _ = self._one(text, x0)
        return {"nnewton": int(sol.stats.nnewton),
                "n_save": int(sol.xs.shape[0])}

    def units(self, jobs: list) -> list:
        """The check's units: every job's operating point and final
        state, and the waveforms of the reservoir's jobs."""
        keep = dict(self.reservoir)
        out = []
        for k, rec in enumerate(jobs):
            unit = {"text": rec.pop("text"), "names": rec.pop("names"),
                    "x0": rec.pop("x0"), "final": rec.pop("final"),
                    "tstop": self.tr["tstop"]}
            ts = rec.pop("ts")
            if k in keep:
                unit.update(sampled=np.array([0]), ts=ts,
                            xs=keep[k].cpu().numpy()[None])
                w = self.ctx.check.get("window")
                if w:
                    nw = max(int(round(self.tr["tstop"] / w)), 1)
                    unit["window_start"] = w * int(self.gen.integers(nw))
            out.append(unit)
        self.reservoir = []
        self.last_x0 = None
        self.k2.integrate = self._integrate
        return out


def make(ctx):
    return Jobs(ctx)
