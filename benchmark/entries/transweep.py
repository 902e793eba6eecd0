"""Entry `transweep`: one job is one Monte Carlo sweep of the configuration
through `cadnip_tpu_torch.transweep`, all lanes in one batch on card 0.

Traffic keys: lanes, tstop, dt, n_save, max_steps (the sweep), warm_tstop
(the warm-up sweep's span: every lane's operating point and the first
passes, at the cell's own shapes), profile_tstop (the traced part: the
transient from the last sweep's operating point over [0, profile_tstop]).
"""
from __future__ import annotations

import time

import numpy as np

from ..core import traffic as tf

WARM = 2 ** 40          # the draw index of the warm-up's table


class Sweep:
    def __init__(self, ctx):
        import torch
        import cadnip_tpu_torch as ct
        self.torch, self.ct, self.ctx = torch, ct, ctx
        self.tr = ctx.traffic
        self.dev = torch.device("cuda", 0) if ctx.device is None \
            else torch.device(ctx.device)
        self.text = tf.render(ctx.cfg)
        self.cc = ct.parse_spice(self.text, device=self.dev)
        self.gen = tf.rng(ctx.seed, tf.CHECK_STREAM)
        self.last = None

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def _run(self, tab, tstop, n_save, x0=None):
        tr = self.tr
        return self.ct.transweep(self.cc, tab, (0.0, tstop), dt=tr["dt"],
                                 max_steps=tr["max_steps"], n_save=n_save,
                                 x0=x0)

    def warm_up(self):
        tab = tf.sweep_table(self.ctx.cfg, self.ctx.seed, WARM,
                             self.tr["lanes"])
        self._run(tab, self.tr["warm_tstop"], 2)
        self._sync()

    def job(self, k: int) -> dict:
        tr = self.tr
        tab = tf.sweep_table(self.ctx.cfg, self.ctx.seed, k, tr["lanes"])
        self._sync()
        t = time.perf_counter()
        sol = self._run(tab, tr["tstop"], tr["n_save"])
        self._sync()
        wall = time.perf_counter() - t
        ok = (sol.op_converged & ~sol.stats.fail
              & self.torch.isfinite(sol.xs).all(-1).all(-1))
        self.last = (tab, sol.xs[:, 0].clone())
        return {"wall": wall, "lanes": tr["lanes"],
                "converged": int(ok.sum()),
                "timings": dict(sol.timings), "host_syncs": sol.host_syncs,
                "table": tab, "sol": sol}

    def profile(self) -> dict:
        tab, x0 = self.last
        sol = self._run(tab, self.tr["profile_tstop"], 2, x0=x0)
        return {"host_syncs": sol.host_syncs}

    def units(self, jobs: list) -> list:
        """The check's units: every sweep's operating points, and the
        waveforms of the check's number of lanes of the last sweep, drawn
        from the seed."""
        m = self.ctx.check["lanes"]
        out = []
        for j, rec in enumerate(jobs):
            sol = rec.pop("sol")
            unit = {"text": self.text, "overrides": rec["table"],
                    "names": dict(self.cc.names),
                    "x0": sol.xs[:, 0].cpu().numpy()}
            if j == len(jobs) - 1:
                lanes = np.sort(self.gen.choice(
                    rec["lanes"], min(m, rec["lanes"]), replace=False))
                unit.update(sampled=lanes, tstop=self.tr["tstop"],
                            ts=np.asarray(sol.ts),
                            xs=sol.xs[self.torch.as_tensor(
                                lanes, device=sol.xs.device)].cpu().numpy())
            out.append(unit)
            del sol
        self.last = None
        return out


def make(ctx):
    return Sweep(ctx)
