"""The lower-precision control: the plain reference computed in float32
(the configuration states float64), put in the program's place and judged
by the same comparison as the program. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--jobs J]

prints, per seed, each compared number beside its limit and the verdict,
as JSON lines. A sweep cell's control solves every lane's operating point
(its own DC solve in float32) and integrates the lanes the check samples;
a job cell's control runs J seeded jobs (default: the check's sample
size). The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import check as chk  # noqa: E402
from benchmark.core import traffic as tf  # noqa: E402
from benchmark.reference import mna, netlist  # noqa: E402

def _unit(text, overrides, lanes_total, tstop, ts, sampled, reltol,
          with_final):
    net = netlist.parse(text)
    cir = mna.Circuit(net, lanes_total, overrides, dtype=np.float32)
    x0, conv = mna.operating_point(cir)
    unit = {"text": text, "overrides": overrides, "names": chk.port_names(cir),
            "x0": x0.astype(np.float64), "tstop": tstop}
    ok = bool(conv.all())
    if sampled is not None:
        sub = {k: np.asarray(v)[sampled] for k, v in (overrides or {}).items()}
        rc = mna.Circuit(net, len(sampled), sub, dtype=np.float32)
        tr = mna.transient(rc, x0[sampled], tstop, ts, reltol=reltol)
        ok = ok and tr.ok
        unit.update(sampled=np.asarray(sampled), ts=ts,
                    xs=tr.xs.astype(np.float64))
        if with_final:
            unit["final"] = tr.final.astype(np.float64)
    return unit, ok


def control(cell: str, seed: int, jobs: int | None = None,
            params: dict | None = None) -> dict:
    """The control's numbers, limits and verdict for one seed."""
    wl = tf.load_json("workloads", cell)
    cfg = tf.load_json("configs", wl["config"])
    mix = tf.load_json("traffic", wl["traffic"])
    p = {"tstop": cfg["tstop"], "dt": cfg["dt"], **mix["params"],
         **(params or {})}
    chkw = wl["check"]
    units, failed = [], 0
    if mix["entry"] == "transweep":
        tab = tf.sweep_table(cfg, seed, 0, p["lanes"])
        gen = tf.rng(seed, tf.CHECK_STREAM)
        m = min(chkw["lanes"], p["lanes"])
        lanes = np.sort(gen.choice(p["lanes"], m, replace=False))
        ts = np.linspace(0.0, p["tstop"], p["n_save"])
        u, ok = _unit(tf.render(cfg), tab, p["lanes"], p["tstop"], ts,
                      lanes, chkw["reltol"], False)
        units.append(u)
        failed += not ok
    else:
        n_save = int(round(p["tstop"] / p["dt"])) + 1
        ts = np.linspace(0.0, p["tstop"], n_save)
        gen = tf.rng(seed, tf.CHECK_STREAM)
        for k in range(jobs or chkw["jobs"]):
            u, ok = _unit(tf.job_netlist(cfg, seed, k),
                          None, 1, p["tstop"], ts, [0], chkw["reltol"], True)
            w = chkw.get("window")
            if w:
                nw = max(int(round(p["tstop"] / w)), 1)
                u["window_start"] = w * int(gen.integers(nw))
            units.append(u)
            failed += not ok
    numbers = chk.combine([chk.judge(u, cfg, chkw) for u in units])
    correct, rows = chk.verdict(numbers, chkw["limits"])
    return {"cell": cell, "seed": seed, "failed": failed,
            "correct": bool(correct and failed == 0),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in rows}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=None)
    args = ap.parse_args(argv)
    for s in args.seed:
        print(json.dumps(control(args.workload, s, args.jobs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
