#!/usr/bin/env python3
"""K2 on each member of a configuration's pool of draws, on one NVIDIA GPU.

    python3 scripts/k2_pool_draws.py [--config ekv_dff dff_gf180] [--reps 3]

Each draw's netlist (benchmark/core/traffic.py, the pool of the mix
seeded_pool8_k2, which the cells ekv_dff_k2 and dff_k2 run, every seed in
its own order) goes through `parse_spice` and `vmem_tran.prepare` (the DC
operating point on the host), then through K2 `reps` times on the same
set-up, each launch timed with CUDA events. Per draw it prints the
kernel's milliseconds, the accepted, rejected and Newton counts, and K2's
clock64 cycles per Newton iteration: all of them, and those of the largest
device group's device function (`group_cycles`). A cell's `tran_s` is the
mean of these times over the draws that its window holds.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown card"


def draws(config, reps):
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops import vmem_tran as vt
    from benchmark.core import traffic as tf

    cfg = tf.load_json("configs", config)
    pool = tf.load_json("traffic", "seeded_pool8_k2")["params"]["pool"]
    out = []
    for m in range(int(pool["size"])):
        text = tf.render(cfg, tf.draw(cfg, tf.rng(pool["seed"], m)))
        S = vt.prepare(ct.parse_spice(text, device="cuda"),
                       (0.0, cfg["tstop"]), dt=cfg["dt"])
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = vt.integrate(S)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        nn = max(int(r.stats[2]), 1)
        rec = dict(config=config, draw=m, k2_ms=ms,
                   counts=[int(v) for v in r.stats[:3]],
                   failed=int(r.stats[3]),
                   cycles_per_newton=sum(r.phases.values()) / nn,
                   group_cycles_per_newton=r.group_cycles / nn)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+", default=["ekv_dff", "dff_gf180"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    os.chdir(ROOT)   # the configurations' `.hdl` paths are the checkout's
    print(f"card: {card()}", flush=True)
    for config in args.config:
        recs = draws(config, args.reps)
        means = [sum(r["k2_ms"]) / len(r["k2_ms"]) for r in recs]
        print(f"{config}: K2 ms per draw (mean of {args.reps}) "
              + ", ".join(f"{v:.3f}" for v in means)
              + f"; spread (max - min) / mean "
              f"{(max(means) - min(means)) / (sum(means) / len(means)):.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
