"""Runs of one cell in sets, as a bound is measured: each set runs the
given seeds one after another (each run its own process), and every set
the same seeds. Prints each run's result line and, per metric and set,
the median and the spread (interquartile distance over the median, the
quartiles of `statistics.quantiles(values, n=4)`); then, per metric, the
mean over the sets of the spread with each set's run farthest from its
median left out (what a bound has to be at least twice), and the spread
of all runs together (what a bound may be at most eight times).

    python3 benchmark/tools/sets.py --workload dff_k2 --seconds 51 \
        --sets 2 --seeds 11 12 13 14 15 16 [--trace 1] [--out DIR]

Each run's stdout and stderr are kept under --out (default
build/sets of the checkout).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def trimmed(values):
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "sets"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    table = {}
    for s in range(args.sets):
        for seed in args.seeds:
            tag = f"{args.workload}.t{args.trace}.s{s}.{seed}"
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "benchmark/run.py", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True, cwd=ROOT)
            wall = time.perf_counter() - t
            (out / f"{tag}.out").write_text(p.stdout)
            (out / f"{tag}.err").write_text(p.stderr)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else "{}"
            print(json.dumps({"set": s, "seed": seed, "rc": p.returncode,
                              "wall": wall, "result": json.loads(line)}),
                  flush=True)
            if p.returncode:
                print(p.stderr[-3000:], file=sys.stderr, flush=True)
                continue
            for k, v in json.loads(line)["metrics"].items():
                table.setdefault(k, {}).setdefault(s, []).append(v["value"])
    for k, per in table.items():
        for s, vals in sorted(per.items()):
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"{k} set {s}: median {med!r} spread {sp!r} "
                      f"values {vals}", flush=True)
        sets = [v for v in per.values() if len(v) >= 3]
        if sets:
            tight = statistics.mean(spread(trimmed(v))[1] for v in sets)
            every = [x for v in per.values() for x in v]
            print(f"{k}: trimmed spread {tight!r}, all runs' spread "
                  f"{spread(every)[1]!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
