"""Where the host time of K1's derivative rules goes, on one card.

    python scripts/k1_rules_profile.py                    # this tree
    python scripts/k1_rules_profile.py scratch/parent     # and an earlier one

Times `torch.func.jvp` and `torch.func.vjp` (forward and pullback) of
`gj_solve` at n = 19, k = 1, b = 1 and b = 4096 (chip_smoke.py phase 3b's
shapes) by CUDA events over a loop, then runs the same calls with the
tree's functions wrapped in host timers and splits the wall into: the
kernel launches (`launch` and the rule entries' `_launch_rule`, ctypes and
the output's allocation included), a rule's re-entry into `GJSolve.apply`
(its crossing, without the launch inside it), the rules' own work around
the kernel (their torch operations: `zeros_like`, the products,
`contiguous`, the subtraction), and the rest: functorch's dispatch and the
transform itself (the door). With a directory, that tree's
`cadnip_tpu_torch` (loaded as in scripts/k1_grid_vs_parent.py) is split the
same way, in turns with this tree's (earlier, this, this, earlier). Prints
one line per tree, rule and shape, the card's name and power limit, and a
JSON line. Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CALLS = 200


def cuda_ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split(K1, fn, reps=CALLS):
    """The host wall of reps calls of fn, with the tree K1's launches,
    rules and crossings timed: (wall, {launch, re-entry, rule ops, door})
    in seconds per call."""
    import torch
    G = K1.GJSolve
    T = dict(launch=0.0, rule=0.0, reent=0.0, reent_launch=0.0,
             rule_launch=0.0)
    depth = [0]
    saved = {}

    def timed(fn_, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn_(*a, **k)
            finally:
                T[key] += time.perf_counter() - t
        return run

    def rule(fn_):
        def run(*a):
            depth[0] += 1
            l0, t = T["launch"], time.perf_counter()
            try:
                return fn_(*a)
            finally:
                T["rule"] += time.perf_counter() - t
                T["rule_launch"] += T["launch"] - l0
                depth[0] -= 1
        return staticmethod(run)

    apply = G.apply.__func__

    def crossing(cls, *a):
        if not depth[0]:
            return apply(cls, *a)
        l0, t = T["launch"], time.perf_counter()
        try:
            return apply(cls, *a)
        finally:
            T["reent"] += time.perf_counter() - t
            T["reent_launch"] += T["launch"] - l0

    for name in ("launch", "_launch_rule"):
        if hasattr(K1, name):
            saved[(K1, name)] = getattr(K1, name)
            setattr(K1, name, timed(getattr(K1, name), "launch"))
    for name in ("jvp", "backward"):
        saved[(G, name)] = G.__dict__[name]
        setattr(G, name, rule(getattr(G, name)))
    saved[(G, "apply")] = G.__dict__.get("apply")
    G.apply = classmethod(crossing)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        for (obj, name), v in saved.items():
            if v is None:
                delattr(obj, name)
            else:
                setattr(obj, name, v)
    reent = T["reent"] - T["reent_launch"]
    ops = T["rule"] - T["reent"] - (T["rule_launch"] - T["reent_launch"])
    parts = {"launch": T["launch"], "re-entry": reent, "rule ops": ops,
             "door": wall - T["launch"] - reent - ops}
    return wall / reps, {k: v / reps for k, v in parts.items()}


def rows_for(K1, label):
    import torch
    from torch.func import jvp, vjp
    out = []
    for b in (1, 4096):
        n, k = 19, 1
        rng = np.random.default_rng(5)
        A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        A[:, [5, 6]] = A[:, [6, 5]]
        At, dAt = (torch.as_tensor(a, device="cuda")
                   for a in (A, rng.standard_normal((b, n, n))))
        Bt, dBt, gXt = (torch.as_tensor(rng.standard_normal((b, n, k)),
                                        device="cuda") for _ in range(3))
        runs = {"jvp": lambda: jvp(K1.gj_solve, (At, Bt), (dAt, dBt))[1],
                "vjp": lambda: vjp(K1.gj_solve, At, Bt)[1](gXt)}
        for rule, fn in runs.items():
            ms = cuda_ms(fn, 100 if b == 1 else 30)
            wall, sh = split(K1, fn)
            out.append(dict(tree=label, rule=rule, shape=[b, n, n + k],
                            us=ms * 1e3, timed_us=wall * 1e6,
                            split_us={k_: v * 1e6 for k_, v in sh.items()}))
            print(f"{label} {rule} [{b}, {n}, {n}+{k}]: {ms * 1e3:.1f} us "
                  f"(events); with host timers {wall * 1e6:.1f} us = "
                  + ", ".join(f"{k_} {v * 1e6:.1f}" for k_, v in sh.items()),
                  flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", nargs="?", help="a directory holding an "
                    "earlier tree's cadnip_tpu_torch/")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k1_rules_profile: needs a CUDA card")
    from cadnip_tpu_torch.ops import gj_solve as K1
    K1.load_library()
    trees = [("this", K1)]
    if args.parent:
        from k1_grid_vs_parent import load_parent
        parent = load_parent(args.parent)
        trees = [("parent", parent), ("this", K1), ("this", K1),
                 ("parent", parent)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows = []
    for label, mod in trees:
        rows += rows_for(mod, label)
    print(card)
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
