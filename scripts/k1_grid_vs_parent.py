"""K1's block and grid variants against an earlier tree's, on one card, in
turns.

    git archive <commit> cadnip_tpu_torch | tar -x -C scratch/parent
    python scripts/k1_grid_vs_parent.py scratch/parent
    python scripts/k1_grid_vs_parent.py scratch/parent --rules-only

Loads the earlier tree's `cadnip_tpu_torch` (under the name `parent_port`,
built from its own csrc/ into its own build/) beside this tree's, and times
`gj_solve` of both: at the shapes one block's shared memory holds (the
DFF's AC sweep [801, 38, 39], the nested BBD level's block solves [10,
104, 190], [64, 128, 129], [1, 160, 161] and [1, 167, 168]), where this
tree's block and grid variants are also timed forced; and at the grid
variant's shapes on the main paths: the 125-section ladder's AC sweep
[801, 254, 255], the power grid's Schur solve [1, 973, 974] and its
nested level's [1, 241, 242], and [1, 1024, 1025], [1, 512, 513], [1,
1536, 1537] (the BBD threshold) and [1, 1900, 1901] (the panel in L2).
Each shape is timed parent, this tree, this tree, parent (CUDA events over
a loop of launches, after a warm-up), beside `torch.linalg.solve_ex` and
the bound (bytes once in, once out over 3.35 TB/s, or an LU solve's
2n^3/3 + 2n^2 k operations over 67 TFLOP/s f64, the larger). Checks this
tree's result against its blocked plain twin, and counts its launches (one
per call). Then kernel K2 of both trees, in the same turns, on
chip_smoke.py's phase-6 circuits (the 125-section RC ladder, whose Newton
solve is K1's block form, and the DFF, graetz and the darlington, whose
is the warp form): cycles per Newton iteration and step counts. Then K1's
derivative rules of both trees in the same turns: `torch.func.jvp` and
`torch.func.vjp` (forward and pullback) of `gj_solve` at chip_smoke.py
phase 3b's shapes (n = 19, k = 1, b = 1 and 4096) beside the same calls
on `torch.linalg.solve`, and phase 11's `torch.func.jacfwd` through
`tran()` of an RC (wall and K1 launches). `--rules-only` runs the rules
alone. Prints one line per shape and circuit, the card's name and power
limit, and a JSON line of the rows. Needs a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: (batch, n, k, what): the shapes one block holds, then the grid variant's
#: shapes on the main paths
SHAPES = [(801, 38, 1, "DFF AC and noise sweeps (phases 8c, 12)"),
          (10, 104, 86, "nested BBD block solves (phase 15)"),
          (64, 128, 1, "no path"),
          (1, 160, 1, "no path"),
          (1, 167, 1, "the largest system one block holds, no path"),
          (801, 254, 1, "ladder AC sweep (phase 8c)"),
          (1, 973, 1, "power grid Schur solve (phase 15)"),
          (1, 241, 1, "nested Schur solve (phase 15)"),
          (1, 1024, 1, "gjpl32ir ceiling, no path"),
          (1, 512, 1, "no path"),
          (1, 1536, 1, "the BBD threshold, no path"),
          (1, 1900, 1, "beyond the owner's shared memory: the panel in L2")]
HBM_BYTES_PER_S, F64_FLOPS = 3.35e12, 67e12


def load_parent(path):
    root = os.path.join(os.path.abspath(path), "cadnip_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    import parent_port.ops.gj_solve as parent
    parent.load_library()
    return parent


def cuda_ms(fn, reps):
    import torch
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(b, n, k):
    t_bytes = 8 * b * (n * n + 2 * n * k) / HBM_BYTES_PER_S
    t_ops = b * (2 * n ** 3 / 3 + 2 * n * n * k) / F64_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", help="a directory holding the earlier tree's "
                    "cadnip_tpu_torch/")
    ap.add_argument("--rules-only", action="store_true",
                    help="time the derivative rules only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k1_grid_vs_parent: needs a CUDA card")
    from cadnip_tpu_torch.ops import gj_solve as K1
    K1.load_library()
    parent = load_parent(args.parent)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows = []
    for b, n, k, what in ([] if args.rules_only else SHAPES):
        rng = np.random.default_rng(n)
        A = torch.as_tensor(rng.standard_normal((b, n, n)) / np.sqrt(n)
                            + 2.0 * np.eye(n), device="cuda")
        B = torch.as_tensor(rng.standard_normal((b, n, k)), device="cuda")
        in_block = K1.block_bytes(n, k) <= K1.MAX_SMEM
        before = K1.gj_solve.launches
        X = K1.gj_solve(A, B)
        launches = K1.gj_solve.launches - before
        Xp = K1.gj_solve_blocked_plain(A, B)
        err = float((X - Xp).abs().max() / Xp.abs().max())
        if not err <= 1e-10:
            raise SystemExit(f"[{b}, {n}, {n}+{k}]: {err:.3e} from the twin")
        reps = 3 if b * n * n > 3e7 else 10
        old = [cuda_ms(lambda: parent.gj_solve(A, B), reps)]
        new = [cuda_ms(lambda: K1.gj_solve(A, B), reps) for _ in range(2)]
        old.append(cuda_ms(lambda: parent.gj_solve(A, B), reps))
        lib = cuda_ms(lambda: torch.linalg.solve_ex(A, B), reps)
        forced = {w: cuda_ms(lambda: K1.launch(A, B, w), reps) * 1e3
                  for w in (("block", "grid") if in_block else ())}
        bms, by = bound_ms(b, n, k)
        which = K1.variant(n, k, 8, b)
        plan = (K1.block_plan(b, n, k) if which == "block"
                else K1.grid_plan(A, B)[:3])
        row = dict(shape=[b, n, n + k], what=what, variant=which, plan=plan,
                   parent_us=[t * 1e3 for t in old],
                   new_us=[t * 1e3 for t in new], forced_us=forced,
                   solve_ex_us=lib * 1e3, bound_us=bms * 1e3, bound_by=by,
                   launches_per_call=launches, err=err,
                   no_slower_than_solve_ex=max(new) <= lib)
        rows.append(row)
        extra = "".join(f", {w} forced {t:.1f} us" for w, t in forced.items())
        print(f"[{b}, {n}, {n}+{k}] {what}: {which} variant, plan {plan}; "
              f"parent {old[0] * 1e3:.1f} / {old[1] * 1e3:.1f} us, this tree "
              f"{new[0] * 1e3:.1f} / {new[1] * 1e3:.1f} us{extra}, solve_ex "
              f"{lib * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by}); "
              f"{launches} launch per call; vs twin {err:.2e}", flush=True)
    k2 = [] if args.rules_only else k2_rows(parent)
    rules = rule_rows(K1, parent)
    print(card)
    print(json.dumps({"card": card, "rows": rows, "k2": k2,
                      "rules": rules}))


def rule_rows(K1, parent):
    """K1's jvp and vjp rules of both trees, in turns, at n = 19, k = 1,
    b = 1 and 4096, beside torch.func on torch.linalg.solve; then phase
    11's jacfwd through tran() of an RC in both trees."""
    import torch
    from torch.func import jvp, vjp
    import cadnip_tpu_torch as ct
    import parent_port
    rows = []
    for b in (1, 4096):
        n, k = 19, 1
        rng = np.random.default_rng(5)
        A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        A[:, [5, 6]] = A[:, [6, 5]]
        At, dAt = (torch.as_tensor(a, device="cuda")
                   for a in (A, rng.standard_normal((b, n, n))))
        Bt, dBt, gXt = (torch.as_tensor(rng.standard_normal((b, n, k)),
                                        device="cuda") for _ in range(3))
        reps = 100 if b == 1 else 30

        def run(rule, solve):
            if rule == "jvp":
                return lambda: jvp(solve, (At, Bt), (dAt, dBt))[1]
            return lambda: vjp(solve, At, Bt)[1](gXt)

        for rule in ("jvp", "vjp"):
            got = run(rule, K1.gj_solve)()
            ref = run(rule, torch.linalg.solve)()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max(float((a - c).abs().max() / c.abs().max())
                      for a, c in zip(got, ref))
            old = [cuda_ms(run(rule, parent.gj_solve), reps)]
            new = [cuda_ms(run(rule, K1.gj_solve), reps) for _ in range(2)]
            old.append(cuda_ms(run(rule, parent.gj_solve), reps))
            lib = cuda_ms(run(rule, torch.linalg.solve), reps)
            row = dict(rule=rule, shape=[b, n, n + k],
                       parent_us=[t * 1e3 for t in old],
                       new_us=[t * 1e3 for t in new], library_us=lib * 1e3,
                       speedup=min(old) / max(new),
                       no_slower_than_library=max(new) <= lib,
                       err_vs_library=err)
            rows.append(row)
            print(f"K1 {rule} rule [{b}, {n}, {n}+{k}]: parent "
                  f"{old[0] * 1e3:.1f} / {old[1] * 1e3:.1f} us, this tree "
                  f"{new[0] * 1e3:.1f} / {new[1] * 1e3:.1f} us "
                  f"({row['speedup']:.2f}x), torch.func on "
                  f"torch.linalg.solve {lib * 1e3:.1f} us; against it "
                  f"{err:.1e}", flush=True)
    walls = {}
    for tree, pkg, mod in (("parent", parent_port, parent),
                           ("this", ct, K1), ("this", ct, K1),
                           ("parent", parent_port, parent)):
        walls.setdefault(tree, []).append(rc_jacfwd(pkg, mod))
    row = dict(rule="jacfwd through tran() of an RC (phase 11)",
               parent_s=[w for w, _ in walls["parent"]],
               new_s=[w for w, _ in walls["this"]],
               parent_launches=walls["parent"][0][1],
               launches=walls["this"][0][1])
    rows.append(row)
    print(f"jacfwd through tran() RC: parent {row['parent_s'][0]:.3f} / "
          f"{row['parent_s'][1]:.3f} s ({row['parent_launches']} K1 "
          f"launches), this tree {row['new_s'][0]:.3f} / "
          f"{row['new_s'][1]:.3f} s ({row['launches']})", flush=True)
    return rows


def rc_jacfwd(pkg, K1):
    """chip_smoke.py phase 11's jacfwd through tran() of an RC with the
    package `pkg` (K1 its gj_solve module): (wall in s, K1 launches)."""
    import time
    import torch
    cir = pkg.Circuit("sens")
    cir.V("vs", "in", "0", wave=pkg.Pulse(0.0, 1.0, tr=1e-9))
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-6)
    cc = cir.compile(device="cuda")

    def vout(r):
        p = cc.alter(cc.params0(), **{"r1.r": r})
        sol = pkg.tran(cc, (0, 1e-3), params=p, dt=1e-5, n_save=11)
        return sol.xs[-1, cc.index_of("out")]

    r0 = torch.tensor(1e3, dtype=torch.float64, device="cuda")
    torch.func.jacfwd(vout)(r0)
    torch.cuda.synchronize()
    K1.gj_solve.launches = 0
    t = time.perf_counter()
    torch.func.jacfwd(vout)(r0)
    torch.cuda.synchronize()
    return time.perf_counter() - t, K1.gj_solve.launches


#: K2's cases (chip_smoke.py phase 6): the 125-section RC ladder takes the
#: block solve, the others the warp solve
K2_CASES = (("ladder", (0, 5e-6), 2e-7), ("dff", (0, 6e-8), 3.333e-10),
            ("graetz", (0, 2e-2), 1e-4), ("darlington", (0, 1e-6), 2e-9))


def k2_rows(parent):
    """K2 of both trees on each K2_CASES circuit, in turns (parent, this
    tree, this tree, parent): clock64 cycles per Newton iteration (the
    kernel's own phase counters, which do not move with the card's clock)
    and the step counts."""
    import chip_smoke
    import cadnip_tpu_torch as ct
    import parent_port
    from cadnip_tpu_torch.models.vacask import DARLINGTON, GRAETZ
    from cadnip_tpu_torch.ops import vmem_tran as vt
    import parent_port.ops.vmem_tran as pvt
    nets = {"ladder": chip_smoke.rc_ladder(125), "dff": ct.dff_netlist(),
            "graetz": GRAETZ, "darlington": DARLINGTON}
    rows = []
    for name, span, dt in K2_CASES:
        runs = {}
        for tree, pkg, mod in (("parent", parent_port, pvt),
                               ("this", ct, vt), ("this", ct, vt),
                               ("parent", parent_port, pvt)):
            S = mod.prepare(pkg.parse_spice(nets[name], device="cuda"), span,
                            dt=dt)
            r = mod.integrate(S)
            nn = int(r.stats[2])
            runs.setdefault(tree, []).append(
                (sum(r.phases.values()) / max(nn, 1),
                 tuple(int(v) for v in r.stats[:3])))
        row = dict(circuit=name, n=S.cc.n,
                   parent_cycles=[c for c, _ in runs["parent"]],
                   cycles=[c for c, _ in runs["this"]],
                   parent_counts=runs["parent"][0][1],
                   counts=runs["this"][0][1])
        rows.append(row)
        print(f"K2 {name} (n = {row['n']}): cycles per Newton iteration "
              f"parent {row['parent_cycles'][0]:.0f} / "
              f"{row['parent_cycles'][1]:.0f}, this tree "
              f"{row['cycles'][0]:.0f} / {row['cycles'][1]:.0f}; accepted, "
              f"rejected, newton parent {row['parent_counts']}, this tree "
              f"{row['counts']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
