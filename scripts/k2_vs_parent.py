"""Kernel K2 of this tree against an earlier tree's, on one card, in turns.

    git archive <commit> cadnip_tpu_torch | tar -x -C scratch/parent
    python scripts/k2_vs_parent.py scratch/parent

Loads the earlier tree's `cadnip_tpu_torch` (under the name `parent_port`,
built from its own csrc/ into its own build/) beside this tree's, and runs
each case through both trees' `ops.vmem_tran.integrate` in turns (parent,
this tree, this tree, parent), from each tree's own set-up: the circuits of
n <= 32 over a short span (K2's warp instance), the 125-section RC ladder
(n = 127, the block instance), then the full DFF (0-600 ns at the
benchmark's 512-row chunks and in one chunk), the full graetz (0-1 s) and
the full darlington (0-1 ms). Prints, per case and tree, K2's clock64
cycles per Newton iteration by phase (the kernel's own counters, which do
not move with the card's clock), the accepted / rejected / Newton counts,
the warp-path iterations where the tree reports them, and the host wall of
`integrate` (argument packing, the launch and the sync that ends it), then
the card's name and power limit and a JSON line of the rows. Needs a CUDA
card.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_parent(path):
    root = os.path.join(os.path.abspath(path), "cadnip_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return mod


def cases(ct):
    """(name, netlist, span, dt, rows_per_chunk)"""
    import chip_smoke
    from cadnip_tpu_torch.models.vacask import DARLINGTON, GRAETZ, MUL
    from cadnip_tpu_torch.models.vacask import RC_NETLIST
    dff = ct.dff_netlist()
    return [("rc", RC_NETLIST, (0, 4e-3), 8e-6, 512),
            ("graetz", GRAETZ, (0, 2e-2), 1e-4, 512),
            ("mul", MUL, (0, 5e-6), 1e-8, 512),
            ("dff", dff, (0, 6e-8), 3.333e-10, 512),
            ("darlington", DARLINGTON, (0, 1e-6), 2e-9, 512),
            ("lkefgh", chip_smoke.LKEFGH, (0, 2.5e-7), 2e-9, 512),
            ("ladder", chip_smoke.rc_ladder(125), (0, 5e-6), 2e-7, 512),
            ("dff full", dff, (0, 6e-7), 3.333e-10, 512),
            ("dff full, one chunk", dff, (0, 6e-7), 3.333e-10, 2048),
            ("graetz full", GRAETZ, (0, 1.0), 1e-6, 512),
            ("darlington full", DARLINGTON, (0, 1e-3), 2e-9, 512)]


def run(pkg, mod, torch, net, span, dt, rc):
    S = mod.prepare(pkg.parse_spice(net, device="cuda"), span, dt=dt,
                    rows_per_chunk=rc)
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = mod.integrate(S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    nn = max(int(r.stats[2]), 1)
    return dict(n=S.cc.n, counts=[int(v) for v in r.stats[:4]],
                cycles={k: v / nn for k, v in r.phases.items()},
                cycles_per_newton=sum(r.phases.values()) / nn,
                warp_iterations=getattr(r, "warp_iterations", None),
                wall_ms=wall * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", help="a directory holding the earlier tree's "
                    "cadnip_tpu_torch/")
    ap.add_argument("--only", nargs="*", help="case names to run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_vs_parent: needs a CUDA card")
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops import vmem_tran as vt
    parent = load_parent(args.parent)
    import parent_port.ops.vmem_tran as pvt
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows = []
    for name, net, span, dt, rc in cases(ct):
        if args.only and name not in args.only:
            continue
        runs = {"parent": [], "this": []}
        for tree, pkg, mod in (("parent", parent, pvt), ("this", ct, vt),
                               ("this", ct, vt), ("parent", parent, pvt)):
            runs[tree].append(run(pkg, mod, torch, net, span, dt, rc))
        row = dict(case=name, span=list(span), dt=dt, rows_per_chunk=rc,
                   **runs)
        rows.append(row)
        for tree in ("parent", "this"):
            a, b = runs[tree]
            print(f"K2 {name} (n = {a['n']}) {tree}: "
                  f"{a['cycles_per_newton']:.0f} / "
                  f"{b['cycles_per_newton']:.0f} cycles per Newton iteration"
                  f", counts {a['counts']}, warp iterations "
                  f"{a['warp_iterations']}, integrate {a['wall_ms']:.2f} / "
                  f"{b['wall_ms']:.2f} ms; phases "
                  + ", ".join(f"{k} {v:.0f}" for k, v in a["cycles"].items()),
                  flush=True)
    print(card)
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
