"""Netlist dialect conversion CLI — the reference SpiceArmyKnife's
`spak-convert` entry point (`SpiceArmyKnife.jl/README.md:8-24`).

    python -m cadnip_tpu_torch.convert input.ckt --to spectre [-o out.scs]
    python -m cadnip_tpu_torch.convert input.scs --to spice
    python -m cadnip_tpu_torch.convert input.ckt --to veriloga [--module name]

Input dialect is auto-detected (SPICE vs Spectre). Targets come from
`frontend.writer.DIALECTS` plus `veriloga` (Circuit -> VA module export,
the reference's `cg_veriloga.jl` backend).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from .frontend.writer import DIALECTS, convert, to_veriloga

    ap = argparse.ArgumentParser(
        prog="cadnip-convert",
        description="Convert circuit netlists between dialects "
                    "(SPICE, Spectre, Verilog-A export).")
    ap.add_argument("input", help="input netlist file (- for stdin)")
    ap.add_argument("--to", dest="target", default="spice",
                    choices=sorted(DIALECTS) + ["veriloga"],
                    help="target dialect (default: spice)")
    ap.add_argument("-o", "--output", default="-",
                    help="output file (default: stdout)")
    ap.add_argument("--module", default=None,
                    help="module name for --to veriloga")
    args = ap.parse_args(argv)

    text = (sys.stdin.read() if args.input == "-"
            else open(args.input).read())
    if args.target == "veriloga":
        from .frontend.elaborate import elaborate_netlist
        cir, _ = elaborate_netlist(text)
        out = to_veriloga(cir, module_name=args.module)
    else:
        out = convert(text, to=args.target)
    if args.output == "-":
        sys.stdout.write(out)
    else:
        with open(args.output, "w") as fh:
            fh.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
