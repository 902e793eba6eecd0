"""Circuit introspection: name-based queries and summaries (the
reference's `src/spc/query.jl` SpRef machinery and `circsummary`; a copy
of the JAX package's `frontend/introspect.py` that reads the solution's
device tensors through one host copy).

- `summary(cc)`: device/node/unknown breakdown text
- `query(cc, pattern)`: glob lookup over instances and nodes with
  ambiguity reporting; returns `Ref` objects that resolve against
  solutions
- `op_table(sol)`: formatted operating-point report with per-device
  terminal currents and model op-vars
"""
from __future__ import annotations

import dataclasses
import fnmatch

import numpy as np

from ..interop import to_numpy


@dataclasses.dataclass(frozen=True)
class Ref:
    """A resolved circuit reference (node / unknown / instance)."""
    kind: str          # 'node' | 'unknown' | 'instance'
    name: str
    index: int = -1    # unknown index for node/unknown refs

    def __call__(self, sol):
        """Resolve against a solution: voltage/current for nodes and
        unknowns, op-info dict for instances."""
        if self.kind in ("node", "unknown"):
            return sol[self.name]
        out = {"currents": sol.currents(self.name)}
        try:
            out["op"] = sol.op_info(self.name)
        except Exception:
            out["op"] = {}
        return out


def query(cc, pattern: str):
    """Glob lookup over node names, unknown names, and instance names.

    Returns a list of Ref. A bare name matching several namespaces
    returns all matches (the reference's SpRef ambiguity surface:
    callers disambiguate by `.kind`)."""
    pat = pattern.lower()
    out = []
    for nm, idx in sorted(cc.names.items(), key=lambda kv: kv[1]):
        if fnmatch.fnmatch(nm.lower(), pat):
            kind = "node" if nm in cc.node_names else "unknown"
            out.append(Ref(kind, nm, idx))
    for nm in sorted(cc.inst_group):
        if fnmatch.fnmatch(nm.lower(), pat):
            out.append(Ref("instance", nm))
    return out


def find(cc, name: str):
    """Exact single-match lookup; raises with candidates on ambiguity or
    a miss (reference query.jl error behavior)."""
    matches = query(cc, name)
    if len(matches) == 1:
        return matches[0]
    if not matches:
        near = [r.name for r in query(cc, f"*{name}*")][:8]
        raise KeyError(f"no node/instance named {name!r}; "
                       f"close matches: {near}")
    kinds = {m.kind for m in matches}
    if kinds == {"node", "instance"} or len(matches) > 1:
        raise KeyError(
            f"ambiguous reference {name!r}: "
            f"{[(m.kind, m.name) for m in matches]}")
    return matches[0]


def summary(cc) -> str:
    """Human-readable circuit summary (reference `circsummary`)."""
    from ..mna.devices import CLASS_I, CLASS_Q, CLASS_V
    lines = [f"circuit {cc.title!r}:"]
    n_inst = sum(g.n_inst for g in cc.groups)
    lines.append(f"  {n_inst} devices in {len(cc.groups)} vmapped groups:")
    for g in cc.groups:
        extra = ""
        if g.model.collapses:
            extra = f", {len(g.model.collapses)} collapsed nodes"
        lines.append(f"    {g.model.name:>16s} x{g.n_inst}"
                     f" ({g.model.n_local} local unknowns{extra})")
    cls = np.asarray(cc.classes)          # host numpy on every device
    lines.append(f"  {len(cc.node_names)} named nodes; {cc.n} unknowns "
                 f"({int((cls == CLASS_V).sum())} voltages, "
                 f"{int((cls == CLASS_I).sum())} branch currents, "
                 f"{int((cls == CLASS_Q).sum())} charge states)")
    if cc.bbd is not None:
        p = cc.bbd
        lines.append(f"  BBD partition: {p.K} blocks x {p.bs}, "
                     f"border {p.nb} ({100.0 * p.nb / cc.n:.1f}%)")
    else:
        lines.append("  dense solver path")
    return "\n".join(lines)


def op_table(sol, max_rows: int = 50) -> str:
    """Operating-point report: node voltages, then per-instance terminal
    currents and model op-vars (reference opinfo channel surface)."""
    cc = sol.cc
    x = to_numpy(sol.x)
    lines = ["operating point:"]
    for nm, idx in sorted(cc.node_names.items(), key=lambda kv: kv[1]):
        lines.append(f"  V({nm}) = {float(x[idx]):.6g}")
        if len(lines) > max_rows:
            lines.append("  ...")
            break
    for nm in sorted(cc.inst_group):
        gi, _ = cc.inst_group[nm]
        model = cc.groups[gi].model
        if model.opvars is None:
            continue
        try:
            op = sol.op_info(nm)
        except Exception:
            continue
        kv = ", ".join(f"{k}={v:.4g}" for k, v in list(op.items())[:6])
        lines.append(f"  {nm} ({model.name}): {kv}")
        if len(lines) > 2 * max_rows:
            lines.append("  ...")
            break
    return "\n".join(lines)
