"""Parameter-static branch pruning for big VA modules.

The traced interpreter evaluates BOTH branches of every `if` and merges
with masks (va/codegen.py). For PSP/BSIM-class models most conditionals
are *parameter switches* (SWGIDL, SWIGATE, SWJUNCAP, SWNUD, NQS, TYPE...)
that are constant for a given instance — tracing their untaken branches
multiplies graph size and per-iteration cost for nothing. This module
partially evaluates a VAModule against one parameter signature: every
`if`/`case` whose guard is host-decidable from (overridden) parameters and
parameter-derived variables is replaced by its taken branch, and internal
nodes left unreferenced are dropped.

This is the compile-time counterpart of the reference's runtime branching
(Julia/`OSDI` code branches natively, `src/vasim.jl:1984-2133` hoists
allocations instead) — on TPU, structure must be static, so we specialize
per signature like node collapse (`src/vasim.jl:2723`) already does; the
decisions are keyed and cached per signature in `va_specialize`.

Like collapse, pruning parameters are effectively structural: `alter`-ing
a pruned switch after elaboration does not re-decide.
"""
from __future__ import annotations

import math

_UNK = object()      # host-unknown sentinel


def _host_call(fn, args):
    if fn == "ln":
        return math.log(args[0])
    if fn == "log" or fn == "log10":
        return math.log10(args[0])
    if fn == "limexp":
        return math.exp(min(args[0], 80.0))
    if fn == "pow":
        return args[0] ** args[1]
    if fn in ("min", "max"):
        return (min if fn == "min" else max)(*args)
    if fn == "abs":
        return abs(args[0])
    f = getattr(math, fn, None)
    if f is not None:
        return f(*args)
    return _UNK


class _Pruner:
    def __init__(self, mod, eff, max_folds=None):
        from .codegen import _VA_CONSTANTS, _host_binop
        self.mod = mod
        self.eff = eff                  # host-known effective params
        self.consts = _VA_CONSTANTS
        self.binop = _host_binop
        self.sig = []                   # decision trail, the cache key
        self.max_folds = max_folds      # debugging: fold only first N
        self.n_folds = 0

    def _may_fold(self):
        if self.max_folds is None:
            return True
        if self.n_folds >= self.max_folds:
            return False
        self.n_folds += 1
        return True

    # ------------------------------------------------------------- expr
    def ev(self, e, known):
        """Host value of an expression, or _UNK. Walks user-function call
        arguments for output-writeback side effects (name args of unknown
        calls become unknown)."""
        tag = e[0]
        if tag == "num":
            return e[1]
        if tag == "name":
            nm = e[1]
            if nm in known:
                return known[nm]
            if nm in self.eff:
                return self.eff[nm]
            if nm in self.consts:
                return self.consts[nm]
            return _UNK
        if tag == "un":
            v = self.ev(e[2], known)
            if v is _UNK:
                return _UNK
            return {"-": -v, "+": v, "!": float(v == 0),
                    "~": float(~int(v))}[e[1]]
        if tag == "bin":
            a = self.ev(e[2], known)
            b = self.ev(e[3], known)
            if a is _UNK or b is _UNK:
                # && / || short-circuit on one known side
                if e[1] == "&&" and (a == 0.0 or b == 0.0):
                    return 0.0
                if e[1] == "||" and ((a not in (_UNK, 0.0))
                                     or (b not in (_UNK, 0.0))):
                    return 1.0
                return _UNK
            try:
                return self.binop(e[1], a, b)
            except Exception:
                return _UNK
        if tag == "cond":
            c = self.ev(e[1], known)
            if c is _UNK:
                self.ev(e[2], known)
                self.ev(e[3], known)
                return _UNK
            return self.ev(e[2] if c != 0 else e[3], known)
        if tag == "call":
            fn = e[1]
            if fn in self.mod.functions:
                # user analog function: may write back to name args
                for a in e[2]:
                    if isinstance(a, tuple) and a[0] == "name":
                        known.pop(a[1], None)
                    elif isinstance(a, tuple):
                        self.ev(a, known)
                return _UNK
            args = []
            unk = False
            for a in e[2]:
                v = self.ev(a, known)
                if v is _UNK:
                    unk = True
                args.append(v)
            if unk:
                return _UNK
            try:
                return _host_call(fn, args)
            except Exception:
                return _UNK
        if tag == "sysfn":
            if e[1] == "$param_given" and e[2]:
                pn = e[2][0][1]
                return float(self.givens.get(pn, 0.0))
            return _UNK
        if tag == "index":
            return _UNK
        if tag == "acc":
            return _UNK
        return _UNK

    # ------------------------------------------------------------- stmts
    def _written(self, st, out):
        k = st[0]
        if k in ("assign", "assign_idx"):
            out.add(st[1])
        elif k == "callstmt":
            for a in st[2]:
                if isinstance(a, tuple) and a[0] == "name":
                    out.add(a[1])
        elif k == "block":
            for s in st[1]:
                self._written(s, out)
        elif k == "if":
            self._written(st[2], out)
            if st[3] is not None:
                self._written(st[3], out)
        elif k == "for":
            self._written(st[1], out)
            self._written(st[3], out)
            self._written(st[4], out)
        elif k in ("while", "repeat", "event"):
            self._written(st[-1], out)
        elif k == "case":
            for _, s in st[2]:
                self._written(s, out)

    def walk(self, st, known):
        """Returns the pruned statement (or None to drop), updating
        `known` with host-tracked variable values."""
        k = st[0]
        if k == "block":
            out = []
            for s in st[1]:
                r = self.walk(s, known)
                if r is not None:
                    out.append(r)
            return ("block", out)
        if k == "assign":
            known[st[1]] = _v = self.ev(st[2], known)
            if _v is _UNK:
                known.pop(st[1], None)
            return st
        if k == "assign_idx":
            known.pop(st[1], None)
            self.ev(st[3], known)
            return st
        if k == "if":
            c = self.ev(st[1], known)
            if c is not _UNK and not self._may_fold():
                c = _UNK
            if c is not _UNK:
                taken = st[2] if c != 0 else st[3]
                self.sig.append("1" if c != 0 else "0")
                if taken is None:
                    return None
                return self.walk(taken, known)
            self.sig.append("?")
            w = set()
            self._written(st[2], w)
            if st[3] is not None:
                self._written(st[3], w)
            kt = dict(known)
            then_p = self.walk(st[2], kt)
            ke = dict(known)
            else_p = None if st[3] is None else self.walk(st[3], ke)
            for x in w:
                tv, evv = kt.get(x, _UNK), ke.get(x, _UNK)
                if tv is not _UNK and tv == evv:
                    known[x] = tv
                else:
                    known.pop(x, None)
            if then_p is None:
                then_p = ("block", [])
            return ("if", st[1], then_p, else_p)
        if k == "case":
            sel = self.ev(st[1], known)
            if sel is not _UNK and not self._may_fold():
                sel = _UNK
            if sel is not _UNK:
                matches_known = True
                chosen = None
                for matches, body in st[2]:
                    if matches is None:
                        if chosen is None:
                            chosen = body
                        continue
                    hit = False
                    for me in matches:
                        mv = self.ev(me, known)
                        if mv is _UNK:
                            matches_known = False
                            break
                        if mv == sel:
                            hit = True
                    if not matches_known:
                        break
                    if hit:
                        chosen = body
                        break
                if matches_known:
                    self.sig.append("c")
                    if chosen is None:
                        return None
                    return self.walk(chosen, known)
            self.sig.append("?")
            w = set()
            for _, body in st[2]:
                self._written(body, w)
            out_cases = []
            for matches, body in st[2]:
                kb = dict(known)
                out_cases.append((matches, self.walk(body, kb)))
            for x in w:
                known.pop(x, None)
            return ("case", st[1], out_cases)
        if k in ("for", "while", "repeat"):
            w = set()
            self._written(st[-1], w)
            if k == "for":
                self._written(st[1], w)
                self._written(st[3], w)
            for x in w:
                known.pop(x, None)
            kb = dict(known)
            body_p = self.walk(st[-1], kb)
            if body_p is None:
                body_p = ("block", [])
            return st[:-1] + (body_p,)
        if k == "event":
            ke = dict(known)
            inner = self.walk(st[1], ke)
            w = set()
            self._written(st[1], w)
            for x in w:
                known.pop(x, None)
            return ("event", inner if inner is not None else ("block", []))
        if k == "callstmt":
            for a in st[2]:
                if isinstance(a, tuple) and a[0] == "name":
                    known.pop(a[1], None)
                elif isinstance(a, tuple):
                    self.ev(a, known)
            return st
        if k == "contrib":
            self.ev(st[3], known)
            return st
        return st


def _effective_host_params(mod, overrides):
    """Host effective parameter values (float or _UNK) for one signature:
    overridden params take their override; the rest evaluate their default
    in dependency order (UNK-safe). Mirrors the traced effective_params."""
    from .codegen import VACompiler
    # reuse the toposort from a throwaway bound method (no compiler build)
    order = VACompiler._toposort_params.__get__(
        _ModShim(mod), _ModShim)()
    givens = {}
    for nm in mod.parameters:
        g = overrides.get(nm + "__given", None)
        if g is None:
            g = 1.0 if nm in overrides else 0.0
        givens[nm] = float(g)
    eff = {}
    pr = _Pruner(mod, eff)
    pr.givens = givens
    for nm in order:
        if givens.get(nm, 0.0):
            try:
                eff[nm] = float(overrides[nm])
                continue
            except Exception:
                pass
        v = pr.ev(mod.parameters[nm].default, {})
        if v is not _UNK:
            eff[nm] = float(v)
    for alias, tgt in mod.aliases.items():
        if tgt in eff:
            eff[alias] = eff[tgt]
    return eff, givens


class _ModShim:
    """Duck-typed carrier so VACompiler._toposort_params runs standalone."""
    def __init__(self, mod):
        self.mod = mod

    def _expr_param_deps(self, e, out):
        from .codegen import VACompiler
        VACompiler._expr_param_deps(self, e, out)


def _referenced_nets(stmts, acc):
    for st in stmts:
        _nets_stmt(st, acc)


def _nets_stmt(st, acc):
    from .codegen import VACompiler
    shim = _NetWalker(acc)
    shim._walk(st)


class _NetWalker:
    def __init__(self, acc):
        self.acc = acc

    def _walk(self, st):
        k = st[0]
        if k == "contrib":
            for n in st[2]:
                self.acc.add(n)
            self._expr(st[3])
            return
        for sub in st[1:]:
            if isinstance(sub, tuple) and sub and isinstance(sub[0], str) \
                    and sub[0] in ("block", "if", "for", "while", "repeat",
                                   "case", "contrib", "assign",
                                   "assign_idx", "sys", "event",
                                   "callstmt"):
                self._walk(sub)
            elif isinstance(sub, tuple):
                self._expr(sub)
            elif isinstance(sub, list):
                for x in sub:
                    if isinstance(x, tuple) and x and \
                            isinstance(x[0], str) and x[0] in (
                                "block", "if", "contrib", "assign",
                                "callstmt", "case", "for", "while",
                                "repeat", "event", "assign_idx", "sys"):
                        self._walk(x)
                    elif isinstance(x, tuple):
                        self._expr(x)
                    elif isinstance(x, (list,)):
                        for y in x:
                            if isinstance(y, tuple):
                                if y and isinstance(y[0], str) and \
                                        y[0] == "block":
                                    self._walk(y)
                                else:
                                    self._expr(y)

    def _expr(self, e):
        if not isinstance(e, tuple):
            return
        if e[0] == "acc":
            for n in e[2]:
                self.acc.add(n)
        for sub in e[1:]:
            if isinstance(sub, tuple):
                self._expr(sub)
            elif isinstance(sub, list):
                for x in sub:
                    self._expr(x)


def prune_module(mod, overrides, max_folds=None):
    """Partially evaluate `mod` against one parameter signature.

    Returns (pruned VAModule or the original, signature string). The
    signature encodes every guard decision in walk order, so two override
    sets with identical decisions share one compiled model."""
    import os
    if os.environ.get("CADNIP_NO_PRUNE", "") == "1":
        return mod, ""
    eff, givens = _effective_host_params(mod, overrides)
    pr = _Pruner(mod, eff, max_folds=max_folds)
    pr.givens = givens
    known = {}
    # module-level initializers seed host knowledge (`real x = 2;`)
    for nm, vinfo in mod.variables.items():
        init = vinfo[2] if len(vinfo) > 2 else None
        if init is not None:
            v = pr.ev(init, {})
            if v is not _UNK:
                known[nm] = v
    out = []
    for st in mod.analog:
        r = pr.walk(st, known)
        if r is not None:
            out.append(r)
    sig = "".join(pr.sig)
    if "0" not in sig and "1" not in sig and "c" not in sig:
        return mod, sig            # nothing folded
    import copy
    mod_p = copy.copy(mod)
    mod_p.analog = out
    # drop internal nodes no longer referenced (their rows would be
    # identically zero). Named branches referencing them keep them alive
    # only if the branch itself is still referenced; analog functions may
    # touch nets too (conservatively counted).
    refs = set()
    _referenced_nets(out, refs)
    for f in mod.functions.values():
        _referenced_nets(f.body, refs)
    for bn, (p, n) in mod.branches.items():
        if bn in refs:
            refs.add(p)
            if n:
                refs.add(n)
    mod_p.internal_nodes = [n for n in mod.internal_nodes if n in refs]
    return mod_p, sig
