"""Netlist elaboration: card AST -> `Circuit` + analysis cards (PyTorch
port of `cadnip_tpu/frontend/elaborate.py`).

Parameter dependency toposort, subcircuit expansion (instance line
outranks subckt default; expressions see the instantiating scope),
case-insensitive model/param resolution with most-recent-wins, `.lib`
sections, `.include` files, `.if/.else` blocks, `.global` nodes and
`.option`/`.temp` into the SimSpec. Hierarchy is flattened host-side with
dotted names (`x1.m2`, `x1.net5`). All of it is pure Python, copied from
the JAX package.

The elements: R, C, L, K (mutual inductance, m = k*sqrt(L1*L2) resolved
after the whole netlist), V, I, E, G, F, H (the current-controlled ones
sense a V source or inductor by name, before or after them in the deck,
with the subcircuit prefix), D, Q (npn/pnp cards) and M (level 1), and X.

Verilog-A: `.hdl "file.va"` (or `ahdl_include`, or the `hdl=` argument of
`parse_spice`) compiles the file's modules into the scope. A module is
instantiated by an N or Y element, by an X line naming it, or by a D, M,
Q, J or Z line whose `.model` card has the module's name as its type
(tier 2, most recent wins). A card of another level, or any card under
`.option vamodels`, resolves through the tier-1 registry
(`models/registry.py`), which needs the VA model files. Instance and card
parameters map case-insensitively, set the `__given` mask, and pick the
model's per-signature specialization (node collapse).

Behavioral B-sources (`b1 out 0 v={...}` or `i={...}`) become one-off
DeviceModels whose residual evaluates the expression on tensors
(`expressions.eval_expr_traced`): v() of any node, i() of a V source or
inductor (sensed by name) and `time`. `.data` tables and `.meas` cards are
kept on the Elaborator (`data_tables`, `meas_cards`), and `simulate` runs
a deck's analysis cards (.op, .tran, .ac, .dc, .dc data=, .noise) and
then its `.meas` cards.

Spectre: a deck is sniffed (`spectre.looks_like_spectre`, or
`dialect="spectre"`) and parsed by `spectre.parse_spectre` into the same
card AST; an included file is sniffed on its own (`_parse_file`). Spectre
numbers are case-sensitive (M is mega), `[...]` vectors become tuples,
`real f(...) { return ...; }` declares a netlist function, and an
instance `name (nodes) master p=v` names a primitive (resistor,
capacitor, inductor, vsource, isource, iprobe, vcvs, vccs, cccs, ccvs,
mutual_inductor, bsource), a subckt, a model card or a VA module.
Spectre analysis statements (`tran`, `dc`, `op`, `ac`, `noise`) and the
`sweep` and `montecarlo` containers run in `simulate`: a sweep runs its
points one after another through `alter` or re-elaboration, a Monte
Carlo re-elaborates run i with `np.random.default_rng([seed, i])`.
`statistics { vary }` is parsed and warned about, not sampled.

`montecarlo_elaborate` elaborates a netlist once per sample with its
statistical functions (agauss, gauss, aunif, unif) drawing from a seeded
numpy generator, in the JAX package's draw order, and stacks the
parameters on a leading lane axis.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..config import DEFAULT_DEVICE
from ..mna import devices as dv
from ..mna import waveforms as wf
from ..mna.spec import SimSpec
from ..mna.structure import GROUND_NAMES, Circuit
from ..models.registry import getmodel
from ..va.codegen import load_va_file
from .expressions import (ExprError, eval_expr, eval_expr_traced,
                          expr_names, parse_expr, parse_number)
from .netlist import (DotCard, Element, IfBlock, LibSection, Netlist,
                      SubcktDef, alter_text, parse_netlist)
from .spectre import (_SpectreInst, looks_like_spectre, parse_spectre,
                      parse_spectre_number)

# registered PDK/model packages for jlpkg://-style includes
_PDK_PACKAGES: dict[str, str] = {}


def register_pdk(name: str, path: str):
    _PDK_PACKAGES[name.lower()] = path


class ElabError(ValueError):
    pass


@dataclasses.dataclass
class ModelCard:
    name: str
    mtype: str                 # 'd', 'nmos', 'pmos', 'npn', 'pnp', 'r', 'c'
    params: dict               # lowercase name -> float


@dataclasses.dataclass
class Scope:
    """Lexical scope: parameters (exprs or values), model cards, subckts."""
    parent: Optional["Scope"] = None
    param_exprs: dict = dataclasses.field(default_factory=dict)
    param_vals: dict = dataclasses.field(default_factory=dict)
    models: dict = dataclasses.field(default_factory=dict)
    subckts: dict = dataclasses.field(default_factory=dict)
    # imported Verilog-A modules: lowercase name -> DeviceModel (tier-2
    # model resolution, most recent wins, reference `spice_select_device`
    # sema.jl:308-333)
    va_modules: dict = dataclasses.field(default_factory=dict)
    # binned model sets: base name -> [ModelCard 'base.1', 'base.2', ...]
    binned: dict = dataclasses.field(default_factory=dict)

    def _lookup(self, attr, name):
        s = self
        name = name.lower()
        while s is not None:
            table = getattr(s, attr)
            if name in table:
                return table[name]
            s = s.parent
        return None

    def lookup_binned(self, name):
        return self._lookup("binned", name)

    def lookup_param(self, name):
        s = self
        name = name.lower()
        while s is not None:
            if name in s.param_vals:
                return s.param_vals[name]
            s = s.parent
        raise ExprError(f"undefined parameter {name!r}")

    def lookup_model(self, name):
        return self._lookup("models", name)

    def lookup_subckt(self, name):
        return self._lookup("subckts", name)

    def lookup_va(self, name):
        return self._lookup("va_modules", name)


#: expression-level physical constants; netlist .param definitions shadow
#: them
_EXPR_CONSTS = {"pi": 3.141592653589793, "boltz": 1.380649e-23,
                "echarge": 1.602176634e-19, "kelvin": 273.15,
                "planck": 6.62607015e-34}


class _ScopeEnv:
    """Mapping view for eval_expr with scope-chain lookup."""

    def __init__(self, scope, extra=None):
        self.scope = scope
        self.extra = extra or {}

    def __contains__(self, k):
        if k in self.extra:
            return True
        try:
            self.scope.lookup_param(k)
            return True
        except ExprError:
            return k in _EXPR_CONSTS

    def __getitem__(self, k):
        if k in self.extra:
            return self.extra[k]
        try:
            return self.scope.lookup_param(k)
        except ExprError:
            if k in _EXPR_CONSTS:
                return _EXPR_CONSTS[k]
            raise


@dataclasses.dataclass
class Analysis:
    kind: str       # 'op' | 'dc' | 'ac' | 'tran' | 'noise'
    args: dict


class Elaborator:
    def __init__(self, *, include_dirs=(), section=None, dialect="spice",
                 rng=None):
        self.dialect = dialect          # "spice" or "spectre" numbers
        self.include_dirs = list(include_dirs)
        self.section = section          # .lib section selection
        # Monte Carlo hook: the statistical netlist functions sample from
        # this numpy Generator; None gives their nominal values
        self.rng = rng
        self.expr_funcs = {
            "agauss": lambda nom, avar, sig=1.0:
                nom + (self.rng.normal(0.0, avar / sig)
                       if self.rng is not None else 0.0),
            "gauss": lambda nom, rvar, sig=1.0:
                nom * (1.0 + (self.rng.normal(0.0, rvar / sig)
                              if self.rng is not None else 0.0)),
            "aunif": lambda nom, avar:
                nom + (self.rng.uniform(-avar, avar)
                       if self.rng is not None else 0.0),
            "unif": lambda nom, rvar:
                nom * (1.0 + (self.rng.uniform(-rvar, rvar)
                              if self.rng is not None else 0.0)),
            "temper": lambda: self.temp if self.temp is not None else 27.0,
        }
        self.analyses: list[Analysis] = []
        self.meas_cards: list[str] = []
        # Spectre `statistics` / `paramset` blocks: kept, not sampled
        self.statistics_cards: list = []
        self.data_tables: dict = {}
        self.options: dict = {}
        self.temp: Optional[float] = None
        self.globals: set = set()
        self.warned: set = set()
        self.cir: Optional[Circuit] = None
        # K elements: (name, inductor 1, inductor 2, k), resolved to
        # m = k*sqrt(L1*L2) after the whole netlist is built
        self._mutuals: list = []

    # ------------------------------------------------------------------ utils
    def _warn_once(self, key, msg):
        if key not in self.warned:
            self.warned.add(key)
            import warnings
            warnings.warn(msg, stacklevel=3)

    def value_of(self, field, scope, extra=None):
        """Numeric value of a field token."""
        kind, val = field[0], field[1]
        if kind == "word":
            num = (parse_spectre_number(val) if self.dialect == "spectre"
                   else parse_number(val))
            if num is not None:
                return num
            return eval_expr(parse_expr(val), _ScopeEnv(scope, extra),
                             funcs=self.expr_funcs)
        if kind == "expr":
            return eval_expr(parse_expr(val), _ScopeEnv(scope, extra),
                             funcs=self.expr_funcs)
        if kind == "group" and len(val) == 1:
            return self.value_of(val[0], scope, extra)
        if kind == "str":
            return val                      # string parameter, verbatim
        if kind == "vec":
            # bracketed Spectre vector [a b (expr) ...] -> value tuple
            return tuple(self.value_of(f, scope, extra) for f in val)
        raise ElabError(f"expected a value, got {field!r}")

    # ------------------------------------------------ pass 1: scope building
    def collect(self, cards, scope: Scope):
        """Collect params/models/subckts/options into scope; return the
        element and .if cards in order. Spectre analysis statements become
        Analysis cards marked "spectre"."""
        elements = []
        for card in cards:
            if isinstance(card, SubcktDef):
                scope.subckts[card.name.lower()] = card
            elif isinstance(card, LibSection):
                if self.section and card.name.lower() == \
                        str(self.section).lower():
                    elements.extend(self.collect(card.body, scope))
            elif isinstance(card, IfBlock):
                elements.append(card)
            elif isinstance(card, DotCard):
                if card.kind == "spectre_func":
                    self._spectre_func(card, scope)
                elif card.kind in ("spectre_statistics",
                                   "spectre_paramset"):
                    self.statistics_cards.append(card)
                elif card.kind.startswith("spectre_"):
                    self.analyses.append(Analysis(
                        card.kind[8:], {"fields": card.fields,
                                        "kwargs": card.kwargs,
                                        "spectre": True}))
                else:
                    self._dot(card, scope, elements)
            elif isinstance(card, (Element, _SpectreInst)):
                elements.append(card)
        return elements

    def _spectre_func(self, card: DotCard, scope: Scope):
        """`real f(a, b) { return expr; }`: a netlist function whose
        arguments bind over the defining scope's parameter chain."""
        fargs = [a.lower() for a in card.kwargs["args"]]
        fast = card.kwargs["expr"]

        def fn(*vals):
            return eval_expr(fast, _ScopeEnv(scope, dict(zip(fargs, vals))),
                             funcs=self.expr_funcs)

        self.expr_funcs[card.kwargs["name"]] = fn

    def _dot(self, card: DotCard, scope: Scope, elements):
        kind = card.kind
        if kind == "param":
            for k, v in card.kwargs.items():
                scope.param_exprs[k.lower()] = v
        elif kind == "model":
            self._model_card(card, scope)
        elif kind in ("option", "options"):
            for k, v in card.kwargs.items():
                try:
                    self.options[k] = self.value_of(v, scope)
                except (ExprError, ElabError, ValueError):
                    self.options[k] = v[1]
            for f in card.fields:
                if f[0] == "word":
                    self.options[f[1].lower()] = True
        elif kind == "temp":
            self.temp = self.value_of(card.fields[0], scope)
        elif kind == "global":
            for f in card.fields:
                if f[0] == "word":
                    self.globals.add(f[1])
        elif kind == "include":
            self._include(card, scope, elements)
        elif kind in ("hdl", "ahdl_include"):
            path = self._resolve_path(card.fields[0][1])
            for name, model in load_va_file(path).items():
                scope.va_modules[name.lower()] = model
        elif kind == "lib":
            self._lib(card, scope, elements)
        elif kind in ("ic", "nodeset"):
            self.options.setdefault(kind, {}).update(
                {k: self.value_of(v, scope) for k, v in card.kwargs.items()})
        elif kind in ("op", "dc", "ac", "tran", "noise"):
            self.analyses.append(Analysis(kind, {"fields": card.fields,
                                                 "kwargs": card.kwargs}))
        elif kind == "data":
            # .data table: name, column names, then row-major values
            # (ngspice data-driven sweeps; columns are alterable
            # instance.param keys, consumed by '.dc data=name')
            words_ = [f[1] for f in card.fields if f[0] == "word"]
            cols = []
            i = 1
            while i < len(words_) and parse_number(words_[i]) is None:
                cols.append(words_[i].lower())
                i += 1
            vals = [parse_number(w) for w in words_[i:]]
            if cols and vals and len(vals) % len(cols) == 0:
                arr = np.asarray(vals, float).reshape(-1, len(cols))
                self.data_tables[words_[0].lower()] = {
                    c: arr[:, j] for j, c in enumerate(cols)}
            else:
                self._warn_once(("data", words_[0] if words_ else "?"),
                                f".data {card.line!r}: malformed table")
        elif kind in ("meas", "measure"):
            # evaluated after the analyses in simulate() (ngspice .meas
            # semantics, analyses/measure.py)
            self.meas_cards.append(card.line)
        elif kind == "title":
            pass
        else:
            self._warn_once(("dot", kind), f".{kind} ignored")

    def _resolve_path(self, path):
        path = path.strip("\"'")
        m = re.match(r"jlpkg://([^/]+)/(.*)", path)
        if m:
            pkg = m.group(1).lower()
            if pkg not in _PDK_PACKAGES:
                raise ElabError(f"unknown PDK package {m.group(1)!r}; "
                                f"register_pdk() it first")
            return os.path.join(_PDK_PACKAGES[pkg], m.group(2))
        if os.path.isabs(path):
            return path
        for d in self.include_dirs:
            cand = os.path.join(d, path)
            if os.path.exists(cand):
                return cand
        return path

    def _parse_file(self, path):
        """Parse an included file in its own dialect, whichever the
        including deck's. A SPICE parent switches to the Spectre parser
        only on definitive markers: `simulator lang=spectre`, a .scs
        extension, or at least two Spectre-shaped statement lines (one
        misfires: an HSPICE parenthesized node list matches the instance
        pattern, and a SPICE library may open with `parameters`)."""
        with open(path) as fh:
            text = fh.read()
        head = text[:2000]
        if re.search(r"simulator\s+lang\s*=\s*spectre", head) or \
                str(path).lower().endswith(".scs"):
            return parse_spectre(text)
        if self.dialect == "spectre":
            if re.search(r"simulator\s+lang\s*=\s*spice", head):
                return parse_netlist(text, title_line=False)
            return parse_spectre(text)
        score = 0
        for raw in head.splitlines():
            s = re.sub(r"//.*", "", raw).strip()
            if not s or s.startswith(("*", ".")):
                continue
            first = s.split()[0].lower()
            if first in ("library", "section", "endsection", "endlibrary",
                         "parameters", "global", "ahdl_include", "paramset",
                         "statistics", "inline", "subckt", "ends"):
                score += 1
            elif re.match(r"^\w+\s*\([^)]*\)\s*\w+", s):
                score += 1
        if score >= 2:
            return parse_spectre(text)
        return parse_netlist(text, title_line=False)

    def _include(self, card, scope, elements):
        path = self._resolve_path(card.fields[0][1])
        sub = self._parse_file(path)
        olddirs = self.include_dirs
        self.include_dirs = [os.path.dirname(path)] + olddirs
        try:
            elements.extend(self.collect(sub.cards, scope))
        finally:
            self.include_dirs = olddirs

    def _lib(self, card, scope, elements):
        # .lib "file" section
        if len(card.fields) >= 2:
            path = self._resolve_path(card.fields[0][1])
            sub = self._parse_file(path)
            olddirs, oldsec = self.include_dirs, self.section
            self.include_dirs = [os.path.dirname(path)] + olddirs
            self.section = card.fields[1][1]
            try:
                elements.extend(self.collect(sub.cards, scope))
            finally:
                self.include_dirs, self.section = olddirs, oldsec

    def _find_bin(self, scope: Scope, mname: str, l: float, w: float):
        """L/W bin selection over 'base.N' model cards: the instance's
        scaled geometry must satisfy lmin <= l < lmax, wmin <= w < wmax."""
        bins = scope.lookup_binned(mname)
        if bins is None:
            return None
        scale = float(self.options.get("scale", 1.0))
        ls, wsc = l * scale, w * scale
        inf = float("inf")
        for mc in bins:
            if (mc.params.get("lmin", -inf) <= ls
                    < mc.params.get("lmax", inf)
                    and mc.params.get("wmin", -inf) <= wsc
                    < mc.params.get("wmax", inf)):
                return mc
        raise ElabError(
            f"no bin of model {mname!r} covers (l={l:g}, w={w:g}); "
            f"{len(bins)} bins checked")

    def _model_card(self, card: DotCard, scope: Scope):
        fields = card.fields
        if len(fields) < 2:
            raise ElabError(f"bad .model: {card.line}")
        name = fields[0][1].lower()
        mtype = fields[1][1].lower()
        params = {}
        # level in parens form: .model m nmos(level=1 ...) -> group
        for f in fields[2:]:
            if f[0] == "group":
                for g in f[1]:
                    if g[0] == "kw":
                        params[g[1]] = self.value_of(g[2], scope)
        for k, v in card.kwargs.items():
            try:
                params[k] = self.value_of(v, scope)
            except (ExprError, ElabError):
                # parameters referencing .param names resolve after the
                # scope's parameter pass
                params[k] = ("defer", v)
        mc = ModelCard(name, mtype, params)
        scope.models[name] = mc
        # binned model card 'base.N': collect under the base name
        if "." in name:
            base, idx = name.rsplit(".", 1)
            if idx.isdigit():
                scope.binned.setdefault(base, []).append(mc)

    # --------------------------------------------- pass 2: param evaluation
    def eval_params(self, scope: Scope):
        order = []
        exprs = {k: parse_expr(v[1]) if v[0] in ("word", "expr")
                 else v for k, v in scope.param_exprs.items()}
        deps = {}
        for k, ast in exprs.items():
            if isinstance(ast, tuple) and ast and ast[0] in (
                    "num", "name", "bin", "un", "cond", "call"):
                deps[k] = {d for d in expr_names(ast) if d in exprs}
            else:
                deps[k] = set()
        # Kahn toposort (reference param DiGraph toposort, sema.jl:716-760)
        pending = dict(deps)
        while pending:
            ready = [k for k, d in pending.items() if not d]
            if not ready:
                raise ElabError(f"circular .param dependency among "
                                f"{sorted(pending)}")
            for k in ready:
                order.append(k)
                del pending[k]
            for d in pending.values():
                d.difference_update(ready)
        env = _ScopeEnv(scope)
        for k in order:
            scope.param_vals[k] = eval_expr(exprs[k], env,
                                            funcs=self.expr_funcs)
        # resolve model-card parameters deferred on unevaluated .params
        for mc in scope.models.values():
            for k, v in list(mc.params.items()):
                if isinstance(v, tuple) and v and v[0] == "defer":
                    try:
                        mc.params[k] = self.value_of(v[1], scope)
                    except (ExprError, ElabError):
                        self._warn_once(("mp", mc.name, k),
                                        f".model {mc.name}: cannot "
                                        f"evaluate {k}")
                        del mc.params[k]

    # --------------------------------------------- pass 3: instantiation
    def build(self, elements, scope: Scope, prefix: str, node_map: dict):
        """Instantiate elements into self.cir. node_map maps local node
        names to flat names; unmapped locals get prefixed."""

        def flat_node(n):
            if n in GROUND_NAMES:
                return "0"
            if n in node_map:
                return node_map[n]
            if n in self.globals:
                return n
            return prefix + n

        for card in elements:
            if isinstance(card, IfBlock):
                env = _ScopeEnv(scope)
                for cond, body in card.branches:
                    if cond is None or eval_expr(cond, env) != 0:
                        inner = self.collect(body, scope)
                        self.eval_params(scope)
                        self.build(inner, scope, prefix, node_map)
                        break
                continue
            if isinstance(card, _SpectreInst):
                handler = self._spectre_inst
            elif isinstance(card, Element):
                handler = self._element
            else:
                continue
            try:
                handler(card, scope, prefix, flat_node)
            except (ExprError, ElabError, ValueError) as e:
                raise ElabError(
                    f"line {card.line_no}: {e}\n    {card.line}") from None

    # ---- per-element handlers
    def _element(self, card: Element, scope, prefix, flat_node):
        L = card.letter
        name = prefix + card.name
        f = card.fields
        kw = card.kwargs

        def words(n):
            out = []
            for fld in f:
                if fld[0] == "word" and len(out) < n:
                    out.append(fld[1])
            return out

        if L == "R":
            n1, n2 = words(2)
            val = None
            if "r" in kw:
                val = self.value_of(kw["r"], scope)
            elif len(f) >= 3:
                try:
                    val = self.value_of(f[2], scope)
                except (ExprError, ElabError):
                    val = None
            if val is None:
                mc = scope.lookup_model(f[2][1]) if len(f) >= 3 else None
                if mc is None:
                    raise ElabError(f"{name}: no resistance value")
                # semiconductor resistor: r = rsh * l / w
                l = self.value_of(kw["l"], scope) if "l" in kw else \
                    mc.params.get("l", 1e-6)
                w = self.value_of(kw["w"], scope) if "w" in kw else \
                    mc.params.get("w", mc.params.get("defw", 1e-6))
                rsh = mc.params.get("rsh", 0.0)
                narrow = mc.params.get("narrow", 0.0)
                val = rsh * (l - narrow) / max(w - narrow, 1e-15)
            self.cir.R(name, flat_node(n1), flat_node(n2), val)
        elif L == "C":
            n1, n2 = words(2)
            val = (self.value_of(kw["c"], scope) if "c" in kw
                   else self.value_of(f[2], scope))
            self.cir.C(name, flat_node(n1), flat_node(n2), val)
        elif L == "L":
            n1, n2 = words(2)
            val = (self.value_of(kw["l"], scope) if "l" in kw
                   else self.value_of(f[2], scope))
            self.cir.L(name, flat_node(n1), flat_node(n2), val)
        elif L in "VI":
            self._source(card, scope, prefix, flat_node)
        elif L == "E":
            n1, n2, c1, c2 = words(4)
            gain = self.value_of(f[4], scope)
            self.cir.add(dv.VCVS, name, (flat_node(n1), flat_node(n2),
                                         flat_node(c1), flat_node(c2)),
                         gain=gain)
        elif L == "G":
            n1, n2, c1, c2 = words(4)
            gm = self.value_of(f[4], scope)
            self.cir.add(dv.VCCS, name, (flat_node(n1), flat_node(n2),
                                         flat_node(c1), flat_node(c2)),
                         gm=gm)
        elif L == "F":
            n1, n2, vname = words(3)
            gain = self.value_of(f[3], scope)
            self.cir.add(dv.CCCS, name, (flat_node(n1), flat_node(n2)),
                         sense=prefix + vname, gain=gain)
        elif L == "H":
            n1, n2, vname = words(3)
            r = self.value_of(f[3], scope)
            self.cir.add(dv.CCVS, name, (flat_node(n1), flat_node(n2)),
                         sense=prefix + vname, r=r)
        elif L == "K":
            l1, l2 = words(2)
            k = self.value_of(f[2], scope) if len(f) > 2 else \
                self.value_of(kw["k"], scope)
            # placeholder M; set to k*sqrt(L1*L2) by the post-pass of
            # elaborate_netlist once both inductor values are known
            self.cir.add(dv.MUTUAL, name, (), sense=(prefix + l1,
                                                     prefix + l2),
                         m=float(k))
            self._mutuals.append((name, prefix + l1, prefix + l2, float(k)))
        elif L == "N" or L == "Y":
            # VA device instance: nname node... modelname [p=v ...]
            ws = [fld[1] for fld in f if fld[0] == "word"]
            mname = ws[-1]
            mc = scope.lookup_model(mname)
            va = scope.lookup_va(mc.mtype) if mc else scope.lookup_va(mname)
            if va is None:
                raise ElabError(f"{name}: unknown VA model {mname!r}")
            extra = {k: self.value_of(v, scope) for k, v in kw.items()}
            self._va_inst(name, va, ws[:-1], flat_node,
                          dict(mc.params if mc else {}, **extra))
        elif L == "D":
            n1, n2 = words(2)
            mc = scope.lookup_model(f[2][1])
            if mc is None:
                raise ElabError(f"{name}: unknown diode model {f[2][1]!r}")
            va = scope.lookup_va(mc.mtype) or self._tier1_va(mc)
            if va is not None:
                extra = {k: self.value_of(v, scope) for k, v in kw.items()}
                self._va_inst(name, va, [n1, n2], flat_node,
                              dict(mc.params, **extra))
                return
            p = _map_model_params(mc, _DIODE_MAP, self._warn_once)
            area = self.value_of(f[3], scope) if len(f) > 3 else 1.0
            if "area" in kw:
                area = self.value_of(kw["area"], scope)
            p["area"] = area
            self.cir.D(name, flat_node(n1), flat_node(n2), **p)
        elif L == "Q":
            ws = words(5)
            # the model is the 4th or the 5th word (optional substrate)
            mc = scope.lookup_model(ws[3]) if len(ws) > 3 else None
            subs_used = False
            if mc is None and len(ws) > 4:
                mc = scope.lookup_model(ws[4])
                subs_used = True
            if mc is None:
                raise ElabError(f"{name}: unknown BJT model")
            c, b, e = ws[0], ws[1], ws[2]
            va = scope.lookup_va(mc.mtype) or self._tier1_va(mc)
            if va is not None:
                extra = {k: self.value_of(v, scope) for k, v in kw.items()}
                if mc.mtype == "pnp":
                    extra.setdefault("type", -1.0)
                sub = ws[3] if subs_used else "0"
                self._va_inst(name, va, [c, b, e, sub], flat_node,
                              dict(mc.params, **extra))
                return
            p = _map_model_params(mc, _BJT_MAP, self._warn_once)
            p["type"] = -1.0 if mc.mtype == "pnp" else 1.0
            if "area" in kw:
                p["area"] = self.value_of(kw["area"], scope)
            self.cir.add(dv.BJT, name,
                         (flat_node(c), flat_node(b), flat_node(e)), **p)
        elif L == "M":
            ws = words(5)
            d, g, s, b, mname = ws[0], ws[1], ws[2], ws[3], ws[4]
            wv = (self.value_of(kw["w"], scope) if "w" in kw
                  else self.options.get("defw", 100e-6))
            lv = (self.value_of(kw["l"], scope) if "l" in kw
                  else self.options.get("defl", 100e-6))
            mc = scope.lookup_model(mname)
            if mc is None:
                mc = self._find_bin(scope, mname, float(lv), float(wv))
            if mc is None:
                raise ElabError(f"{name}: unknown MOS model {mname!r}")
            va = scope.lookup_va(mc.mtype) or self._tier1_va(mc)
            if va is not None:
                extra = {k: self.value_of(v, scope) for k, v in kw.items()}
                if mc.mtype == "pmos":
                    extra.setdefault("type", -1.0)
                extra.setdefault("w", wv)
                extra.setdefault("l", lv)
                self._va_inst(name, va, ws[:4], flat_node,
                              dict(mc.params, **extra))
                return
            p = _map_model_params(mc, _MOS_MAP, self._warn_once)
            p["type"] = -1.0 if mc.mtype == "pmos" else 1.0
            p["w"] = wv
            p["l"] = lv
            self.cir.add(dv.MOSFET1, name,
                         (flat_node(d), flat_node(g), flat_node(s),
                          flat_node(b)), **p)
        elif L in ("J", "Z"):
            # JFET / MESFET: Jname d g s model [area]; resolved through the
            # tier-1 registry (no built-in devices for these classes)
            ws = [fld[1] for fld in f if fld[0] == "word"]
            d_, g_, s_, mname = ws[0], ws[1], ws[2], ws[3]
            mc = scope.lookup_model(mname)
            if mc is None:
                raise ElabError(f"{name}: unknown model {mname!r}")
            va = scope.lookup_va(mc.mtype) or self._tier1_va(mc)
            if va is None:
                raise ElabError(
                    f"{name}: model type {mc.mtype!r} needs the VA model "
                    f"package (set CADNIP_VA_MODELS)")
            extra = {k: self.value_of(v, scope) for k, v in kw.items()}
            if mc.mtype in ("pjf", "pmf"):
                extra.setdefault("type", -1.0)
            if len(ws) > 4:
                extra.setdefault("area", self.value_of(("word", ws[4]),
                                                       scope))
            self._va_inst(name, va, [d_, g_, s_], flat_node,
                          dict(mc.params, **extra))
        elif L == "X":
            self._subckt_call(card, scope, prefix, flat_node)
        elif L == "B":
            self._bsource(card, scope, prefix, flat_node)
        else:
            raise ElabError(f"element type {L!r} not supported yet")

    def _bsource(self, card: Element, scope, prefix, flat_node):
        name = prefix + card.name
        words = [fld[1] for fld in card.fields if fld[0] == "word"]
        n1, n2 = words[0], words[1]
        is_v = "v" in card.kwargs
        expr_f = card.kwargs.get("v") or card.kwargs.get("i")
        if expr_f is None:
            raise ElabError(f"{name}: B source needs V= or I=")
        ast = parse_expr(expr_f[1])
        model, nodes, sense = _make_bsource_model(
            name, ast, is_v, scope, flat_node, (flat_node(n1),
                                                flat_node(n2)), prefix)
        self.cir.add(model, name, nodes, sense=sense)

    def _tier1_va(self, mc: ModelCard):
        """Tier-1 registry resolution for a model card (reference
        `src/spc/sema.jl:308-333` fallback to ModelRegistry.getmodel):
        None where the built-in device serves, or no VA file is found."""
        lvl = 1
        for k, v in mc.params.items():
            if str(k).lower() == "level":
                try:
                    lvl = int(float(v))
                except (TypeError, ValueError):
                    lvl = 1
        prefer = bool(self.options.get("vamodels", 0))
        return getmodel(mc.mtype, lvl, prefer_va=prefer)

    def _va_inst(self, name, model, node_names, flat_node, params: dict):
        """Instantiate a compiled VA DeviceModel with case-insensitive
        parameter mapping; overridden params get their __given mask set."""
        lmap = {k.lower(): k for k in model.defaults
                if not k.endswith("__given")}
        kw = {}
        for k, v in params.items():
            kl = str(k).lower()
            if kl in ("level", "version"):
                continue
            if kl in lmap:
                if lmap[kl] in model.structural_params:
                    self._warn_once(
                        ("vastruct", model.name, kl),
                        f"{model.name}: parameter {k!r} is structural "
                        f"(laplace coefficients / loop bounds are compiled "
                        f"at default values); the override does NOT affect "
                        f"those uses")
                kw[lmap[kl]] = float(v)
                kw[lmap[kl] + "__given"] = 1.0
            else:
                self._warn_once(("vap", model.name, kl),
                                f"{model.name}: parameter {k!r} ignored")
        n_term = len(model.terminals)
        if len(node_names) != n_term:
            raise ElabError(f"{name}: VA module {model.name} has {n_term} "
                            f"ports, got {len(node_names)} nodes")
        if model.va_specialize is not None:
            # node-collapse specialization for this parameter signature
            # (reference detect_short_circuits, vasim.jl:2723): `V(a,b)<+0`
            # branches decided by the instance's effective parameters merge
            # their nodes instead of carrying a constraint row
            model = model.va_specialize(kw)
        self.cir.add(model, name,
                     tuple(flat_node(n) for n in node_names), **kw)

    def _source(self, card: Element, scope, prefix, flat_node):
        name = prefix + card.name
        f = list(card.fields)
        kw = card.kwargs
        nodes = []
        i = 0
        while i < len(f) and len(nodes) < 2:
            if f[i][0] == "word":
                nodes.append(f[i][1])
                i += 1
            else:
                break
        if len(nodes) < 2:
            raise ElabError(f"{name}: needs two nodes")
        dc_val = 0.0
        acmag, acphase = 0.0, 0.0
        wave = None
        rest = f[i:]
        j = 0

        def val_at(k):
            return self.value_of(rest[k], scope)

        while j < len(rest):
            fld = rest[j]
            if fld[0] == "word" and parse_number(fld[1]) is None:
                w = fld[1].lower()
                if w == "dc":
                    dc_val = val_at(j + 1)
                    j += 2
                elif w == "ac":
                    acmag = val_at(j + 1) if j + 1 < len(rest) else 1.0
                    j += 2
                    if j < len(rest) and rest[j][0] == "word" and \
                            parse_number(rest[j][1]) is not None:
                        acphase = val_at(j)
                        j += 1
                elif w in ("pulse", "sin", "sine", "pwl", "exp", "sffm"):
                    args = []
                    j += 1
                    if j < len(rest) and rest[j][0] == "group":
                        args = [self.value_of(x, scope)
                                for x in rest[j][1]]
                        j += 1
                    else:
                        while j < len(rest) and (
                                rest[j][0] in ("expr", "group")
                                or parse_number(rest[j][1]) is not None):
                            args.append(self.value_of(rest[j], scope))
                            j += 1
                    wave = _make_wave(w, args)
                else:
                    raise ElabError(f"{name}: unknown token {fld[1]!r}")
            elif fld[0] == "group":
                # a bare group right after nodes is a PWL-style list
                j += 1
            else:
                dc_val = val_at(j)
                j += 1
        if "dc" in kw:
            dc_val = self.value_of(kw["dc"], scope)
        if "ac" in kw:
            acmag = self.value_of(kw["ac"], scope)
        for k in ("pulse", "sin", "pwl", "exp", "sffm"):
            if k in kw and kw[k][0] == "group":
                wave = _make_wave(k, [self.value_of(x, scope)
                                      for x in kw[k][1]])
        if wave is None:
            wave = wf.DC(dc_val)
        elif dc_val and wave.dc != dc_val:
            wave = dataclasses.replace(wave, dc=dc_val)
        adder = self.cir.V if card.letter == "V" else self.cir.I
        adder(name, flat_node(nodes[0]), flat_node(nodes[1]), wave=wave,
              acmag=acmag, acphase=acphase)

    def _spectre_inst(self, card: _SpectreInst, scope, prefix, flat_node):
        """Spectre instance: a primitive master, a subckt, a model card or
        a VA module (reference Spectre primitives, `codegen.jl:1877-2188`)."""
        name = prefix + card.name
        master = card.master
        ml = master.lower()
        nodes = [flat_node(n) for n in card.nodes]

        def val(key, default=None):
            if key in card.kwargs:
                return self.value_of(card.kwargs[key], scope)
            return default

        def word(key):
            return str(card.kwargs.get(key, ("word", ""))[1])

        if ml == "resistor":
            self.cir.R(name, nodes[0], nodes[1], val("r", 1e3))
        elif ml == "capacitor":
            self.cir.C(name, nodes[0], nodes[1], val("c", 1e-12))
        elif ml == "inductor":
            self.cir.L(name, nodes[0], nodes[1], val("l", 1e-9))
        elif ml in ("vsource", "isource", "iprobe"):
            ty = card.kwargs["type"][1].lower() if "type" in card.kwargs \
                else ""
            wave = None
            if ty == "pulse":
                wave = wf.Pulse(val("val0", 0.0), val("val1", 1.0),
                                val("delay", 0.0), val("rise", 1e-9),
                                val("fall", 1e-9), val("width", 1e30),
                                val("period", 1e30))
            elif ty in ("sine", "sin"):
                wave = wf.Sin(val("sinedc", val("dc", 0.0)),
                              val("ampl", 1.0), val("freq", 1e3),
                              val("delay", 0.0), val("damp", 0.0))
            elif ty == "pwl":
                pts = card.kwargs.get("wave")
                if pts is not None and pts[0] in ("group", "vec"):
                    wave = wf.PWL([self.value_of(x, scope) for x in pts[1]])
            if wave is None:
                wave = wf.DC(val("dc", 0.0))
            elif val("dc") is not None:
                wave = dataclasses.replace(wave, dc=val("dc"))
            adder = self.cir.I if ml == "isource" else self.cir.V
            adder(name, nodes[0], nodes[1], wave=wave,
                  acmag=val("mag", 0.0), acphase=val("phase", 0.0))
        elif ml == "vcvs":
            self.cir.add(dv.VCVS, name, tuple(nodes[:4]),
                         gain=val("gain", 1.0))
        elif ml == "vccs":
            self.cir.add(dv.VCCS, name, tuple(nodes[:4]),
                         gm=val("gm", val("gain", 1.0)))
        elif ml == "cccs":
            self.cir.add(dv.CCCS, name, tuple(nodes[:2]),
                         sense=prefix + word("probe"), gain=val("gain", 1.0))
        elif ml == "ccvs":
            self.cir.add(dv.CCVS, name, tuple(nodes[:2]),
                         sense=prefix + word("probe"),
                         r=val("rm", val("gain", 1.0)))
        elif ml == "bsource":
            # `name (p n) bsource v=expr` (the asap7 deck idiom, reference
            # `test/bsimcmg/asap7_inv.scs`)
            m = re.search(r"\b([vi])\s*=\s*(.+?)\s*$", card.line,
                          re.IGNORECASE)
            if m is None:
                raise ElabError(f"{name}: bsource needs v= or i=")
            model, bnodes, sense = _make_bsource_model(
                name, parse_expr(m.group(2).strip('"')),
                m.group(1).lower() == "v", scope, flat_node,
                (nodes[0], nodes[1]), prefix)
            self.cir.add(model, name, bnodes, sense=sense)
        elif ml == "mutual_inductor":
            l1, l2 = prefix + word("ind1"), prefix + word("ind2")
            k = float(val("coupling", 0.0))
            self.cir.add(dv.MUTUAL, name, (), sense=(l1, l2), m=k)
            self._mutuals.append((name, l1, l2, k))
        else:
            self._spectre_master(card, scope, prefix, flat_node)

    def _spectre_master(self, card: _SpectreInst, scope, prefix, flat_node):
        """A Spectre instance of a subckt, a VA module or a model card over
        a built-in type, through the SPICE letter paths."""
        master = card.master
        words = [("word", n) for n in card.nodes] + [("word", master)]
        if scope.lookup_subckt(master) is not None:
            self._subckt_call(Element("element", card.line_no, card.line,
                                      letter="X", name=card.name,
                                      fields=words, kwargs=card.kwargs),
                              scope, prefix, flat_node)
            return
        mc = scope.lookup_model(master)
        va = scope.lookup_va(mc.mtype if mc else master)
        if va is not None:
            extra = {k: self.value_of(v, scope)
                     for k, v in card.kwargs.items()}
            self._va_inst(prefix + card.name, va, card.nodes, flat_node,
                          dict(mc.params if mc else {}, **extra))
            return
        letter = {"d": "D", "nmos": "M", "pmos": "M", "npn": "Q",
                  "pnp": "Q"}.get(mc.mtype) if mc else None
        if letter is None:
            raise ElabError(f"{prefix + card.name}: unknown master "
                            f"{master!r}")
        self._element(Element("element", card.line_no, card.line,
                              letter=letter, name=card.name, fields=words,
                              kwargs=card.kwargs),
                      scope, prefix, flat_node)

    def _subckt_call(self, card: Element, scope, prefix, flat_node):
        words = [fld[1] for fld in card.fields if fld[0] == "word"]
        if not words:
            raise ElabError("X line needs nodes + subckt name")
        subname = words[-1]
        nodes = words[:-1]
        sub = scope.lookup_subckt(subname)
        if sub is None:
            va = scope.lookup_va(subname)
            if va is not None:
                extra = {k: self.value_of(v, scope)
                         for k, v in card.kwargs.items()}
                self._va_inst(prefix + card.name, va, nodes, flat_node,
                              extra)
                return
            raise ElabError(f"unknown subcircuit {subname!r}")
        if len(nodes) != len(sub.ports):
            raise ElabError(f"{card.name}: subckt {subname} has "
                            f"{len(sub.ports)} ports, got {len(nodes)}")
        child = Scope(parent=scope)
        # defaults from the definition, overridden by the instance line
        for k, v in sub.params.items():
            child.param_exprs[k.lower()] = v
        inner = self.collect(sub.body, child)
        # instance-line overrides are evaluated in the CALLING scope
        for k, v in card.kwargs.items():
            child.param_vals[k.lower()] = self.value_of(v, scope)
            child.param_exprs.pop(k.lower(), None)
        self.eval_params(child)
        new_prefix = prefix + card.name + "."
        node_map = {p: flat_node(n) for p, n in zip(sub.ports, nodes)}
        self.build(inner, child, new_prefix, node_map)


# ---------------------------------------------------------------------------
# model parameter maps (SPICE card name -> DeviceModel param)

_DIODE_MAP = {
    "is": "is", "js": "is", "n": "n", "rs": "rs", "cjo": "cjo", "cj0": "cjo",
    "vj": "vj", "pb": "vj", "m": "m", "mj": "m", "tt": "tt", "bv": "bv",
    "ibv": "ibv", "fc": "fc", "kf": "kf", "af": "af",
}
_BJT_MAP = {
    "is": "is", "bf": "bf", "br": "br", "nf": "nf", "nr": "nr", "vaf": "vaf",
    "va": "vaf", "var": "var", "cje": "cje", "vje": "vje", "mje": "mje",
    "cjc": "cjc", "vjc": "vjc", "mjc": "mjc", "tf": "tf", "tr": "tr",
    "fc": "fc",
}
_MOS_MAP = {
    "vto": "vth", "vth0": "vth", "kp": "kp", "lambda": "lambda",
    "cgso": "cgs", "cgdo": "cgd", "cgbo": "cgb", "cbd": "cbd",
    "cbs": "cbs", "is": "is", "js": "is",
}


def _map_model_params(mc: ModelCard, table: dict, warn_once):
    out = {}
    for k, v in mc.params.items():
        if k in ("lmin", "lmax", "wmin", "wmax", "level"):
            continue    # bin bounds (consumed by _find_bin) and the level
        if k in table:
            out[table[k]] = v
        else:
            warn_once(("mp", mc.name, k),
                      f".model {mc.name}: parameter {k!r} ignored")
    return out


def _make_wave(kind: str, args):
    if kind == "pulse":
        return wf.Pulse(*args[:7])
    if kind in ("sin", "sine"):
        return wf.Sin(*args[:6])
    if kind == "pwl":
        return wf.PWL(args)
    if kind == "exp":
        return wf.Exp(*args[:6])
    if kind == "sffm":
        return wf.Sffm(*args[:5])
    raise ElabError(kind)


# ---------------------------------------------------------------------------
# behavioral sources

def _behavioral_refs(ast):
    """Collect v(...)/i(...) references and free parameter names."""
    vrefs, irefs, names = [], [], set()

    def walk(e):
        if e[0] == "call":
            fn = e[1]
            if fn == "v":
                args = tuple(a[1] for a in e[2])
                if args not in vrefs:
                    vrefs.append(args)
                return
            if fn == "i":
                args = e[2][0][1]
                if args not in irefs:
                    irefs.append(args)
                return
            for a in e[2]:
                walk(a)
        elif e[0] == "name":
            names.add(e[1].lower())
        elif e[0] == "bin":
            walk(e[2])
            walk(e[3])
        elif e[0] == "un":
            walk(e[2])
        elif e[0] == "cond":
            for x in e[1:]:
                walk(x)

    walk(ast)
    return vrefs, irefs, names


def _make_bsource_model(name, ast, is_v, scope, flat_node, out_nodes,
                        prefix):
    """Create a one-off DeviceModel for a behavioral source.

    Local layout: [p, n, ctrl_nodes..., sensed currents..., (i_branch if
    V-source)]. The residual builds its rows out of place (torch.stack),
    so that vmap and jacrev trace it."""
    vrefs, irefs, pnames = _behavioral_refs(ast)
    ctrl_nodes = []
    for ref in vrefs:
        for nd in ref:
            fn = flat_node(nd)
            if fn not in ctrl_nodes:
                ctrl_nodes.append(fn)
    env = _ScopeEnv(scope)
    const_scope = {}
    for pn in pnames:
        if pn in ("time",):
            continue
        const_scope[pn] = env[pn]

    # local layout matches structure.py: terminals (p, n, ctrl..., isense...)
    # then internals (the branch current for a V-type source)
    n_ctrl = len(ctrl_nodes)
    ctrl_pos = {nd: 2 + k for k, nd in enumerate(ctrl_nodes)}
    sense_base = 2 + n_ctrl
    i_pos = sense_base + len(irefs) if is_v else None
    n_local = sense_base + len(irefs) + (1 if is_v else 0)

    def node_val(u, nd):
        fn = flat_node(nd)
        if fn in GROUND_NAMES:
            return 0.0
        if fn == out_nodes[0]:
            return u[0]
        if fn == out_nodes[1]:
            return u[1]
        return u[ctrl_pos[fn]]

    def residual(u, p, dyn):
        def vref_val(ref):
            va = node_val(u, ref[0])
            if len(ref) > 1:
                va = va - node_val(u, ref[1])
            return va

        vcache = {ref: vref_val(ref) for ref in vrefs}
        icache = {nm: u[sense_base + k] for k, nm in enumerate(irefs)}

        scope_t = dict(const_scope)
        scope_t["time"] = dyn.time

        # substitute v()/i() calls by their values, then evaluate
        def subst(e):
            if e[0] == "call" and e[1] == "v":
                return ("num", vcache[tuple(a[1] for a in e[2])])
            if e[0] == "call" and e[1] == "i":
                return ("num", icache[e[2][0][1]])
            if e[0] == "call":
                return ("call", e[1], [subst(a) for a in e[2]])
            if e[0] == "bin":
                return ("bin", e[1], subst(e[2]), subst(e[3]))
            if e[0] == "un":
                return ("un", e[1], subst(e[2]))
            if e[0] == "cond":
                return ("cond", subst(e[1]), subst(e[2]), subst(e[3]))
            return e

        val = eval_expr_traced(subst(ast), scope_t)
        z = u[0] * 0.0
        rows = [z] * n_local
        if is_v:
            ib = u[i_pos]
            rows[0] = z + ib
            rows[1] = rows[1] - ib
            rows[i_pos] = u[0] - u[1] - val
        else:
            rows[0] = z + val
            rows[1] = rows[1] - val
        f = torch.stack(rows)
        return f, torch.zeros_like(f) * u[0]

    terminals = tuple(["p", "n"] + [f"c{k}" for k in range(n_ctrl)]
                      + [f"isense{k}" for k in range(len(irefs))])
    internals = (("i", dv.CLASS_I),) if is_v else ()
    model = dv.DeviceModel(
        name=f"bsource:{name}", terminals=terminals, residual=residual,
        internals=internals, defaults={})
    nodes = tuple(out_nodes) + tuple(ctrl_nodes)
    sense = tuple(prefix + nm for nm in irefs)
    return model, nodes, sense


# ---------------------------------------------------------------------------
# public entry points

def elaborate_netlist(source, *, include_dirs=(), section=None, title=None,
                      dialect="auto", rng=None, hdl=()):
    """SPICE or Spectre text (or a parsed Netlist) -> (Circuit,
    Elaborator). The Elaborator carries the parsed analysis cards,
    .options and .temp. dialect: "spice", "spectre" or "auto" (sniffed by
    `looks_like_spectre`). rng: a numpy Generator the statistical
    functions sample from (None: nominal values). hdl: Verilog-A file
    paths preloaded into the root scope (the programmatic `.hdl` card;
    model cards may then name the modules)."""
    if isinstance(source, Netlist):
        nl = source
        if dialect == "auto":
            dialect = "spice"
    else:
        if dialect == "auto":
            dialect = "spectre" if looks_like_spectre(source) else "spice"
        with obs.span("parse"):
            nl = (parse_spectre(source) if dialect == "spectre"
                  else parse_netlist(source))
    with obs.span("elaborate"):
        el = Elaborator(include_dirs=include_dirs, section=section,
                        dialect=dialect, rng=rng)
        root = Scope()
        for path in ([hdl] if isinstance(hdl, str) else hdl):
            for name, model in load_va_file(path).items():
                root.va_modules[name.lower()] = model
        elements = el.collect(nl.cards, root)
        el.eval_params(root)
        # top-scope parameter names: the Spectre sweep container checks
        # its target against them before it appends a `parameters` card
        el.param_names = frozenset(str(k).lower() for k in root.param_vals)
        el.cir = Circuit(title or nl.title or "netlist")
        el.build(elements, root, "", {})
        # resolve mutual inductances now that both L values are known
        lvals = {i.name: i.params.get("l", i.model.defaults["l"])
                 for i in el.cir.instances if i.model is dv.INDUCTOR}
        insts = {i.name: i for i in el.cir.instances}
        for nm, l1, l2, k in el._mutuals:
            if l1 not in lvals or l2 not in lvals:
                raise ElabError(
                    f"{nm}: couples unknown inductors {l1!r}/{l2!r}")
            insts[nm].params["m"] = k * float(np.sqrt(lvals[l1] * lvals[l2]))
    return el.cir, el


def spice_spec(el: Elaborator, base: SimSpec | None = None) -> SimSpec:
    """Fold .option/.temp into a SimSpec."""
    kw = {}
    base = base or SimSpec()
    opts = el.options
    for src, dst in (("reltol", "reltol"), ("abstol", "abstol"),
                     ("vntol", "vntol"), ("chgtol", "chgtol"),
                     ("gmin", "gmin"), ("gshunt", "gshunt"),
                     ("itl1", "max_newton_iters")):
        if src in opts and isinstance(opts[src], (int, float)):
            kw[dst] = type(getattr(base, dst))(opts[src])
    if el.temp is not None:
        kw["temp_c"] = float(el.temp)
    return dataclasses.replace(base, **kw)


def parse_spice(source, *, include_dirs=(), section=None,
                spec: SimSpec | None = None, compile=True,
                device=DEFAULT_DEVICE, hdl=(), dialect="auto"):
    """SPICE or Spectre netlist text -> CompiledCircuit on `device`: the
    card by default (raises where there is none), "cpu" for the host; or
    the Circuit if compile=False. hdl: Verilog-A files to preload.
    The circuit's `timings` hold the host seconds of the spans
    "frontend.parse", "frontend.elaborate" and "frontend.compile"
    (`obs`)."""
    with obs.call() as timings, obs.span("frontend"):
        cir, el = elaborate_netlist(source, include_dirs=include_dirs,
                                    section=section, hdl=hdl,
                                    dialect=dialect)
        if not compile:
            return cir
        with obs.span("compile"):
            cc = cir.compile(spice_spec(el, spec), device=device)
    cc.timings = timings
    return cc


def circuit_from_file(path, *, section=None, spec=None, compile=True,
                      device=DEFAULT_DEVICE):
    """parse_spice of a netlist file, its includes resolved against the
    file's directory."""
    with open(path) as fh:
        text = fh.read()
    return parse_spice(text, include_dirs=[os.path.dirname(
        os.path.abspath(path))], section=section, spec=spec,
        compile=compile, device=device)


def simulate(source, *, include_dirs=(), section=None,
             spec: SimSpec | None = None, device=DEFAULT_DEVICE):
    """Parse a netlist, compile it on `device` (the card by default, "cpu"
    for the host) and run its analysis cards (.op, .dc, .tran, .ac,
    .noise, and the Spectre statements with their sweep and montecarlo
    containers), then its .meas cards.

    Returns {analysis_kind: solution} (the last card of each kind wins the
    key; every result is listed under 'all', the circuit under 'circuit',
    the measurements under 'meas')."""
    from ..analyses.ac import ac as ac_run, acdec
    from ..analyses.dc import dc as dc_run
    from ..analyses.noise import noise as noise_run
    from ..analyses.sweeps import dcsweep
    from ..analyses.tran import tran as tran_run

    cir, el = elaborate_netlist(source, include_dirs=include_dirs,
                                section=section)
    cc = cir.compile(spice_spec(el, spec), device=device)
    results = {"all": [], "circuit": cc}
    for an in el.analyses:
        if an.args.get("spectre"):
            if an.kind in ("sweep", "montecarlo"):
                sol = _run_spectre_container(
                    source, cc, el, an, include_dirs=include_dirs,
                    section=section, spec=spec, device=device)
            else:
                sol = _run_spectre_analysis(cc, an)
            if sol is not None:
                results[an.kind] = sol
                results["all"].append((an.kind, sol))
            continue
        fields = an.args["fields"]
        vals = []
        words = []
        for fld in fields:
            num = parse_number(fld[1]) if fld[0] == "word" else None
            if num is not None or fld[0] == "expr":
                vals.append(num if num is not None
                            else float(fld[1]))
            elif fld[0] == "word":
                words.append(fld[1])
        if an.kind == "op":
            sol = dc_run(cc, nodeset=el.options.get("nodeset"))
        elif an.kind == "tran":
            # .tran tstep tstop [tstart [tmax]] [uic]
            tstep = vals[0]
            tstop = vals[1]
            tstart = vals[2] if len(vals) > 2 else 0.0
            tmax = vals[3] if len(vals) > 3 else None
            integ = ("gear2" if str(el.options.get("method", "")) == "gear"
                     else "trap")
            sol = tran_run(cc, (tstart, tstop), dt=tstep, dtmax=tmax,
                           integ=integ, ic=el.options.get("ic"),
                           uic=any(w.lower() == "uic" for w in words))
        elif an.kind == "ac":
            mode = words[0].lower() if words else "dec"
            npts = int(vals[0])
            fstart, fstop = vals[1], vals[2]
            if mode == "dec":
                freqs = acdec(npts, fstart, fstop)
            elif mode == "lin":
                freqs = np.linspace(fstart, fstop, npts)
            else:
                freqs = np.geomspace(fstart, fstop, npts)
            sol = ac_run(cc, freqs)
        elif an.kind == "dc":
            kwargs = an.args.get("kwargs", {})
            if "data" in kwargs:
                # .dc data=tab: data-driven sweep over the table columns
                tab = el.data_tables.get(str(kwargs["data"][1]).lower())
                if tab is None:
                    raise ElabError(f".dc data: unknown table "
                                    f"{kwargs['data'][1]!r}")
                sol = dcsweep(cc, dict(tab))
            else:
                # .dc srcname start stop step
                src = words[0]
                start, stop, step = vals[0], vals[1], vals[2]
                pts = np.arange(start, stop + step * 0.5, step)
                sol = dcsweep(cc, {f"{src}.dc": pts})
        elif an.kind == "noise":
            # .noise v(out[,ref]) src dec npts fstart fstop
            out = None
            for fld in fields:
                if fld[0] == "group":
                    inner = [g[1] for g in fld[1] if g[0] == "word"]
                    out = tuple(inner) if len(inner) > 1 else inner[0]
            vwords = [w for w in words if w.lower() not in
                      ("dec", "lin", "oct", "v")]
            srcname = vwords[0] if vwords else None
            npts = int(vals[0])
            freqs = acdec(npts, vals[1], vals[2])
            sol = noise_run(cc, out, freqs, input=srcname)
        else:
            continue
        results[an.kind] = sol
        results["all"].append((an.kind, sol))
    if el.meas_cards:
        from ..analyses.measure import MeasError, eval_meas
        meas = {}
        for line in el.meas_cards:
            m = re.match(r"^\.\s*meas(?:ure)?\s+(\w+)", line.strip(),
                         re.I)
            sol = results.get(m.group(1).lower()) if m else None
            if sol is None:
                continue
            try:
                nm, val = eval_meas(line, sol, meas)
                meas[nm] = val
            except MeasError as e:
                import warnings
                warnings.warn(f".meas failed: {e}")
        results["meas"] = meas
    return results


def montecarlo_elaborate(source, n: int, seed: int = 0, *,
                         include_dirs=(), section=None,
                         spec: SimSpec | None = None,
                         device=DEFAULT_DEVICE):
    """Monte Carlo over the netlist's statistical expressions: elaborate
    it n times, sample k drawing from `np.random.default_rng([seed, k])`
    (so the samples are the JAX package's, bit for bit), and stack the
    parameter lists on a leading lane axis.

    Returns (cc, batched_params): cc is the nominal compiled circuit, and
    every leaf of batched_params is [n, ...]. The JAX package also returns
    vmap in_axes; the port reads the lane axis from the leaves
    (`analyses.dc.param_lanes`)."""
    kw = dict(include_dirs=include_dirs, section=section)
    cir0, el0 = elaborate_netlist(source, **kw)
    spec = spice_spec(el0, spec)
    cc = cir0.compile(spec, device=device)
    plist = []
    for k in range(n):
        cir, _ = elaborate_netlist(source, rng=np.random.default_rng(
            [seed, k]), **kw)
        # only the sample's parameters are kept, and they do not depend on
        # the solver: no sample is partitioned
        plist.append(cir.compile(spec, solver="dense",
                                 device=device).params0())

    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {key: stack([d[key] for d in leaves])
                    for key in leaves[0]}
        return torch.stack(leaves)

    return cc, [stack([p[gi] for p in plist]) for gi in range(len(cc.groups))]


# ---------------------------------------------------------------------------
# Spectre analysis statements and their sweep / montecarlo containers

def _sp_num(tok):
    """Numeric value of a Spectre keyword token (no scope)."""
    if tok[0] == "word":
        num = parse_spectre_number(tok[1])
        if num is not None:
            return num
    try:
        return float(tok[1])
    except (TypeError, ValueError):
        return None


def _run_spectre_analysis(cc, an, params=None):
    """Run one Spectre analysis statement (`tran stop= step= maxstep=`,
    `dc`, `op`, `ac start= stop= dec=`, `noise out= ...`); None for any
    other."""
    from ..analyses.ac import ac as ac_run, acdec
    from ..analyses.dc import dc as dc_run
    from ..analyses.noise import noise as noise_run
    from ..analyses.tran import tran as tran_run

    kw = an.args["kwargs"]

    def val(key, default=None):
        num = _sp_num(kw[key]) if key in kw else None
        return default if num is None else num

    if an.kind in ("op", "dc"):
        return dc_run(cc, params)
    if an.kind == "tran":
        stop = val("stop")
        if stop is None:
            return None
        return tran_run(cc, (val("start", 0.0), stop), params,
                        dt=val("step", stop / 1000.0), dtmax=val("maxstep"))
    if an.kind == "ac":
        freqs = acdec(int(val("dec", 10)), val("start", 1.0),
                      val("stop", 1e9))
        return ac_run(cc, freqs, params)
    if an.kind == "noise":
        out = kw.get("out")
        freqs = acdec(int(val("dec", 10)), val("start", 1.0),
                      val("stop", 1e6))
        return noise_run(cc, out[1] if out else None, freqs, params)
    return None


def _sweep_values(kw):
    """A sweep's points from its keywords: values=[...], or start= and
    stop= with step=, lin= or dec= (11 linear points by default)."""
    if "values" in kw and kw["values"][0] == "vec":
        return [_sp_num(f) for f in kw["values"][1]]
    start = _sp_num(kw.get("start", ("word", "")))
    stop = _sp_num(kw.get("stop", ("word", "")))
    if start is None or stop is None:
        raise ElabError("sweep needs values=[...] or start=/stop=")
    if "step" in kw:
        step = _sp_num(kw["step"])
        return list(np.arange(start, stop + step * 0.5, step))
    if "lin" in kw:
        return list(np.linspace(start, stop, int(_sp_num(kw["lin"]))))
    if "dec" in kw:
        npts = int(round(np.log10(stop / start) * _sp_num(kw["dec"]))) + 1
        return list(np.geomspace(start, stop, npts))
    return list(np.linspace(start, stop, 11))


def _run_spectre_container(source, cc, el, an, *, include_dirs=(),
                           section=None, spec=None, device=DEFAULT_DEVICE):
    """`name sweep ... { children }` and `name montecarlo ... { children }`:
    the child analyses run once per point, one point after another.

    sweep: over a device parameter (`dev=r1 param=r`, or
    `param=inst.param`) through `cc.alter`, or over a netlist parameter by
    re-elaboration: a SPICE deck through `alter_text`, a Spectre deck by
    appending a `parameters` card (later cards win) where the deck
    declares the name. montecarlo: numruns re-elaborations, run i drawing
    the deck's statistical functions from `np.random.default_rng([seed,
    i])`; `statistics { vary }` blocks are not sampled. Every circuit a
    point re-elaborates is compiled on `device`."""
    kw = an.args["kwargs"]
    children = [Analysis(c.kind[8:], {"fields": c.fields,
                                      "kwargs": c.kwargs, "spectre": True})
                for c in kw.get("body") or []
                if isinstance(c, DotCard) and c.kind.startswith("spectre_")]

    def run_children(cc2, params=None):
        out = {}
        for a in children:
            sol = _run_spectre_analysis(cc2, a, params)
            if sol is not None:
                out[a.kind] = sol
        return out

    def rerun(src, rng=None):
        cir2, el2 = elaborate_netlist(src, include_dirs=include_dirs,
                                      section=section, rng=rng)
        return run_children(cir2.compile(spice_spec(el2, spec),
                                         device=device))

    if an.kind == "sweep":
        vals = _sweep_values(kw)
        dev, prm = kw.get("dev"), kw.get("param")
        if prm is None:
            raise ElabError("sweep needs param=")
        target = (f"{dev[1]}.{prm[1]}" if dev is not None
                  else str(prm[1])).lower()
        runs = []
        if target in cc.param_slots:
            base = cc.params0()
            for v in vals:
                runs.append(run_children(cc, cc.alter(
                    base, **{target: float(v)})))
            return {"param": target, "values": vals, "runs": runs}
        # a netlist parameter: the append is for a Spectre deck that
        # declares the name only; elsewhere it would give N identical runs
        appendable = el.dialect == "spectre" and target in el.param_names
        for v in vals:
            try:
                src2 = alter_text(source, {target: float(v)})
            except Exception as e:
                if not appendable:
                    raise ElabError(
                        f"sweep: unknown parameter {target!r} (not an "
                        "instance/model parameter, netlist .param, or "
                        "spectre parameters name)") from e
                src2 = str(source) + f"\nparameters {target}={float(v)}\n"
            runs.append(rerun(src2))
        return {"param": target, "values": vals, "runs": runs}

    if an.kind == "montecarlo":
        numruns = int(_sp_num(kw.get("numruns", ("word", "1"))) or 1)
        seed = int(_sp_num(kw.get("seed", ("word", "1"))) or 1)
        if el.statistics_cards:
            el._warn_once("mc_statistics",
                          "montecarlo: statistics{vary} sampling not "
                          "implemented; only deck distribution functions "
                          "(agauss/gauss/...) are randomized")
        runs = [rerun(source, np.random.default_rng([seed, i]))
                for i in range(numruns)]
        return {"numruns": numruns, "seed": seed, "runs": runs}
    return None
