"""Verilog-A parser: preprocessed text -> module ASTs.

Grammar scope mirrors what the reference's VA front end consumes
(NyanVerilogAParser + `src/vasim.jl`): module/endmodule with port
directions, electrical/custom disciplines, branch declarations, parameter
real/integer (with range qualifiers, parsed and kept), real/integer
variables (with optional (* desc *) attributes -> op-vars), analog blocks
with begin/end, if/else, for, while, repeat, case, contribution statements
(`V(a,b) <+ expr`, `I(a) <+ expr`), procedural assignments, analog
functions, and system tasks ($strobe/$display ignored at runtime).

Expressions reuse a Pratt parser over VA tokens: all arithmetic/logical
ops, ternary, function calls, access functions V()/I(), analog operators
ddt/idt/ddx/white_noise/flicker_noise/limexp/$limit/$temperature/$vt/
$param_given/$simparam/$table_model, and number literals with VA scale
suffixes (T G M K m u n p f a).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

VA_MAGNITUDES = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "k": 1e3,
                 "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15,
                 "a": 1e-18}


class VAParseError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<attr>\(\*.*?\*\))
  | (?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?[TGMKkmunpfa]?(?![\w.]))
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<sysid>\$[a-zA-Z_][\w$]*)
  | (?P<id>[a-zA-Z_][\w$]*)
  | (?P<op><\+|<<<|>>>|<<|>>|<=|>=|==|!=|&&|\|\||\*\*|[-+*/%<>!&|^~?:;,.()\[\]{}=@#])
""", re.X | re.S)

KEYWORDS = {
    "module", "endmodule", "macromodule", "analog", "begin", "end", "if",
    "else", "for", "while", "repeat", "case", "casex", "casez", "endcase",
    "default", "parameter", "localparam", "real", "integer", "string",
    "inout", "input", "output", "electrical", "branch", "from", "exclude",
    "function", "endfunction", "nature", "endnature", "discipline",
    "enddiscipline", "aliasparam", "genvar", "ground", "inf",
}


def tokenize(text: str):
    toks = []
    line = 1
    i = 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise VAParseError(f"line {line}: bad character {text[i]!r}")
        line += text.count("\n", i, m.end())
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group(0), line))
    toks.append(("eof", "", line))
    return toks


# ---------------------------------------------------------------------------
# AST

@dataclasses.dataclass
class VAModule:
    name: str
    ports: list                       # [(name, direction)]
    disciplines: dict                 # net name -> discipline
    parameters: dict                  # name -> VAParam
    aliases: dict                     # alias -> target param
    variables: dict                   # name -> ('real'|'integer', attrs)
    branches: dict                    # name -> (p, n)
    internal_nodes: list              # electrical nets not in ports
    analog: list                      # statements
    functions: dict                   # name -> VAFunction
    # child module instantiations: (submodule, inst_name, nets, overrides)
    instances: list = dataclasses.field(default_factory=list)
    # vector nets: base name -> (lo, hi) (expanded to name__k scalars by
    # the parser's bus post-pass)
    buses: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class VAParam:
    name: str
    ptype: str                        # 'real' | 'integer' | 'string'
    default: tuple                    # expression AST
    ranges: list                      # [(op, lo, hi)] informational
    units: str = ""
    desc: str = ""


@dataclasses.dataclass
class VAFunction:
    name: str
    ftype: str
    args: list                        # [(name, 'input'|'output'|'inout')]
    locals: dict
    body: list

    @property
    def inputs(self):
        return [nm for nm, _ in self.args]


# statements are tuples:
# ('contrib', access('V'|'I'), (p[,n]), expr)
# ('assign', name_or_indexed, expr)
# ('if', cond, then_stmts, else_stmts)
# ('for', init_stmt, cond, step_stmt, body)
# ('while', cond, body)
# ('repeat', count_expr, body)
# ('case', expr, [(matches|None, stmts)])
# ('sys', name, args)   e.g. $strobe
# ('block', stmts)
# expressions are tuples like the SPICE ones:
# ('num', v) ('name', n) ('call', fn, args) ('acc', 'V'|'I', nets)
# ('sysfn', name, args) ('bin', op, a, b) ('un', op, a) ('cond', c, t, f)
# ('str', s)


def _expand_buses(m: VAModule):
    """Scalarize vector nets: a bus `name` of range (lo, hi) becomes
    scalars name__lo..name__hi everywhere — ports (order preserved),
    discipline table, internal nodes, and child-instance connections
    (a bare bus connection expands to all members; ('slice', nm, a, b)
    to that sub-range). Analog-block accesses were scalarized at parse
    (OptE(x[2]) -> x__2)."""
    if not m.buses:
        return

    def widen(nm):
        if nm in m.buses:
            lo, hi = m.buses[nm]
            step = 1 if hi >= lo else -1
            return [f"{nm}__{k}" for k in range(lo, hi + step, step)]
        return [nm]

    ports = []
    for nm, d in m.ports:
        ports.extend((x, d) for x in widen(nm))
    m.ports = [list(p) for p in ports]
    disc = {}
    for nm, d in m.disciplines.items():
        for x in widen(nm):
            disc[x] = d
    m.disciplines = disc
    nodes = []
    for nm in m.internal_nodes:
        nodes.extend(widen(nm))
    m.internal_nodes = nodes
    insts = []
    for (sub, inst, nets, overrides) in m.instances:
        flat = []
        for c in nets:
            if isinstance(c, tuple) and c and c[0] == "slice":
                _, nm, a, b = c
                step = 1 if b >= a else -1
                flat.extend(f"{nm}__{k}" for k in range(a, b + step, step))
            else:
                flat.extend(widen(c))
        insts.append((sub, inst, flat, overrides))
    m.instances = insts


class Parser:
    def __init__(self, toks, src=""):
        self.toks = toks
        self.i = 0
        # custom disciplines (photonics etc.): nature access fn -> V/I
        # semantics, built while parsing nature/discipline blocks
        self.natures = {}
        self.disc_names = set()
        # standard disciplines.vams access functions (the header is a
        # builtin no-op include): electrical V/I, thermal Temp/Pwr
        # (PSP103T self-heating uses Temp(br_rth)/Pwr(br_ith)),
        # kinematic/rotational/magnetic for completeness
        self.acc_kind = {"V": "V", "I": "I",
                         "Temp": "V", "Pwr": "I",
                         "Pos": "V", "F": "I",
                         "Theta": "V", "Tau": "I",
                         "MMF": "V", "Phi": "I"}

    # ---- token helpers
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, val):
        return self.peek()[1] == val

    def accept(self, val):
        if self.at(val):
            return self.next()
        return None

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise VAParseError(
                f"line {t[2]}: expected {val!r}, got {t[1]!r}")
        return t

    def ident(self):
        t = self.next()
        if t[0] != "id":
            raise VAParseError(f"line {t[2]}: expected identifier, "
                               f"got {t[1]!r}")
        return t[1]

    def _nature(self):
        """Parse a nature block: collect access/abstol/units (reference
        build_access_map, `src/vasim.jl:3997` — custom disciplines like
        the photonic models' optical nets)."""
        self.next()
        nname = self.ident()
        fields = {}
        while not self.at("endnature") and self.peek()[0] != "eof":
            t = self.next()
            if t[0] == "id" and self.peek()[1] == "=":
                self.next()
                toks = []
                while self.peek()[1] != ";" and self.peek()[0] != "eof":
                    toks.append(self.next()[1])
                self.accept(";")
                fields[t[1]] = toks[0] if len(toks) == 1 else toks
        self.expect("endnature")
        self.natures[nname] = fields

    def _discipline(self):
        self.next()
        dname = self.ident()
        self.disc_names.add(dname)
        while not self.at("enddiscipline") and self.peek()[0] != "eof":
            t = self.next()
            if t[1] in ("potential", "flow") and self.peek()[0] == "id":
                nat = self.ident()
                self.accept(";")
                acc = self.natures.get(nat, {}).get("access")
                # never remap the electrical builtins: disciplines.vams
                # defines single-nature 'voltage'/'current' disciplines
                # where Current appears as a POTENTIAL
                if acc and acc not in ("V", "I"):
                    self.acc_kind[acc] = ("V" if t[1] == "potential"
                                          else "I")
        self.expect("enddiscipline")

    # ---- top level
    def parse_file(self):
        mods = []
        while self.peek()[0] != "eof":
            t = self.peek()
            if t[1] in ("module", "macromodule"):
                mods.append(self.module())
            elif t[1] == "nature":
                self._nature()
            elif t[1] == "discipline":
                self._discipline()
            else:
                self.next()   # stray tokens between modules
        return mods

    def skip_until(self, end):
        while self.peek()[0] != "eof" and not self.at(end):
            self.next()
        self.accept(end)

    def module(self) -> VAModule:
        self.next()  # module
        name = self.ident()
        m = VAModule(name=name, ports=[], disciplines={}, parameters={},
                     aliases={}, variables={}, branches={},
                     internal_nodes=[], analog=[], functions={})
        if self.accept("("):
            while not self.at(")"):
                t = self.next()
                if t[0] == "id" and t[1] not in ("input", "output", "inout",
                                                 "electrical"):
                    m.ports.append([t[1], "inout"])
                self.accept(",")
            self.expect(")")
        self.accept(";")
        port_names = {p[0] for p in m.ports}
        while not self.at("endmodule") and self.peek()[0] != "eof":
            self.module_item(m, port_names)
        self.expect("endmodule")
        _expand_buses(m)
        return m

    def module_item(self, m: VAModule, port_names):
        t = self.peek()
        attrs = ""
        if t[0] == "attr":
            attrs = self.next()[1]
            t = self.peek()
        w = t[1]
        if w in ("input", "output", "inout"):
            self.next()
            rng = self.bus_range()
            while True:
                nm = self.ident()
                if rng is not None:
                    m.buses[nm] = rng
                for p in m.ports:
                    if p[0] == nm:
                        p[1] = w
                if not self.accept(","):
                    break
            self.expect(";")
        elif w == "electrical" or (t[0] == "id" and w not in KEYWORDS and
                                   (self.peek(1)[0] == "id"
                                    or self.peek(1)[1] == "[") and
                                   self._looks_discipline(w)):
            disc = self.next()[1]
            rng = self.bus_range()
            while True:
                nm = self.ident()
                if rng is not None:
                    m.buses[nm] = rng
                m.disciplines[nm] = disc
                if nm not in port_names:
                    m.internal_nodes.append(nm)
                if not self.accept(","):
                    break
            self.expect(";")
        elif w == "branch":
            self.next()
            self.expect("(")
            p = self.ident()
            n = self.ident() if self.accept(",") else None
            self.expect(")")
            bn = self.ident()
            m.branches[bn] = (p, n)
            while self.accept(","):
                bn = self.ident()
                m.branches[bn] = (p, n)
            self.expect(";")
        elif w in ("parameter", "localparam"):
            self.next()
            ptype = "real"
            if self.peek()[1] in ("real", "integer", "string"):
                ptype = self.next()[1]
            while True:
                nm = self.ident()
                self.expect("=")
                default = self.expr()
                ranges = []
                while self.peek()[1] in ("from", "exclude"):
                    op = self.next()[1]
                    ranges.append((op, self.range_spec(op)))
                units, desc = _attr_info(attrs)
                m.parameters[nm] = VAParam(nm, ptype, default, ranges,
                                           units, desc)
                if not self.accept(","):
                    break
            self.expect(";")
        elif w == "aliasparam":
            self.next()
            alias = self.ident()
            self.expect("=")
            target = self.ident()
            self.expect(";")
            m.aliases[alias] = target
        elif w in ("real", "integer", "string"):
            self.next()
            while True:
                nm = self.ident()
                # array decl: real x[0:5] — record and skip dims
                if self.accept("["):
                    while not self.at("]"):
                        self.next()
                    self.expect("]")
                init = self.expr() if self.accept("=") else None
                m.variables[nm] = (w, attrs, init)
                if not self.accept(","):
                    break
            self.expect(";")
        elif w == "analog":
            self.next()
            if self.peek()[1] == "function":
                m.functions.update([self.function()])
            else:
                m.analog.append(self.statement())
        elif w == "genvar":
            self.next()
            while self.peek()[1] != ";":
                self.next()
            self.expect(";")
        elif (t[0] == "id" and w not in KEYWORDS
              and (self.peek(1)[0] == "id" or self.peek(1)[1] == "#")):
            # module instantiation: sub [#(.p(v), ...)] inst (n1, n2, ...);
            sub = self.ident()
            overrides = {}
            if self.accept("#"):
                self.expect("(")
                while not self.at(")"):
                    self.expect(".")
                    pname = self.ident()
                    self.expect("(")
                    overrides[pname] = self.expr()
                    self.expect(")")
                    self.accept(",")
                self.expect(")")
            inst = self.ident()
            self.expect("(")
            nets = []

            def conn():
                nm = self.ident()
                if self.accept("["):
                    a = int(float(self.next()[1]))
                    if self.accept(":"):
                        b = int(float(self.next()[1]))
                        self.expect("]")
                        return ("slice", nm, a, b)
                    self.expect("]")
                    return f"{nm}__{a}"
                return nm

            if not self.at(")"):
                nets.append(conn())
                while self.accept(","):
                    nets.append(conn())
            self.expect(")")
            self.expect(";")
            m.instances.append((sub, inst, nets, overrides))
        else:
            raise VAParseError(f"line {t[2]}: unexpected {w!r} in module")

    def _looks_discipline(self, w):
        return (w in self.disc_names
                or w in ("electrical", "optical", "thermal", "kinematic",
                         "rotational", "magnetic", "voltage", "current"))

    def range_spec(self, op):
        # from [lo:hi] / from (lo:hi) / exclude val
        if self.peek()[1] in ("[", "("):
            open_t = self.next()[1]
            lo = self.expr()
            self.expect(":")
            hi = self.expr()
            t = self.next()  # ] or )
            return (open_t, lo, hi, t[1])
        return ("val", self.expr())

    def function(self):
        self.expect("function")
        ftype = "real"
        if self.peek()[1] in ("real", "integer"):
            ftype = self.next()[1]
        name = self.ident()
        self.accept(";")
        args = []                     # (name, direction) in declaration order
        locals_ = {}
        while self.peek()[1] in ("input", "output", "inout", "real",
                                 "integer"):
            kind = self.next()[1]
            names = []
            while True:
                nm = self.ident()
                if self.accept("["):      # array local: skip dims
                    while not self.at("]"):
                        self.next()
                    self.expect("]")
                names.append(nm)
                if not self.accept(","):
                    break
            self.expect(";")
            if kind in ("input", "output", "inout"):
                args.extend((nm, kind) for nm in names)
            else:
                arg_names = {a for a, _ in args}
                for nm in names:
                    if nm not in arg_names:
                        locals_[nm] = kind
        body = [self.statement()]
        self.expect("endfunction")
        return name, VAFunction(name, ftype, args, locals_, body)

    # ---- statements
    def statement(self):
        t = self.peek()
        if t[0] == "attr":
            self.next()
            t = self.peek()
        w = t[1]
        if w == "begin":
            self.next()
            if self.accept(":"):
                self.ident()  # named block
                # local declarations inside named blocks
                while self.peek()[1] in ("real", "integer"):
                    self.next()
                    while self.peek()[1] != ";":
                        self.next()
                    self.expect(";")
            stmts = []
            while not self.at("end"):
                stmts.append(self.statement())
            self.expect("end")
            return ("block", stmts)
        if w == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self.statement()
            els = None
            if self.accept("else"):
                els = self.statement()
            return ("if", cond, then, els)
        if w == "for":
            self.next()
            self.expect("(")
            init = self.simple_assign()
            self.expect(";")
            cond = self.expr()
            self.expect(";")
            step = self.simple_assign()
            self.expect(")")
            body = self.statement()
            return ("for", init, cond, step, body)
        if w == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            return ("while", cond, self.statement())
        if w == "repeat":
            self.next()
            self.expect("(")
            cnt = self.expr()
            self.expect(")")
            return ("repeat", cnt, self.statement())
        if w in ("case", "casex", "casez"):
            self.next()
            self.expect("(")
            sel = self.expr()
            self.expect(")")
            arms = []
            while not self.at("endcase"):
                if self.accept("default"):
                    self.accept(":")
                    arms.append((None, self.statement()))
                else:
                    matches = [self.expr()]
                    while self.accept(","):
                        matches.append(self.expr())
                    self.expect(":")
                    arms.append((matches, self.statement()))
            self.expect("endcase")
            return ("case", sel, arms)
        if w == ";":
            self.next()
            return ("block", [])
        if t[0] == "sysid":
            name = self.next()[1]
            args = []
            if self.accept("("):
                if not self.at(")"):
                    args.append(self.expr())
                    while self.accept(","):
                        args.append(self.expr())
                self.expect(")")
            self.expect(";")
            return ("sys", name, args)
        if w == "@":
            # event control @(initial_step) stmt — treat as always-run
            self.next()
            self.expect("(")
            depth = 1
            while depth:
                tt = self.next()[1]
                depth += tt == "("
                depth -= tt == ")"
            return ("event", self.statement())
        # access contribution or assignment
        if t[0] == "id" and self.peek(1)[1] == "(" \
                and t[1] in self.acc_kind:
            # could be contribution V(a,b) <+ ... or indirect assignment
            save = self.i
            acc = self.access()
            if self.accept("<+"):
                rhs = self.expr()
                self.expect(";")
                return ("contrib", acc[1], acc[2], rhs)
            self.i = save
        # statement-level analog function/task call with output args:
        # DEVqmeyer(vgs, ..., capgs, ...);  (reference vasim.jl:2519-2620)
        if t[0] == "id" and self.peek(1)[1] == "(":
            name = self.ident()
            self.expect("(")
            args = []
            if not self.at(")"):
                args.append(self.expr())
                while self.accept(","):
                    args.append(self.expr())
            self.expect(")")
            self.expect(";")
            return ("callstmt", name, args)
        st = self.simple_assign()
        self.expect(";")
        return st

    def simple_assign(self):
        nm = self.ident()
        if self.accept("["):
            idx = self.expr()
            self.expect("]")
            self.expect("=")
            return ("assign_idx", nm, idx, self.expr())
        self.expect("=")
        return ("assign", nm, self.expr())

    def access(self):
        kind = self.acc_kind[self.ident()]   # V/I or a custom access fn
        self.expect("(")
        nets = [self.net_ref()]
        if self.accept(","):
            nets.append(self.net_ref())
        self.expect(")")
        return ("acc", kind, tuple(nets))

    def net_ref(self):
        """A net reference, possibly a constant-indexed bus member
        (OptE(out[2]) -> 'out__2'). Bus indices must be literal ints."""
        nm = self.ident()
        if self.accept("["):
            t = self.next()
            if t[0] != "num":
                raise VAParseError(
                    f"line {t[2]}: bus index must be a literal integer")
            idx = int(float(t[1]))
            self.expect("]")
            return f"{nm}__{idx}"
        return nm

    def bus_range(self):
        """Optional [lo:hi] range; returns (lo, hi) or None."""
        if not self.accept("["):
            return None
        lo = int(float(self.next()[1]))
        self.expect(":")
        hi = int(float(self.next()[1]))
        self.expect("]")
        return (lo, hi)

    # ---- expressions (Pratt)
    def expr(self):
        return self.ternary()

    def ternary(self):
        c = self.lor()
        if self.accept("?"):
            t = self.ternary()
            self.expect(":")
            f = self.ternary()
            return ("cond", c, t, f)
        return c

    def lor(self):
        a = self.land()
        while self.at("||"):
            self.next()
            a = ("bin", "||", a, self.land())
        return a

    def land(self):
        a = self.bor()
        while self.at("&&"):
            self.next()
            a = ("bin", "&&", a, self.bor())
        return a

    def bor(self):
        a = self.bxor()
        while self.at("|") and self.peek(1)[1] != "|":
            self.next()
            a = ("bin", "|", a, self.bxor())
        return a

    def bxor(self):
        a = self.band()
        while self.at("^"):
            self.next()
            a = ("bin", "^", a, self.band())
        return a

    def band(self):
        a = self.eq()
        while self.at("&") and self.peek(1)[1] != "&":
            self.next()
            a = ("bin", "&", a, self.eq())
        return a

    def eq(self):
        a = self.rel()
        while self.peek()[1] in ("==", "!="):
            op = self.next()[1]
            a = ("bin", op, a, self.rel())
        return a

    def rel(self):
        a = self.shift()
        while self.peek()[1] in ("<", ">", "<=", ">="):
            op = self.next()[1]
            a = ("bin", op, a, self.shift())
        return a

    def shift(self):
        a = self.add()
        while self.peek()[1] in ("<<", ">>"):
            op = self.next()[1]
            a = ("bin", op, a, self.add())
        return a

    def add(self):
        a = self.mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            a = ("bin", op, a, self.mul())
        return a

    def mul(self):
        a = self.unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            a = ("bin", op, a, self.unary())
        return a

    def unary(self):
        t = self.peek()
        if t[1] in ("-", "+", "!", "~"):
            self.next()
            return ("un", t[1], self.unary())
        return self.power()

    def power(self):
        a = self.atom()
        if self.at("**"):
            self.next()
            return ("bin", "**", a, self.unary())
        return a

    def atom(self):
        t = self.next()
        kind, val = t[0], t[1]
        if kind == "num":
            return ("num", parse_va_number(val))
        if kind == "str":
            return ("str", val[1:-1])
        if val == "(":
            e = self.expr()
            self.expect(")")
            return e
        if val == "{":
            items = []
            if not self.at("}"):
                items.append(self.expr())
                while self.accept(","):
                    items.append(self.expr())
            self.expect("}")
            return ("array", items)
        if kind == "sysid":
            args = []
            if self.accept("("):
                if not self.at(")"):
                    args.append(self.expr())
                    while self.accept(","):
                        args.append(self.expr())
                self.expect(")")
            return ("sysfn", val, args)
        if kind == "id":
            if val == "inf":
                return ("num", float("inf"))
            if self.at("("):
                if val in self.acc_kind:
                    self.i -= 1
                    return self.access()
                self.next()
                args = []
                if not self.at(")"):
                    args.append(self.expr())
                    while self.accept(","):
                        args.append(self.expr())
                self.expect(")")
                return ("call", val, args)
            if self.at("["):
                self.next()
                idx = self.expr()
                self.expect("]")
                return ("index", val, idx)
            return ("name", val)
        raise VAParseError(f"line {t[2]}: unexpected token {val!r}")


def parse_va_number(tok: str) -> float:
    if tok and tok[-1] in VA_MAGNITUDES and not tok[-1].isdigit():
        return float(tok[:-1]) * VA_MAGNITUDES[tok[-1]]
    return float(tok)


def _attr_info(attrs: str):
    units = desc = ""
    if attrs:
        mu = re.search(r'units\s*=\s*"([^"]*)"', attrs)
        md = re.search(r'desc\s*=\s*"([^"]*)"', attrs)
        units = mu.group(1) if mu else ""
        desc = md.group(1) if md else ""
    return units, desc


def parse_va(text: str, include_dirs=()):
    """Preprocess + parse VA source -> list of VAModule."""
    from .preproc import Preprocessor

    pp = Preprocessor(include_dirs)
    clean = pp.process(text)
    return Parser(tokenize(clean)).parse_file()
