"""SPICE expression parsing and evaluation.

Covers the expression scope of the reference's codegen
(`src/spc/codegen.jl:101-170` number literals with SPICE magnitudes;
expression translation incl. ternary and functions): arithmetic, comparisons,
ternary, the SPICE function library, and number literals with magnitude
suffixes (`1k`, `2.5u`, `1meg`, trailing unit letters ignored: `10pF`).

Expressions evaluate against a scope dict with plain Python floats during
elaboration (`eval_expr`), or as torch tensors for behavioral B-sources
(`eval_expr_traced`: every value a tensor, ternaries through torch.where,
comparisons as 0/1 masks; traceable by torch.func). The parser is the JAX
package's, copied (pure Python).
"""
from __future__ import annotations

import math
import re

_MAGNITUDES = {
    "t": 1e12, "g": 1e9, "meg": 1e6, "k": 1e3, "mil": 25.4e-6,
    "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15, "a": 1e-18,
}

_NUM_RE = re.compile(
    r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)([a-zA-Z]*)$")


def parse_number(tok: str):
    """SPICE number literal -> float, or None if not a number."""
    m = _NUM_RE.match(tok)
    if not m:
        return None
    val = float(m.group(1))
    suffix = m.group(2).lower()
    if suffix:
        if suffix.startswith("meg"):
            val *= 1e6
        elif suffix.startswith("mil"):
            val *= 25.4e-6
        elif suffix[0] in _MAGNITUDES and suffix[0] not in ("me", "mi"):
            val *= _MAGNITUDES[suffix[0]]
        # any remaining letters are units (V, F, Hz, ...) and are ignored
    return val


_TOKEN_RE = re.compile(
    r"\s*(?:(\*\*|&&|\|\||[<>=!]=|[-+*/^(),<>?:!])|"
    r"((?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?[a-zA-Z]*)|"
    r"(\$?[A-Za-z_][A-Za-z0-9_.]*))")


def tokenize_expr(s: str):
    out = []
    i = 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if not m:
            if s[i].isspace():
                i += 1
                continue
            raise ValueError(f"bad character {s[i]!r} in expression {s!r}")
        i = m.end()
        if m.group(1):
            out.append(("op", m.group(1)))
        elif m.group(2):
            v = parse_number(m.group(2))
            if v is None:
                raise ValueError(f"bad number {m.group(2)!r} in {s!r}")
            out.append(("num", v))
        else:
            # Spectre's $time / $temperature spell the same runtime
            # quantities as the bare names (asap7 bsource idiom)
            out.append(("name", m.group(3).lstrip("$")))
    return out


_FUNCS1 = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "asin": math.asin,
    "acos": math.acos, "atan": math.atan, "sinh": math.sinh,
    "cosh": math.cosh, "tanh": math.tanh, "exp": math.exp,
    "ln": math.log, "log": math.log, "log10": math.log10,
    "sqrt": math.sqrt, "abs": abs, "int": lambda x: float(int(x)),
    "nint": lambda x: float(round(x)), "floor": math.floor,
    "ceil": math.ceil, "sgn": lambda x: (x > 0) - (x < 0),
    "u": lambda x: 1.0 if x > 0 else 0.0,
    "uramp": lambda x: x if x > 0 else 0.0,
}
_FUNCS2 = {
    "pow": lambda a, b: a ** b,
    "pwr": lambda a, b: (abs(a) ** b) * ((a > 0) - (a < 0)),
    "min": min, "max": max, "atan2": math.atan2,
    "hypot": math.hypot, "mod": math.fmod,
}
_FUNCS3 = {
    "limit": lambda x, lo, hi: min(max(x, lo), hi),
}


class ExprError(ValueError):
    pass


class _Parser:
    """Pratt parser producing a small AST of tuples:
    ('num', v) ('name', n) ('call', fname, args) ('bin', op, a, b)
    ('un', op, a) ('cond', c, t, f)."""

    def __init__(self, tokens, src):
        self.toks = tokens
        self.i = 0
        self.src = src

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise ExprError(f"expected {op!r} in {self.src!r}, got {v!r}")

    def parse(self):
        e = self.ternary()
        if self.i != len(self.toks):
            raise ExprError(f"trailing tokens in {self.src!r}")
        return e

    def ternary(self):
        c = self.or_()
        k, v = self.peek()
        if k == "op" and v == "?":
            self.next()
            t = self.ternary()
            self.expect(":")
            f = self.ternary()
            return ("cond", c, t, f)
        return c

    def or_(self):
        a = self.and_()
        while self.peek() == ("op", "||"):
            self.next()
            a = ("bin", "||", a, self.and_())
        return a

    def and_(self):
        a = self.cmp()
        while self.peek() == ("op", "&&"):
            self.next()
            a = ("bin", "&&", a, self.cmp())
        return a

    def cmp(self):
        a = self.add()
        k, v = self.peek()
        if k == "op" and v in ("<", ">", "<=", ">=", "==", "!="):
            self.next()
            return ("bin", v, a, self.add())
        return a

    def add(self):
        a = self.mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                a = ("bin", v, a, self.mul())
            else:
                return a

    def mul(self):
        a = self.unary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/"):
                self.next()
                a = ("bin", v, a, self.unary())
            else:
                return a

    def unary(self):
        k, v = self.peek()
        if k == "op" and v in ("-", "+", "!"):
            self.next()
            return ("un", v, self.unary())
        return self.power()

    def power(self):
        a = self.atom()
        k, v = self.peek()
        if k == "op" and v in ("**", "^"):
            self.next()
            return ("bin", "**", a, self.unary())
        return a

    def atom(self):
        k, v = self.next()
        if k == "num":
            return ("num", v)
        if k == "op" and v == "(":
            e = self.ternary()
            self.expect(")")
            return e
        if k == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.ternary())
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.ternary())
                self.expect(")")
                return ("call", v.lower(), args)
            return ("name", v)
        raise ExprError(f"unexpected token {v!r} in {self.src!r}")


def parse_expr(s: str):
    return _Parser(tokenize_expr(s), s).parse()


def eval_expr(ast, scope, funcs=None):
    """Evaluate an expression AST against `scope` (case-insensitive names).
    `funcs` may add/override callables (e.g. v()/i() for behavioral
    sources, agauss for Monte Carlo)."""

    def ev(e):
        tag = e[0]
        if tag == "num":
            return e[1]
        if tag == "name":
            key = e[1].lower()
            if key in scope:
                return scope[key]
            raise ExprError(f"undefined parameter {e[1]!r}")
        if tag == "un":
            a = ev(e[2])
            return {"-": lambda x: -x, "+": lambda x: x,
                    "!": lambda x: 1.0 if x == 0 else 0.0}[e[1]](a)
        if tag == "bin":
            op = e[1]
            a = ev(e[2])
            b = ev(e[3])
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            if op == "**":
                return a ** b
            if op == "<":
                return 1.0 if a < b else 0.0
            if op == ">":
                return 1.0 if a > b else 0.0
            if op == "<=":
                return 1.0 if a <= b else 0.0
            if op == ">=":
                return 1.0 if a >= b else 0.0
            if op == "==":
                return 1.0 if a == b else 0.0
            if op == "!=":
                return 1.0 if a != b else 0.0
            if op == "&&":
                return 1.0 if (a != 0 and b != 0) else 0.0
            if op == "||":
                return 1.0 if (a != 0 or b != 0) else 0.0
            raise ExprError(op)
        if tag == "cond":
            return ev(e[2]) if ev(e[1]) != 0 else ev(e[3])
        if tag == "call":
            fname = e[1]
            args = [ev(a) for a in e[2]]
            if funcs and fname in funcs:
                return funcs[fname](*args)
            if fname in _FUNCS1 and len(args) == 1:
                return _FUNCS1[fname](args[0])
            if fname in _FUNCS2 and len(args) == 2:
                return _FUNCS2[fname](*args)
            if fname in _FUNCS3 and len(args) == 3:
                return _FUNCS3[fname](*args)
            raise ExprError(f"unknown function {fname!r}/{len(args)}")
        raise ExprError(f"bad AST node {e!r}")

    return ev(ast)


def eval_expr_traced(ast, scope, funcs=None):
    """Evaluate an AST with tensor semantics, traceable by torch.func:
    a ternary becomes torch.where, a comparison a float mask, and the
    function library its torch twin. Used for behavioral B-sources, where
    node voltages, currents and `time` are tensors (reference B-source
    expression transformation, `src/spc/codegen.jl:1226-1494`).

    Every number is promoted to an f64 tensor on the device of the
    scope's tensors, so that both arms of a `where` are tensors and no
    branch falls back to Python control flow."""
    import torch

    from ..config import DTYPE

    dev = next((v.device for v in scope.values()
                if isinstance(v, torch.Tensor)), None)

    def t(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.tensor(float(v), dtype=DTYPE, device=dev)

    one, zero = t(1.0), t(0.0)

    def mask(c):
        return torch.where(c, one, zero)

    F1 = {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
          "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
          "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
          "exp": torch.exp, "ln": torch.log, "log": torch.log,
          "log10": torch.log10, "sqrt": torch.sqrt, "abs": torch.abs,
          "int": torch.trunc, "nint": torch.round, "floor": torch.floor,
          "ceil": torch.ceil, "sgn": torch.sign,
          "u": lambda x: mask(x > 0),
          "uramp": lambda x: torch.maximum(x, zero)}
    F2 = {"pow": torch.pow,
          "pwr": lambda a, b: torch.pow(torch.abs(a), b) * torch.sign(a),
          "min": torch.minimum, "max": torch.maximum, "atan2": torch.atan2,
          "hypot": torch.hypot, "mod": torch.fmod}
    F3 = {"limit": lambda x, lo, hi: torch.minimum(torch.maximum(x, lo),
                                                   hi)}

    def ev(e):
        tag = e[0]
        if tag == "num":
            return t(e[1])
        if tag == "name":
            key = e[1].lower()
            if key in scope:
                return t(scope[key])
            raise ExprError(f"undefined parameter {e[1]!r}")
        if tag == "un":
            a = ev(e[2])
            if e[1] == "-":
                return -a
            if e[1] == "+":
                return a
            return mask(a == 0)
        if tag == "bin":
            op = e[1]
            a, b = ev(e[2]), ev(e[3])
            table = {
                "+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b, "/": lambda: a / b,
                "**": lambda: torch.pow(a, b),
                "<": lambda: mask(a < b), ">": lambda: mask(a > b),
                "<=": lambda: mask(a <= b), ">=": lambda: mask(a >= b),
                "==": lambda: mask(a == b), "!=": lambda: mask(a != b),
                "&&": lambda: mask((a != 0) & (b != 0)),
                "||": lambda: mask((a != 0) | (b != 0)),
            }
            return table[op]()
        if tag == "cond":
            return torch.where(ev(e[1]) != 0, ev(e[2]), ev(e[3]))
        if tag == "call":
            fname = e[1]
            args = [ev(a) for a in e[2]]
            if funcs and fname in funcs:
                return t(funcs[fname](*args))
            if fname in F1 and len(args) == 1:
                return F1[fname](args[0])
            if fname in F2 and len(args) == 2:
                return F2[fname](*args)
            if fname in F3 and len(args) == 3:
                return F3[fname](*args)
            raise ExprError(f"unknown function {fname!r}/{len(args)}")
        raise ExprError(f"bad AST node {e!r}")

    return ev(ast)


def expr_names(ast):
    """Free names referenced by an expression (for dependency toposort)."""
    out = set()

    def walk(e):
        if e[0] == "name":
            out.add(e[1].lower())
        elif e[0] == "call":
            for a in e[2]:
                walk(a)
        elif e[0] == "bin":
            walk(e[2])
            walk(e[3])
        elif e[0] == "un":
            walk(e[2])
        elif e[0] == "cond":
            walk(e[1])
            walk(e[2])
            walk(e[3])

    walk(ast)
    return out
