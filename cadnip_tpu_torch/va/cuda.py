"""Verilog-A -> CUDA device functions for kernel K2.

`emit(model)` turns a compiled `va:` DeviceModel (the compiler's unknown
layout, parameter order and statements, `model.va_compiler`) into one C++
struct of the form of `ops/csrc/devices.cuh`'s models: `NL` local
unknowns, no limiter, and

    template <typename T>
    __device__ static void residual(const T* u, const double* p, double v,
                                    const Dyn& d, T* f, T* q);

over double and `Dual<NL>` (K2 takes the local Jacobians J and C from the
dual numbers, as for every built-in model). It walks the analog block as
the torch interpreter of `codegen.py` does and writes each of its
operations as one line of C++, in its order, so that K2 computes what its
twin computes:

  * the safe math (`_safe_exp` with its knee at 85, `limexp`, `_safe_ln`,
    `_safe_sqrt`, `_safe_div`, `_safe_pow`), `abs`, `min`, `max` and
    `tanh` through `ops/csrc/va_math.cuh`, with torch's derivative at each
    kink;
  * both arms of every conditional evaluated and merged by a select,
    variables and contributions alike, under the interpreter's masks;
  * operations on constants folded here, by the interpreter's own
    functions (the same f64 arithmetic);
  * `ddt(x)`: the interpreter evaluates the block in a Laplace variable s
    with ddt(x) = s x and takes (f, q) as the block at s = 0 and its
    derivative in s. Each value here is that pair: its part at s = 0,
    which goes to f, and its s-coefficient, which goes to q. A ddt in a
    position that is not linear in s is refused;
  * `white_noise` and `flicker_noise` emit nothing: a transient has no
    noise.

An instance's parameter row (`EmittedModel.rows`) holds its effective
parameter values, in the compiler's parameter order, with the defaults and
`$param_given` resolved here on the host by the compiler's own pass, then
one given-flag column per parameter that `$param_given` reads in the
block; the device code only reads p[k].

What the emitter does not cover is refused with its reason
(`VACompileError`), and `ops/vmem_tran.py::supported` refuses the circuit:
`$limit`, absdelay, idt, the laplace filters, `$table_model`, ddx, loops,
case, arrays, analog functions, voltage contributions (branch unknowns),
models with a hoisted host setup (`va_setup`, central-difference
Jacobians), `$abstime`, `$simparam`, `analysis()`, more than `MAX_NL`
local unknowns, and every function and operator that no test holds to
the twin (the trigonometric and hyperbolic functions but tanh, log10,
floor, ceil, atan2, hypot, transition, slew, `%` and the bitwise
operators).

`header(emitted)` writes the library's header, `va_models.cuh`: the
structs of a circuit's Verilog-A models and their dispatch
`va_eval_model`, under model ids from `FIRST_ID` on.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from ..config import DTYPE
from ..mna.spec import KB, QE, DynSpec
from .codegen import (_F1, _F2, _VA_CONSTANTS, VACompileError, _fold,
                      _limexp, _traced_binop)

#: the most local unknowns of a device function (csrc/devices.cuh MAX_NL)
MAX_NL = 5
#: the first model id of an emitted model, after devices.cuh's BJT (13)
FIRST_ID = 14

#: one-operand functions: VA name -> va_math.cuh function. Each is held to
#: the twin by tests/test_torch_va_cuda.py; any other function is refused
#: (add one back with such a test when a model needs it)
_FN1 = {"exp": "exp85", "ln": "ln", "sqrt": "sqrt_", "abs": "abs_",
        "tanh": "tanh_"}
_FN2 = {"pow": "pow_", "min": "min_", "max": "max_"}
_CMP = {"<", ">", "<=", ">=", "==", "!="}
_REFUSED_CALLS = {
    "idt": "idt (an integrator state)", "idtmod": "idt (an integrator "
    "state)", "laplace_nd": "the laplace filters",
    "laplace_zp": "the laplace filters", "laplace_np": "the laplace filters",
    "laplace_zd": "the laplace filters", "absdelay": "absdelay",
    "ddx": "ddx", "analysis": "analysis() (K2's device functions take no "
    "analysis mode)"}


class _C:
    """A value computed by the emitted code: its C++ expression and whether
    it depends on the unknowns (type T) or only on parameters and
    constants (double)."""

    __slots__ = ("code", "dual")

    def __init__(self, code, dual):
        self.code, self.dual = code, dual


def _lit(x) -> str:
    """A Python number as a C++ double literal that reads back exactly."""
    x = float(x)
    if math.isnan(x):
        return "NAN"
    if math.isinf(x):
        return "INFINITY" if x > 0 else "(-INFINITY)"
    s = repr(x)
    if "e" not in s and "." not in s:
        s += ".0"
    return f"({s})" if s.startswith("-") else s


def _isnum(x):
    return isinstance(x, (bool, int, float))


class _Env:
    __slots__ = ("vars", "contrib", "mask")

    def __init__(self, n_local):
        self.vars = {}
        self.contrib = [(0.0, None)] * n_local
        self.mask = 1.0


class _Emitter:
    """One walk of a module's analog block, writing C++ lines."""

    def __init__(self, comp):
        self.comp = comp
        self.lines = []
        self.n_tmp = 0
        self.cse = {}
        self.p_index = {nm: k for k, nm in enumerate(comp.param_order)}
        self.given = []

    # ---- scalars: a Python number or a _C

    def code(self, x, dual):
        """x's C++ expression, lifted to T where `dual` and x is not."""
        if _isnum(x):
            return f"T({_lit(x)})" if dual else _lit(x)
        return f"T({x.code})" if dual and not x.dual else x.code

    def tmp(self, expr, dual, key=None):
        if key is not None and key in self.cse:
            return self.cse[key]
        name = f"t{self.n_tmp}"
        self.n_tmp += 1
        self.lines.append(f"const {'T' if dual else 'double'} {name} = "
                          f"{expr};")
        v = _C(name, dual)
        if key is not None:
            self.cse[key] = v
        return v

    @staticmethod
    def key(x):
        return ("c", float(x)) if _isnum(x) else x.code

    def sbin(self, op, a, b):
        """One binary operation of the interpreter's `_traced_binop`."""
        if _isnum(a) and _isnum(b):
            return _traced_binop(op, a, b)
        key = ("b", op, self.key(a), self.key(b))
        dual = (not _isnum(a) and a.dual) or (not _isnum(b) and b.dual)
        if op in ("+", "-", "*"):
            return self.tmp(f"{self.code(a, False)} {op} "
                            f"{self.code(b, False)}", dual, key)
        if op == "/":
            if _isnum(b):
                # _safe_div with a constant divisor selects statically
                if b == 0:
                    return 0.0
                return self.tmp(f"{self.code(a, False)} / {_lit(b)}", dual,
                                key)
            return self.tmp(f"va::div({self.code(a, dual)}, "
                            f"{self.code(b, dual)})", dual, key)
        if op == "**":
            return self.tmp(f"va::pow_({self.code(a, dual)}, "
                            f"{self.code(b, dual)})", dual, key)
        if op in _CMP:
            return self.tmp(f"double(val({self.code(a, False)}) {op} "
                            f"val({self.code(b, False)}))", False, key)
        if op in ("&&", "||"):
            c = "&" if op == "&&" else "|"
            return self.tmp(f"double((val({self.code(a, False)}) != 0.0) "
                            f"{c} (val({self.code(b, False)}) != 0.0))",
                            False, key)
        raise VACompileError(f"the operator {op!r}")

    def times(self, a, b):
        """codegen._times on masks: a constant 1 multiplies nothing."""
        if _isnum(b) and b == 1:
            return a
        if _isnum(a) and a == 1:
            return b
        return self.sbin("*", a, b)

    def sneg(self, a):
        if _isnum(a):
            return _fold(lambda x: -x, a)
        return self.tmp(f"-{a.code}", a.dual, ("u-", a.code))

    def sflag(self, a, op="!="):
        """_flag(a != 0) (or == 0): a double 0 or 1."""
        if _isnum(a):
            return float((a != 0) if op == "!=" else (a == 0))
        return self.tmp(f"double(val({a.code}) {op} 0.0)", False,
                        ("f" + op, a.code))

    def ssel(self, c, a, b):
        """torch.where(c != 0, a, b) for a condition value c (0 or 1)."""
        if _isnum(c):
            return a if c != 0 else b
        dual = (not _isnum(a) and a.dual) or (not _isnum(b) and b.dual)
        return self.tmp(f"va::sel(val({c.code}) != 0.0, {self.code(a, dual)}"
                        f", {self.code(b, dual)})", dual,
                        ("s", c.code, self.key(a), self.key(b)))

    def sfn(self, fn, args):
        if all(_isnum(a) for a in args):
            table = _F1 if len(args) == 1 else _F2
            return _fold(table[fn], *args)
        dual = any(not _isnum(a) and a.dual for a in args)
        name = (_FN1 if len(args) == 1 else _FN2)[fn]
        return self.tmp(f"va::{name}("
                        + ", ".join(self.code(a, dual) for a in args) + ")",
                        dual, ("fn", fn) + tuple(self.key(a) for a in args))

    # ---- values: (part at s = 0, s-coefficient or None)

    def binop(self, op, a, b):
        (af, aq), (bf, bq) = a, b
        f = self.sbin(op, af, bf)
        if op in _CMP or op in ("&&", "||") or (aq is None and bq is None):
            return f, None
        if op in ("+", "-"):
            if aq is None:
                q = bq if op == "+" else self.sneg(bq)
            elif bq is None:
                q = aq
            else:
                q = self.sbin(op, aq, bq)
            return f, q
        if op == "*" and (aq is None or bq is None):
            return f, (self.sbin("*", aq, bf) if bq is None
                       else self.sbin("*", af, bq))
        if op == "/" and bq is None:
            return f, self.sbin("/", aq, bf)
        raise VACompileError(f"ddt in a nonlinear position (operator "
                             f"{op!r})")

    def select(self, c, a, b):
        """_where(c != 0, a, b) on values."""
        f = self.ssel(c, a[0], b[0])
        if a[1] is None and b[1] is None:
            return f, None
        if _isnum(c):
            return f, (a[1] if c != 0 else b[1])
        return f, self.ssel(c, 0.0 if a[1] is None else a[1],
                            0.0 if b[1] is None else b[1])

    @staticmethod
    def plus(a, b):
        """codegen._plus on values: adding a constant 0 adds nothing."""
        def add(x, y):
            if y is None or (_isnum(y) and y == 0):
                return x
            if x is None or (_isnum(x) and x == 0):
                return y
            return ("+", x, y)
        return add(a[0], b[0]), add(a[1], b[1])

    def settle(self, v):
        """Emit the sums that `plus` left pending."""
        def go(x):
            if isinstance(x, tuple):
                return self.sbin("+", go(x[1]), go(x[2]))
            return x
        return go(v[0]), go(v[1])

    @staticmethod
    def real(v, what):
        if isinstance(v[0], str):
            raise VACompileError(f"a string value in {what}")
        return v

    # ---- statements

    def run(self, env, stmts):
        for st in stmts:
            self.stmt(st, env)

    def stmt(self, st, env):
        k = st[0]
        if k == "block":
            self.run(env, st[1])
        elif k == "assign":
            self.lines.append(f"// {st[1]}")
            env.vars[st[1]] = self.expr(st[2], env)
        elif k == "contrib":
            self.contrib(st, env)
        elif k == "if":
            cond = self.real(self.expr(st[1], env), "a condition")[0]
            self.masked(st[2], st[3], cond, env)
        elif k == "sys":
            pass
        elif k == "callstmt":
            if st[1] in self.comp.mod.functions:
                raise VACompileError(f"the analog function {st[1]!r}")
        elif k == "event":
            self.stmt(st[1], env)
        elif k in ("for", "while", "repeat"):
            raise VACompileError(f"a {k} loop")
        elif k == "case":
            raise VACompileError("a case statement")
        elif k == "assign_idx":
            raise VACompileError("an array variable")
        else:
            raise VACompileError(f"the statement {k!r}")

    def masked(self, then_st, else_st, cond, env):
        """codegen._exec_masked: both arms, merged by selects."""
        condf = self.sflag(cond)
        saved_vars, saved_mask = dict(env.vars), env.mask
        saved_contrib = env.contrib
        n = len(saved_contrib)
        env.mask = self.times(saved_mask, condf)
        env.contrib = [(0.0, None)] * n
        self.stmt(then_st, env)
        then_vars, then_contrib = env.vars, env.contrib
        env.vars = dict(saved_vars)
        env.contrib = [(0.0, None)] * n
        env.mask = self.times(saved_mask, self.sbin("-", 1.0, condf))
        if else_st is not None:
            self.stmt(else_st, env)
        else_vars, else_contrib = env.vars, env.contrib
        env.mask = saved_mask
        env.contrib = [self.plus(self.plus(a, b), c) for a, b, c in
                       zip(saved_contrib, then_contrib, else_contrib)]
        merged = dict(saved_vars)
        for key in sorted(set(then_vars) | set(else_vars)):
            tv = then_vars.get(key, saved_vars.get(key))
            ev = else_vars.get(key, saved_vars.get(key))
            if tv is None:
                merged[key] = ev
            elif ev is None or tv is ev:
                merged[key] = tv
            else:
                merged[key] = self.select(
                    condf, self.real(tv, key), self.real(ev, key))
        env.vars = merged

    def contrib(self, st, env):
        acc, nets, expr = st[1], st[2], st[3]
        if acc != "I":
            raise VACompileError("a voltage contribution (a branch unknown)")
        raw = self.real(self.expr(expr, env), "a contribution")
        m = env.mask
        if _isnum(m):
            val = raw if m != 0 else (0.0, None)
        else:
            val = self.select(m, self.binop("*", raw, (m, None)),
                              (0.0, None))
        mod = self.comp.mod
        if len(nets) == 1 and nets[0] in mod.branches:
            tgt = mod.branches[nets[0]]
        else:
            tgt = self.comp._branch_nets(nets)
        node = self.comp.node_idx
        c = list(env.contrib)
        c[node[tgt[0]]] = self.plus(c[node[tgt[0]]], val)
        env.contrib = c
        if tgt[1]:
            neg = (self.sneg(val[0]),
                   None if val[1] is None else self.sneg(val[1]))
            c = list(env.contrib)
            c[node[tgt[1]]] = self.plus(c[node[tgt[1]]], neg)
            env.contrib = c

    # ---- expressions

    def expr(self, e, env):
        tag = e[0]
        if tag == "num":
            return e[1], None
        if tag == "str":
            return e[1], None
        if tag == "name":
            nm = e[1]
            if nm in env.vars:
                return env.vars[nm]
            target = self.comp.mod.aliases.get(nm, nm)
            if target in self.p_index:
                return _C(f"p[{self.p_index[target]}]", False), None
            if nm in _VA_CONSTANTS:
                return _VA_CONSTANTS[nm], None
            raise VACompileError(f"undefined identifier {nm!r}")
        if tag == "acc":
            return self.access(e), None
        if tag == "un":
            v = self.real(self.expr(e[2], env), "an operand")
            if e[1] == "-":
                return self.sneg(v[0]), (None if v[1] is None
                                         else self.sneg(v[1]))
            if e[1] == "+":
                return v
            if e[1] == "!":
                return self.sflag(v[0], "=="), None
            raise VACompileError(f"the operator {e[1]!r}")
        if tag == "bin":
            a = self.real(self.expr(e[2], env), "an operand")
            b = self.real(self.expr(e[3], env), "an operand")
            return self.binop(e[1], a, b)
        if tag == "cond":
            c = self.real(self.expr(e[1], env), "a condition")[0]
            t = self.real(self.expr(e[2], env), "an operand")
            f = self.real(self.expr(e[3], env), "an operand")
            return self.select(c, t, f)
        if tag == "call":
            return self.call(e, env)
        if tag == "sysfn":
            return self.sysfn(e, env)
        if tag == "index":
            raise VACompileError("an array variable")
        raise VACompileError(f"the expression {tag!r}")

    def access(self, e):
        kind, nets = e[1], e[2]
        mod, node = self.comp.mod, self.comp.node_idx
        if kind != "V":
            if len(nets) == 1 and nets[0] in mod.branches:
                # a flow-contributed named branch reads 0 (codegen._access)
                return 0.0
            raise VACompileError("a branch current read (I() access)")
        if len(nets) == 1 and nets[0] in mod.branches:
            pn, nn = mod.branches[nets[0]]
        else:
            pn, nn = nets[0], (nets[1] if len(nets) > 1 else None)
        v = _C(f"u[{node[pn]}]", True)
        if nn is None:
            return v
        return self.tmp(f"u[{node[pn]}] - u[{node[nn]}]", True,
                        ("acc", node[pn], node[nn]))

    def call(self, e, env):
        fn, args = e[1], e[2]
        if fn == "ddt":
            x = self.real(self.expr(args[0], env), "ddt")
            if x[1] is not None:
                raise VACompileError("ddt in a nonlinear position (ddt of "
                                     "ddt)")
            return 0.0, x[0]
        if fn in ("white_noise", "flicker_noise"):
            return 0.0, None
        if fn in _REFUSED_CALLS:
            raise VACompileError(_REFUSED_CALLS[fn])
        if fn in self.comp.mod.functions:
            raise VACompileError(f"the analog function {fn!r}")
        vals = [self.real(self.expr(a, env), f"{fn}()") for a in args]
        if any(v[1] is not None for v in vals):
            raise VACompileError(f"ddt in a nonlinear position ({fn}())")
        xs = [v[0] for v in vals]
        if fn == "limexp" and len(xs) == 1:
            if _isnum(xs[0]):
                return _limexp(xs[0]), None
            return self.tmp(f"va::limexp({xs[0].code})", xs[0].dual,
                            ("limexp", xs[0].code)), None
        if (fn in _FN1 and len(xs) == 1) or (fn in _FN2 and len(xs) == 2):
            return self.sfn(fn, xs), None
        raise VACompileError(f"the function {fn!r}/{len(xs)}")

    def sysfn(self, e, env):
        name, args = e[1], e[2]
        if name == "$temperature":
            return _C("d.temp", False), None
        if name == "$vt":
            if args:
                t = self.real(self.expr(args[0], env), "$vt")[0]
                return self.sbin("/", self.sbin("*", KB, t), QE), None
            return _C("d.vt", False), None
        if name == "$param_given":
            pn = self.comp.mod.aliases.get(args[0][1], args[0][1])
            if pn not in self.given:
                self.given.append(pn)
            k = len(self.comp.param_order) + self.given.index(pn)
            return _C(f"p[{k}]", False), None
        if name in ("$strobe", "$display", "$debug", "$warning", "$error",
                    "$finish", "$fatal", "$stop", "$analog_node_alias"):
            return 0.0, None
        if name in ("$mfactor", "$port_connected"):
            return 1.0, None
        if name == "$abstime":
            raise VACompileError("$abstime (K2's device functions take no "
                                 "time)")
        raise VACompileError(name)


@dataclasses.dataclass(frozen=True, eq=False)
class EmittedModel:
    """One Verilog-A module as a K2 device function."""

    module: str
    n_local: int
    params: tuple     # the row's columns: parameters, then given flags
    body: str         # the struct's members (without its name)
    compiler: object

    def rows(self, params: dict, dyn: DynSpec) -> np.ndarray:
        """The instances' parameter rows [I, len(self.params)] from the
        group's parameter arrays ({name: [I]}, with `name__given`): the
        compiler's effective values (`effective_params`, on the host)."""
        comp = self.compiler
        p = {k: torch.as_tensor(np.asarray(v, np.float64), dtype=DTYPE)
             for k, v in params.items()
             if not isinstance(v, str) and k != "wave"}
        dyn = DynSpec(*(torch.as_tensor(f, dtype=DTYPE).detach().cpu()
                        for f in dyn))
        I = next(v.shape[0] for v in p.values() if v.ndim)
        eff = comp.effective_params(p, dyn)
        cols = [eff[nm] for nm in comp.param_order]
        cols += [p[nm + "__given"] for nm in self.params[len(cols):]]
        return np.stack([np.broadcast_to(
            np.asarray(torch.as_tensor(c, dtype=DTYPE)), (I,))
            for c in cols], 1) if cols else np.zeros((I, 0))


def _check(model, comp):
    """The constructs the emitter does not take, found before the walk."""
    if model.residual_lim is not None or comp.limit_sites:
        raise VACompileError("$limit")
    if model.va_setup is not None or comp.host_setup_enabled:
        raise VACompileError("a hoisted host setup (va_setup: "
                             "central-difference Jacobians)")
    if comp.vbranches:
        raise VACompileError("a voltage contribution (a branch unknown)")
    if comp.idt_sites:
        raise VACompileError("idt (an integrator state)")
    if comp.laplace_sites:
        raise VACompileError("the laplace filters")
    if comp.delay_sites:
        raise VACompileError("absdelay")
    if comp.ddx_sites:
        raise VACompileError("ddx")
    if comp.n_local > MAX_NL:
        raise VACompileError(f"{comp.n_local} local unknowns (K2 takes at "
                             f"most {MAX_NL})")
    for nm, par in comp.mod.parameters.items():
        if par.ptype == "string":
            raise VACompileError(f"the string parameter {nm!r}")

    def tables(e):
        if isinstance(e, tuple):
            if e[0] == "sysfn" and e[1] == "$table_model":
                raise VACompileError("$table_model")
            for s in e[1:]:
                tables(s)
        elif isinstance(e, list):
            for s in e:
                tables(s)
    tables(comp.mod.analog)


def _emit(model) -> EmittedModel:
    comp = model.va_compiler
    if comp is None:
        raise VACompileError("the model carries no Verilog-A compiler")
    _check(model, comp)
    em = _Emitter(comp)
    env = _Env(comp.n_local)
    for which in ("setup", "runtime"):
        for nm, vinfo in comp.mod.variables.items():
            init = vinfo[2] if len(vinfo) > 2 else None
            if init is not None and \
                    (which == "setup") != comp._expr_has_analog(init):
                env.vars[nm] = em.expr(init, env)
        em.run(env, comp.setup_stmts if which == "setup"
               else comp.runtime_stmts)
    outs = []
    for i, v in enumerate(env.contrib):
        f, q = em.settle(v)
        outs.append(f"f[{i}] = {em.code(f, True)};")
        outs.append(f"q[{i}] = {em.code(0.0 if q is None else q, True)};")
    mod = comp.mod
    ports = ", ".join(comp.ports)
    params = tuple(comp.param_order) + tuple(em.given)
    body = "\n".join(
        [f"  // Verilog-A module {mod.name}({ports}); p: "
         + ", ".join(params),
         f"  static constexpr int NL = {comp.n_local};",
         "  static constexpr bool LIMITED = false;",
         "  template <typename T>",
         "  __device__ static void residual(const T* u, const double* p, "
         "double,",
         "                                  const Dyn& d, T* f, T* q) {"]
        + [f"    {ln}" for ln in em.lines + outs] + ["  }"])
    return EmittedModel(module=mod.name, n_local=comp.n_local,
                        params=params, body=body, compiler=comp)


_cache = weakref.WeakKeyDictionary()


def emit(model) -> EmittedModel:
    """The model's device function; raises VACompileError with the reason
    where the emitter does not cover the model. Cached per model."""
    hit = _cache.get(model)
    if hit is None:
        try:
            hit = _emit(model)
        except VACompileError as e:
            hit = e
        _cache[model] = hit
    if isinstance(hit, VACompileError):
        raise hit
    return hit


def refusal(model):
    """Why the emitter does not take the model, or None."""
    try:
        emit(model)
    except VACompileError as e:
        return str(e)
    return None


def header(emitted) -> str:
    """The text of `va_models.cuh` for the emitted models, in order: model
    k is `VaModel<k>`, with id FIRST_ID + k."""
    out = ["// Verilog-A device functions of one K2 library, emitted by",
           "// cadnip_tpu_torch/va/cuda.py; included by devices.cuh under",
           "// CADNIP_VA_MODELS.",
           "#pragma once", "", '#include "va_math.cuh"', "",
           "namespace dev {", ""]
    for k, m in enumerate(emitted):
        out += [f"struct VaModel{k} {{", m.body, "};", ""]
    out += ["__device__ __forceinline__ bool va_eval_model(",
            "    int model, const double* u, const double* up, "
            "const double* p,",
            "    double v_src, const Dyn& d, double* f, double* q, "
            "double* J,",
            "    double* C, double* ue) {",
            "  switch (model) {"]
    for k in range(len(emitted)):
        out.append(f"    case {FIRST_ID + k}: eval_instance<VaModel{k}>("
                   "u, up, p, v_src, d, f, q, J, C, ue); return true;")
    out += ["    default: return false;", "  }", "}", "",
            "}  // namespace dev", ""]
    return "\n".join(out)
