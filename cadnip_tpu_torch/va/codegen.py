'''Verilog-A -> torch device compiler (PyTorch port of
`cadnip_tpu/va/codegen.py`).

Turns a parsed `VAModule` into a `DeviceModel` whose residual interprets
the analog block on torch tensors (the reference's `make_mna_device`,
`src/vasim.jl:201-584`). The host pre-pass (unknown layout, `$limit`,
ddx and noise discovery, the setup/runtime split, node-collapse
candidates, parameter order and numeric defaults) is the JAX package's,
copied; the interpreter emits torch operations branch for branch:

  * **ddt via jvp**: the analog block is evaluated as a function of a
    synthetic Laplace variable s with `ddt(x) := s*x`; then
    (f, q) = torch.func.jvp(block, (0,), (1,)) with a 0-d f64 primal on
    the unknowns' device (the reference's s-dual contribution trick,
    `src/mna/contrib.jl:356-375`).
  * **conditionals**: both branches are evaluated and merged with
    `torch.where` masks, variables AND contributions; no Python `if` on a
    tensor and no `.item()` in the traced pass, so the residual runs under
    `vmap(jacrev(...))`.
  * **parameter defaults**: effective values are computed from (value,
    given) pairs in dependency order, so `$param_given` and sweeps over VA
    parameters behave like the reference's DefaultOr system
    (`vasim.jl:480-569`).
  * **voltage contributions** allocate branch-current unknowns; internal
    nodes become internal voltage unknowns; `idt` allocates an integrator
    state with row d/dt y - x = 0.
  * **noise**: white_noise/flicker_noise sites are collected in a second
    interpretation pass, masks included (`vasim.jl:2825-2894`).

Values in the interpreter are Python numbers (literals, constants, folds
of them) or f64 tensors. An operation whose operands are all Python
numbers is evaluated on f64 CPU scalars and stays a Python number, so
constants never need a device; the contribution vector is a Python list
of per-row accumulators, stacked onto the unknowns' device at the end of
the pass (the JAX package's `.at[i].add` in the same order).

`$table_model` (1-D/2-D gridded interpolation, loaded at compile time),
the laplace_nd/zp/np/zd filters (controllable-canonical state-space with
extra internal unknowns), `idt` and `$limit` (pnjlim / fetlim / limvds
or a user-named function against the previous ITERATE's limited value)
are supported. `absdelay` is a transport delay: a probe pass
(`make_delay_probe`) records each site's instantaneous value and delay,
the transient runner keeps them in a history ring and feeds the residual
the interpolated past values through `p["__dly__"]`; DC, noise and any
evaluation without that leaf take the instantaneous value (the identity).
Loop trip counts and laplace coefficients must be host-evaluable from
parameter defaults, as in the JAX package.
'''
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import grad as _fgrad
from torch.func import jvp as _fjvp

from ..config import DTYPE
from ..mna.devices import CLASS_I, CLASS_V, DeviceModel, fetlim, limvds, \
    pnjlim
from ..mna.spec import KB, QE, MODE_AC, MODE_DCOP, MODE_TRAN, DynSpec, \
    SimSpec
from .parser import (VAFunction, VAModule, VAParam,
                     VAParseError, parse_va)


class VACompileError(ValueError):
    pass


# Operand plumbing. A value is a Python number or an f64 tensor (batched
# under vmap); torch needs a tensor where jnp takes either.

def _num(x):
    return isinstance(x, (bool, int, float))


def _fold(fn, *args):
    """fn over all-Python operands: evaluated on f64 CPU scalars and
    returned as a float (the value jnp gives); otherwise fn(*args)."""
    if all(_num(a) for a in args):
        return float(fn(*(torch.tensor(float(a), dtype=DTYPE)
                          for a in args)))
    return fn(*args)


def _tensor(x, ref):
    """x as an f64 tensor on the device of the tensor `ref`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=DTYPE, device=ref.device)


def _tensors(*xs):
    ref = next(x for x in xs if isinstance(x, torch.Tensor))
    return [_tensor(x, ref) for x in xs]


def _where(c, x, y):
    """jnp.where: a Python condition selects statically."""
    if not isinstance(c, torch.Tensor):
        return x if c else y
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = _tensor(x, c)
    return torch.where(c, x, y)


def _flag(c):
    """jnp.where(c, 1.0, 0.0)."""
    return c.to(DTYPE) if isinstance(c, torch.Tensor) else float(bool(c))


def _detach(x):
    """jax.lax.stop_gradient."""
    return x.detach() if isinstance(x, torch.Tensor) else x


def _plus(a, b):
    """a + b, where adding a Python 0.0 emits no operation (the value is
    the same but for the sign of a zero)."""
    if _num(b) and b == 0:
        return a
    if _num(a) and a == 0:
        return b
    return a + b


def _times(a, b):
    """a * b for masks: a Python 1.0 emits no operation (same value)."""
    if _num(b) and b == 1:
        return a
    if _num(a) and a == 1:
        return b
    return a * b


def _set(u, i, v):
    """u with element i replaced by v (jnp `u.at[i].set(v)`)."""
    return torch.cat([u[:i], v.reshape(1), u[i + 1:]])


def _stack(vals, zero):
    """Stack values (tensors or Python numbers) onto zero's device."""
    return torch.stack([v if isinstance(v, torch.Tensor) else zero + v
                        for v in vals])


# Domain-safe math. The interpreter evaluates BOTH sides of every VA `if`
# and merges with torch.where; models guard out-of-domain math (1/x, ln(x),
# sqrt(x)) with branches, so untaken branches routinely evaluate at invalid
# inputs. torch.where discards their VALUES, but NaN/inf can still leak
# into the residual through the derivatives (e.g. d(a/b) at b=0,
# sqrt'(0)*0, pow's log(a) term at a<=0). These wrappers keep values exact
# on the valid domain and make values AND derivatives finite off it (the
# VA-codegen analogue of the reference's NaNMath usage,
# `src/va_env.jl:33-55`). Each takes at least one tensor operand (all-number
# calls are folded by `_fold` first).

def _safe_div(a, b):
    bb = _where(b == 0, 1.0, b)
    return _where(b == 0, 0.0, a / bb)


def _safe_ln(x):
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), -690.0)


def _safe_log10(x):
    return torch.where(x > 0, torch.log10(torch.where(x > 0, x, 1.0)),
                       -300.0)


def _safe_sqrt(x):
    xs = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.sqrt(xs), 0.0)


def _pow_partials(a, b):
    # d/da: b*a^(b-1) - guard a=0 with b<1 (inf); d/db: v*ln(a) - guard a<=0.
    # v is recomputed, not the saved output, as the JAX rule recomputes it:
    # a derivative of this rule then meets the same pow as there
    v = torch.pow(a, b)
    ga = b * torch.pow(torch.where(a == 0, 1.0, a), b - 1.0)
    ga = torch.where(a == 0, torch.where(b >= 1, (b == 1).to(a.dtype),
                                         0.0), ga)
    gb = torch.where(a > 0, v * torch.log(torch.where(a > 0, a, 1.0)), 0.0)
    return ga, gb


class _SafePow(torch.autograd.Function):
    """a**b with the JAX package's custom JVP (`jax.custom_jvp`): finite
    partials at a = 0 and a < 0. Its jvp and backward are torch operations,
    so it composes under vmap, jacrev and jvp together, and their own
    derivatives are those of the JAX rule."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return torch.pow(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b = inputs
        ctx.save_for_backward(a, b)
        ctx.save_for_forward(a, b)

    @staticmethod
    def jvp(ctx, da, db):
        a, b = ctx.saved_tensors
        ga, gb = _pow_partials(a, b)
        return ga * da + gb * db

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = _pow_partials(a, b)
        return g * ga, g * gb


def _safe_pow(a, b):
    a, b = _tensors(a, b)
    a, b = torch.broadcast_tensors(a, b)
    return _SafePow.apply(a, b)


def _safe_exp(x):
    """exp with a linear continuation above x=85 (limexp shape).

    Exact on every physical device regime (exp(85) = 8.2e36; junction
    arguments stay below ~40). The JAX package keeps the knee for its TPU
    backend, whose emulated-f64 exp overflows at f32 range; the port keeps
    it too, so both packages evaluate the same function."""
    xc = torch.minimum(x, _tensor(85.0, x))
    return torch.exp(xc) * (1.0 + torch.maximum(x - 85.0, _tensor(0.0, x)))


def _abs(x):
    # jnp.abs: derivative +1 at 0 (torch.abs gives 0 there)
    return torch.where(x >= 0, x, -x)


def _minimum(a, b):
    return torch.minimum(*_tensors(a, b))


def _maximum(a, b):
    return torch.maximum(*_tensors(a, b))


def _clip(x, lo, hi):
    """jnp.clip: maximum then minimum, so a tie splits the derivative in
    half as there (torch.clamp passes all of it)."""
    return _minimum(hi, _maximum(lo, x))


# math function tables (torch, traced)
_F1 = {"exp": _safe_exp, "ln": _safe_ln, "log": _safe_log10,
       "log10": _safe_log10,
       "sqrt": _safe_sqrt, "abs": _abs, "sin": torch.sin, "cos": torch.cos,
       "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
       "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
       "tanh": torch.tanh, "floor": torch.floor, "ceil": torch.ceil}
_F2 = {"pow": _safe_pow, "min": _minimum, "max": _maximum,
       "atan2": lambda a, b: torch.atan2(*_tensors(a, b)),
       "hypot": lambda a, b: torch.hypot(*_tensors(a, b))}


def _limexp_t(x):
    # overflow-safe exp with linear continuation above x=80 (reference
    # va_env limexp, `src/va_env.jl`)
    xc = torch.minimum(x, _tensor(80.0, x))
    return torch.exp(xc) * (1.0 + torch.maximum(x - 80.0, _tensor(0.0, x)))


def _limexp(x):
    return _fold(_limexp_t, x)


def _cse_key(v):
    """Identity key for a CSE operand: python numbers by value, tensors by
    object id (the id is pinned alive by storing the operand in the cache
    entry, so recycling cannot alias)."""
    if isinstance(v, (int, float, bool)):
        return ("c", float(v))
    return id(v)


def _concrete(v):
    """A host float of v, or raise for a value the traced pass computes
    (the JAX package's tracer test, `float(tracer)` raising): a tensor is
    concrete only if it is 0-d and not a torch.func transform's wrapper."""
    if _num(v):
        return float(v)
    if isinstance(v, torch.Tensor) and v.ndim == 0 and \
            not torch._C._functorch.is_functorch_wrapped_tensor(v):
        return float(v)
    raise VACompileError("not a host value")


class _Env:
    """Interpreter state for one evaluation of the analog block."""

    __slots__ = ("vars", "contrib", "mask", "noise_acc", "compiler",
                 "lim_w", "lim_d", "lim_rec", "lim_vnew", "lim_wsite",
                 "vmask", "ddx_vals", "ddx_recording", "delay_rec", "cse")

    def __init__(self, compiler, n_local):
        self.vars = {}
        # value-numbering cache for pure math ops: evaluating BOTH
        # branches of every `if` re-derives shared subexpressions on
        # identical operand objects; keying on operand identity dedups them
        # (operands are pinned in the value so ids cannot be recycled)
        self.cse = {}
        # per-row accumulators (Python numbers or tensors)
        self.contrib = [0.0] * n_local
        self.mask = 1.0            # product of enclosing if-conditions
        self.noise_acc = []        # [(site_id, psd_value, exponent)]
        self.compiler = compiler
        # $limit machinery (set by make_residual_lim; None = unlimited eval)
        self.lim_w = None          # [B] per-branch limiter state in
        self.lim_d = None          # [S] per-site companion hook
        self.lim_rec = None        # {branch_idx: new state value}
        self.lim_vnew = None       # {site_idx: unlimited probe value}
        self.lim_wsite = None      # {site_idx: limited value}
        # ddx support: precomputed per-site derivatives (main pass) /
        # recording sink (jvp pre-pass sub-evaluation)
        self.ddx_vals = None
        self.ddx_recording = None
        # absdelay probe pass: {site_idx: (value_now, tau)} sink; None in
        # the residual pass (which reads p['__dly__'] instead)
        self.delay_rec = None
        # switch-branch bookkeeping: accumulated activation mask per
        # V-contribution branch unknown (LRM switch branches: a branch with
        # no active V contribution this evaluation is an OPEN branch, its
        # current unknown constrained to 0 — covers the conditional
        # `V(a,b) <+ 0` node-collapse idiom, reference vasim.jl:2723)
        self.vmask = {}

    def add(self, i, v):
        """contrib[i] += v (the JAX package's `contrib.at[i].add(v)`)."""
        c = list(self.contrib)
        c[i] = _plus(c[i], v)
        self.contrib = c


class VACompiler:
    """Compiles one VAModule. Host pre-pass discovers structure (unknown
    layout, contribution branches, noise sites); the traced interpreter
    only ever produces fixed-shape computations."""

    def __init__(self, mod: VAModule, include_dirs=(), collapsed=()):
        self.mod = mod
        self.include_dirs = list(include_dirs)
        self._tables = {}
        # set while host_setup evaluates eagerly: every tensor then counts
        # as traced for host evaluation, as the JAX package's jitted setup
        # pass sees tracers
        self._host_setup_pass = False
        # node-collapse specialization (reference detect_short_circuits,
        # `src/vasim.jl:2723`): branches in `collapsed` take the
        # `V(a,b) <+ 0` short-circuit path for this parameter signature —
        # ALL V-contributions to them are dropped (no branch-current
        # unknown) and the nodes are merged at elaboration via the
        # DeviceModel.collapses alias table.
        self.collapsed = frozenset(collapsed)
        self.ports = [p[0] for p in mod.ports]
        # unknown layout: ports, internal nodes, branch currents, idt states
        self.node_idx = {nm: i for i, nm in enumerate(self.ports)}
        nxt = len(self.ports)
        for nm in mod.internal_nodes:
            self.node_idx[nm] = nxt
            nxt += 1
        self.n_nodes = nxt
        # parameter order + numeric (structural) defaults come FIRST:
        # laplace coefficient arrays and loop bounds may reference them
        self.param_order = self._toposort_params()
        self._ndefaults = None
        self._ndefaults = self.numeric_defaults()
        # parameters whose values are baked into structure (loop bounds,
        # laplace coefficients): per-instance overrides cannot take effect
        self.structural_params = set()
        # discover voltage-contribution branches, idt and laplace sites
        self.vbranches = {}       # (p, n) -> current unknown index
        self.idt_sites = {}       # site id -> state unknown index
        self.laplace_sites = {}   # site id -> (first state idx, n_states,
        #                              num coeffs, den coeffs)
        self.delay_sites = {}     # absdelay site id -> site index
        self._discover(mod.analog)
        self.n_local = nxt = self.n_nodes
        for key in self.vbranches:
            self.vbranches[key] = nxt
            nxt += 1
        for key in self.idt_sites:
            self.idt_sites[key] = nxt
            nxt += 1
        for key, (num, den) in list(self.laplace_sites.items()):
            m = len(den) - 1      # filter order
            self.laplace_sites[key] = (nxt, m, num, den)
            nxt += m
        self.n_local = nxt
        # $limit sites (reference vasim.jl:1257-1338, :3097-3146): one
        # limiter-state variable per unique probe BRANCH (shared across all
        # $limit sites on that branch — OldGet/NewSet idiom); one companion
        # slot per call SITE for the OSDI lim_rhs anchoring.
        self.limit_sites = []     # [(branch_idx, fn_name, extra_arg_exprs)]
        self.limit_branches = []  # [(p_net, n_net|None)] unique, ordered
        self.limit_site_ids = {}  # id(expr) -> site_idx
        self._find_limits(mod.analog)
        # ddx sites: id(expr) -> (inner_expr, wrt_local_node). Derivatives
        # flow through ASSIGNED VARIABLE chains, so they are computed by a
        # jvp pre-pass over the whole block per distinct wrt node (the
        # reference's always-on node partials, `vasim.jl:122`)
        self.ddx_sites = {}
        self._find_ddx(mod.analog)
        # noise sites (static enumeration)
        self.noise_sites = []     # [(kind, branch(p,n))]
        self._find_noise(mod.analog, None)
        # setup/load split (the reference's per-instance temp/geometry
        # precomputation vs the load function, e.g. DIOtempUpdate/DIOload):
        # statements that depend only on (params, dyn) are hoisted into a
        # setup pass evaluated ONCE per assembly, outside linearization —
        # for PSP-class models this removes the bulk of the traced graph
        # from every Newton tangent pass
        self.setup_stmts, self.runtime_stmts = self._split_setup()
        # host-setup hoisting (the reference's temp/geometry precompute vs
        # load split, e.g. DIOtempUpdate/DIOload; PSP103's setup pass is
        # ~35k of its ~51k traced ops): for big models the (params, temp)-
        # only prefix is evaluated EAGERLY on CPU once per solve and its
        # values enter the residual as a constant vector p['__setup__'].
        # Small models keep the in-pass setup (identical numerics).
        self.host_setup_enabled = (
            self._count_stmts(self.setup_stmts) >= 150)
        self.setup_keys = None      # resolved on first host_setup call
        self.setup_static = {}      # string-valued setup vars (static)
        # collapse candidates: V-branches that receive a literal `<+ 0`
        # contribution under (possibly empty) if-guards — decided per
        # parameter signature by decide_collapses()
        self.collapse_cands = self._find_collapse_candidates()
        # (numeric defaults double as STRUCTURAL values for loop bounds and
        # laplace coefficients: those stay host values (Python floats),
        # never tensors; per-instance overrides of structural parameters
        # are not supported yet)

    # ------------------------------------------------------------ discovery
    def _branch_nets(self, nets):
        if len(nets) == 1:
            return (nets[0], None)
        return (nets[0], nets[1])

    def _is_collapsed(self, key):
        return (key in self.collapsed
                or (key[1] is not None
                    and (key[1], key[0]) in self.collapsed))

    def _discover(self, stmts):
        for st in stmts:
            k = st[0]
            if k == "contrib" and st[1] == "V":
                nets = st[2]
                if len(nets) == 1 and nets[0] in self.mod.branches:
                    key = self.mod.branches[nets[0]]
                else:
                    key = self._branch_nets(nets)
                if not self._is_collapsed(key):
                    self.vbranches.setdefault(key, None)
            elif k == "block":
                self._discover(st[1])
            elif k == "if":
                self._discover([st[2]])
                if st[3] is not None:
                    self._discover([st[3]])
            elif k in ("for", "while"):
                self._discover([st[-1]])
            elif k == "repeat":
                self._discover([st[2]])
            elif k == "case":
                for _, s in st[2]:
                    self._discover([s])
            elif k == "event":
                self._discover([st[1]])
        # idt/laplace discovery over all expressions
        def walk_expr(e):
            if not isinstance(e, tuple):
                return
            if e[0] == "call" and e[1] in ("idt", "idtmod"):
                self.idt_sites.setdefault(id(e), None)
            if e[0] == "call" and e[1] in ("laplace_nd", "laplace_zp",
                                           "laplace_np", "laplace_zd"):
                self.laplace_sites.setdefault(id(e),
                                              self._laplace_coeffs(e))
                for coeff in e[2][1:]:
                    deps = set()
                    self._expr_param_deps(coeff, deps)
                    self.structural_params |= deps & set(
                        self.mod.parameters)
            if e[0] == "call" and e[1] == "absdelay":
                # transport delay (reference `src/mna/delay.jl:20-28`):
                # one history site per call, value threaded back through
                # the transient runner's ring buffer
                self.delay_sites.setdefault(id(e), len(self.delay_sites))
            for sub in e[1:]:
                if isinstance(sub, tuple):
                    walk_expr(sub)
                elif isinstance(sub, list):
                    for x in sub:
                        walk_expr(x)

        def walk_stmt(st):
            for sub in st[1:]:
                if isinstance(sub, tuple) and sub and \
                        isinstance(sub[0], str) and sub[0] in (
                            "block", "if", "for", "while", "repeat",
                            "case", "contrib", "assign", "assign_idx",
                            "sys", "event"):
                    walk_stmt(sub)
                elif isinstance(sub, tuple):
                    walk_expr(sub)
                elif isinstance(sub, list):
                    for x in sub:
                        if isinstance(x, tuple) and x and \
                                isinstance(x[0], str) and x[0] in (
                                    "block", "if", "contrib", "assign"):
                            walk_stmt(x)
                        else:
                            walk_expr(x)

        for st in stmts:
            walk_stmt(st)

    def _laplace_coeffs(self, e):
        """Host-evaluate laplace filter coefficient arrays.

        laplace_nd(x, [n0, n1, ...], [d0, d1, ...]): numerator/denominator
        polynomial coefficients in ascending powers of s (LRM 4.5.13);
        laplace_zp(x, zeros, poles) with (re, im) pairs is converted to
        coefficients host-side (reference `src/mna/laplace.jl`)."""
        kind = e[1]
        if len(e[2]) < 3:
            raise VACompileError(f"{kind} needs (expr, num, den)")

        def arr(a):
            # coefficient arrays must be {…} literals; elements may use
            # parameters (resolved at their structural/default values)
            if isinstance(a, tuple) and a[0] == "array":
                return [self._host_eval(x, self._ndefaults or {})
                        for x in a[1]]
            raise VACompileError(f"{kind}: coefficient arrays must be "
                                 f"literal {{...}} arrays")

        num = arr(e[2][1])
        den = arr(e[2][2])
        if kind in ("laplace_zp",):
            num = _roots_pairs_to_poly(num)
            den = _roots_pairs_to_poly(den)
        elif kind == "laplace_np":
            den = _roots_pairs_to_poly(den)
        elif kind == "laplace_zd":
            num = _roots_pairs_to_poly(num)
        # strip trailing zero coefficients (ascending powers): models pad
        # the numerator to the denominator width ({K,0,0,...})
        while len(num) > 1 and float(num[-1]) == 0.0:
            num = num[:-1]
        while len(den) > 1 and float(den[-1]) == 0.0:
            den = den[:-1]
        if len(num) >= len(den):
            raise VACompileError(f"{kind}: numerator order must be below "
                                 f"denominator order")
        return (tuple(num), tuple(den))

    def _find_ddx(self, stmts):
        def walk_expr(e):
            if not isinstance(e, tuple):
                return
            if e[0] == "call" and e[1] == "ddx" and len(e[2]) == 2:
                wrt = e[2][1]
                if wrt[0] == "acc" and wrt[2][0] in self.node_idx:
                    self.ddx_sites[id(e)] = (e[2][0],
                                             self.node_idx[wrt[2][0]])
            for sub in e[1:]:
                if isinstance(sub, tuple):
                    walk_expr(sub)
                elif isinstance(sub, list):
                    for x in sub:
                        walk_expr(x)

        def walk(st):
            for sub in st[1:]:
                if isinstance(sub, tuple) and sub and \
                        isinstance(sub[0], str) and sub[0] in (
                            "block", "if", "for", "while", "repeat",
                            "case", "contrib", "assign", "assign_idx",
                            "sys", "event", "callstmt"):
                    walk(sub)
                elif isinstance(sub, tuple):
                    walk_expr(sub)
                elif isinstance(sub, list):
                    for x in sub:
                        if isinstance(x, tuple) and x and \
                                isinstance(x[0], str) and x[0] in (
                                    "block", "if", "contrib", "assign",
                                    "callstmt"):
                            walk(x)
                        else:
                            walk_expr(x)

        for st in stmts:
            walk(st)

    def _ddx_prepass(self, u, p, dyn, eff, s, lim_w=None, lim_d=None,
                     setup_vals=None):
        """Per-site ddx derivatives: one jvp pass of the full analog block
        per distinct wrt node, recording every site's inner value at its
        own program point (variable reassignment between sites is
        respected)."""
        by_ni = {}
        for sid, (inner, ni) in self.ddx_sites.items():
            by_ni.setdefault(ni, []).append(sid)
        vals = {}
        sv = setup_vals if setup_vals is not None else self.run_setup(
            p, dyn, eff)
        for ni, sids in by_ni.items():
            def h(uv, ni=ni, sids=sids):
                env = _Env(self, self.n_local)
                env.vars = dict(sv)
                env.lim_w, env.lim_d = lim_w, lim_d
                if lim_w is not None:
                    env.lim_rec, env.lim_vnew, env.lim_wsite = {}, {}, {}
                env.ddx_recording = {}
                u2 = _set(u, ni, uv)
                self._init_vars(env, u2, p, dyn, eff, s)
                for st in self.runtime_stmts:
                    self._exec(st, env, u2, p, dyn, eff, s)
                zero = torch.zeros((), dtype=DTYPE, device=u.device)
                return tuple(zero + env.ddx_recording.get(sid, 0.0)
                             for sid in sids)
            _, tans = _fjvp(h, (u[ni],), (torch.ones_like(u[ni]),))
            for sid, t in zip(sids, tans):
                vals[sid] = t
        return vals

    _ANALOG_CALLS = frozenset((
        "ddt", "idt", "idtmod", "laplace_nd", "laplace_zp", "laplace_np",
        "laplace_zd", "absdelay", "white_noise", "flicker_noise", "ddx",
        "transition", "slew"))

    def _fn_has_analog(self, fname, _seen=frozenset()):
        if fname in _seen or fname not in self.mod.functions:
            return False
        f = self.mod.functions[fname]
        seen = _seen | {fname}
        return any(self._stmt_has_analog(st, seen) for st in f.body)

    def _expr_has_analog(self, e, seen=frozenset()):
        # "analog" here means "cannot be hoisted into the once-per-solve
        # setup pass": access functions, ddt/noise/$limit, and anything that
        # reads in-solve dynamic state ($abstime, $simparam's gmin/srcfact,
        # analysis() mode probes — those vary inside homotopy/time loops).
        # $temperature/$vt stay hoistable: temperature is fixed per solve.
        if not isinstance(e, tuple):
            return False
        if e[0] == "acc":
            return True
        if e[0] == "sysfn":
            if e[1] in ("$limit", "$analog_node_alias", "$abstime"):
                return True
            if e[1] == "$simparam":
                # only gmin/sourceScaleFactor vary INSIDE a solve (homotopy
                # ladders); scale/tnom/epsmin/... are per-solve constants
                # and stay hoistable
                key = (e[2][0][1] if e[2] and e[2][0][0] == "str" else "")
                if key in ("gmin", "sourceScaleFactor"):
                    return True
        if e[0] == "call":
            if e[1] in self._ANALOG_CALLS or e[1] == "analysis":
                return True
            if e[1] in self.mod.functions and self._fn_has_analog(e[1],
                                                                  seen):
                return True
        for sub in e[1:]:
            if isinstance(sub, tuple) and self._expr_has_analog(sub, seen):
                return True
            if isinstance(sub, list):
                for x in sub:
                    if self._expr_has_analog(x, seen):
                        return True
        return False

    def _walk_stmt_parts(self, st):
        """Yield ('stmt', s) / ('expr', e) for the direct parts of st."""
        stmt_tags = ("block", "if", "for", "while", "repeat", "case",
                     "contrib", "assign", "assign_idx", "sys", "event",
                     "callstmt")
        for sub in st[1:]:
            if isinstance(sub, tuple):
                if sub and isinstance(sub[0], str) and sub[0] in stmt_tags:
                    yield ("stmt", sub)
                else:
                    yield ("expr", sub)
            elif isinstance(sub, list):
                for x in sub:
                    if isinstance(x, tuple) and x and \
                            isinstance(x[0], str) and x[0] in stmt_tags:
                        yield ("stmt", x)
                    elif isinstance(x, tuple):
                        yield ("expr", x)
                    elif isinstance(x, (list,)):
                        for y in x:
                            if isinstance(y, tuple):
                                yield ("expr", y)

    def _stmt_has_analog(self, st, seen=frozenset()):
        if st[0] == "contrib":
            return True
        if st[0] == "callstmt" and st[1] in self.mod.functions and \
                self._fn_has_analog(st[1], seen):
            return True
        for kind, part in self._walk_stmt_parts(st):
            if kind == "stmt":
                if self._stmt_has_analog(part, seen):
                    return True
            elif self._expr_has_analog(part, seen):
                return True
        return False

    def _expr_reads_tainted(self, e, tainted):
        if not isinstance(e, tuple):
            return False
        if e[0] == "name":
            return e[1] in tainted
        if e[0] == "index" and e[1] in tainted:
            return True
        for sub in e[1:]:
            if isinstance(sub, tuple) and self._expr_reads_tainted(
                    sub, tainted):
                return True
            if isinstance(sub, list):
                for x in sub:
                    if self._expr_reads_tainted(x, tainted):
                        return True
        return False

    def _stmt_reads_tainted(self, st, tainted):
        for kind, part in self._walk_stmt_parts(st):
            if kind == "stmt":
                if self._stmt_reads_tainted(part, tainted):
                    return True
            elif self._expr_reads_tainted(part, tainted):
                return True
        return False

    def _stmt_writes(self, st, out):
        k = st[0]
        if k in ("assign", "assign_idx"):
            out.add(st[1])
        elif k == "callstmt":
            # conservative: any name argument may be an output
            for a in st[2]:
                if isinstance(a, tuple) and a[0] == "name":
                    out.add(a[1])
        elif k == "block":
            for s in st[1]:
                self._stmt_writes(s, out)
        elif k == "if":
            self._stmt_writes(st[2], out)
            if st[3] is not None:
                self._stmt_writes(st[3], out)
        elif k == "for":
            self._stmt_writes(st[1], out)
            self._stmt_writes(st[3], out)
            self._stmt_writes(st[4], out)
        elif k in ("while", "repeat", "event"):
            self._stmt_writes(st[-1], out)
        elif k == "case":
            for _, s in st[2]:
                self._stmt_writes(s, out)

    def _stmt_reads(self, st, out):
        for kind, part in self._walk_stmt_parts(st):
            if kind == "stmt":
                self._stmt_reads(part, out)
            else:
                self._expr_names(part, out)

    def _split_setup(self):
        """Forward single-pass classification of the analog block into
        (setup, runtime) statement lists. A statement is setup iff nothing
        inside it touches analog state (access functions, ddt/noise/$limit,
        contributions), reads a runtime-written variable, or WRITES a
        variable already written or read by a runtime statement (hoisting
        such a write would reorder it across the runtime sequence — big
        models reuse scratch names like T0/T1 across both regions, so this
        last rule is load-bearing: without it a hoisted `T1 = f(cox)`
        replaces the runtime scratch value a later statement consumes).
        Bare begin/end blocks are split child-by-child; control statements
        are all-or-nothing."""
        # module-level variables whose INITIALIZER is runtime-classified
        # ($limit/access/in-solve $simparam) only exist at runtime — any
        # statement reading them cannot be hoisted
        tainted = set()
        for nm, vinfo in self.mod.variables.items():
            init = vinfo[2] if len(vinfo) > 2 else None
            if init is not None and self._expr_has_analog(init):
                tainted.add(nm)
        rt_touched = set()     # vars written OR read by runtime stmts

        def walk(stmts, out_setup, out_runtime):
            for st in stmts:
                if st[0] == "block":
                    sc, rc = [], []
                    walk(st[1], sc, rc)
                    if sc:
                        out_setup.append(("block", sc))
                    if rc:
                        out_runtime.append(("block", rc))
                    continue
                if st[0] == "event":
                    sc, rc = [], []
                    walk([st[1]], sc, rc)
                    if sc:
                        out_setup.append(("event", ("block", sc)))
                    if rc:
                        out_runtime.append(("event", ("block", rc)))
                    continue
                writes = set()
                self._stmt_writes(st, writes)
                if (not self._stmt_has_analog(st)
                        and not self._stmt_reads_tainted(st, tainted)
                        and not (writes & rt_touched)):
                    out_setup.append(st)
                else:
                    out_runtime.append(st)
                    tainted.update(writes)
                    rt_touched.update(writes)
                    self._stmt_reads(st, rt_touched)

        setup, runtime = [], []
        walk(self.mod.analog, setup, runtime)
        return setup, runtime

    # --------------------------------------------------------- node collapse
    def _find_collapse_candidates(self):
        """V-branches eligible for node collapse (reference
        detect_short_circuits, `src/vasim.jl:2723`): branches whose every
        reachable V-contribution can be `<+ 0` under if-guards. Returns
        {branch_key: [(((cond_expr, polarity), ...), rhs_is_zero), ...]}."""
        cands = {}
        bad = set()

        def rhs_zero(e):
            return e[0] == "num" and float(e[1]) == 0.0

        def walk(stmts, conds, in_loop):
            for st in stmts:
                k = st[0]
                if k == "contrib" and st[1] == "V":
                    nets = st[2]
                    if len(nets) == 1 and nets[0] in self.mod.branches:
                        key = self.mod.branches[nets[0]]
                    else:
                        key = self._branch_nets(nets)
                    if in_loop:
                        bad.add(key)
                    else:
                        cands.setdefault(key, []).append(
                            (tuple(conds), rhs_zero(st[3])))
                elif k == "block":
                    walk(st[1], conds, in_loop)
                elif k == "if":
                    walk([st[2]], conds + [(st[1], True)], in_loop)
                    if st[3] is not None:
                        walk([st[3]], conds + [(st[1], False)], in_loop)
                elif k in ("for", "while"):
                    walk([st[-1]], conds, True)
                elif k == "repeat":
                    walk([st[2]], conds, True)
                elif k == "case":
                    for _, s in st[2]:
                        walk([s], conds, True)
                elif k == "event":
                    walk([st[1]], conds, True)

        walk(self.mod.analog, [], False)
        out = {}
        internal = set(self.mod.internal_nodes)
        for key, lst in cands.items():
            if key in bad:
                continue
            if not any(z for _, z in lst):
                continue
            pn, nn = key
            # eligibility: ground collapse needs an internal node; pair
            # collapse needs at least one internal (ports cannot merge)
            if nn is None:
                if pn not in internal:
                    continue
            elif pn not in internal and nn not in internal:
                continue
            out[key] = lst
        return out

    def _expr_names(self, e, out):
        if not isinstance(e, tuple):
            return
        if e[0] == "name":
            out.add(e[1])
            return
        if e[0] == "index":
            out.add(e[1])
        for sub in e[1:]:
            if isinstance(sub, tuple):
                self._expr_names(sub, out)
            elif isinstance(sub, list):
                for x in sub:
                    self._expr_names(x, out)

    def decide_collapses(self, overrides=None):
        """Host decision for one parameter signature: evaluate the setup
        pass eagerly with the instance's effective parameters, then each
        collapse guard; a branch collapses iff every ACTIVE V-contribution
        to it is the literal 0 (and at least one is). Guards that touch
        analog state or runtime-assigned variables are undecidable — the
        branch keeps its explicit constraint row. Collapse-controlling
        parameters are effectively structural: later `alter`/sweeps do not
        re-decide (the reference re-detects per build,
        `src/mna/solve.jl:1793`; here structure is fixed at elaboration)."""
        if not self.collapse_cands:
            return ()
        # eager, on CPU scalars: the guards read numeric defaults and the
        # instance's overrides only
        p = dict(self._ndefaults)
        if overrides:
            for k, v in overrides.items():
                if k in p:
                    p[k] = float(v)
        dyn = SimSpec().dyn("cpu")
        try:
            eff = self.effective_params(p, dyn)
            sv = self.run_setup(p, dyn, eff)
        except Exception:
            return ()
        runtime_written = set()
        for st in self.runtime_stmts:
            self._stmt_writes(st, runtime_written)
        out = []
        for key, lst in self.collapse_cands.items():
            decided = True
            n_active = 0
            active_all_zero = True
            for conds, z in lst:
                active = True
                for ce, pol in conds:
                    if self._expr_has_analog(ce):
                        decided = False
                        break
                    nm = set()
                    self._expr_names(ce, nm)
                    if nm & runtime_written:
                        decided = False
                        break
                    env = _Env(self, self.n_local)
                    env.vars = dict(sv)
                    try:
                        v = self._eval_expr(ce, env, None, p, dyn, eff, 0.0)
                        truth = bool(v != 0)
                    except Exception:
                        decided = False
                        break
                    if truth != pol:
                        active = False
                        break
                if not decided:
                    break
                if active:
                    n_active += 1
                    if not z:
                        active_all_zero = False
            if decided and n_active > 0 and active_all_zero:
                out.append(key)
        return tuple(sorted(out, key=str))

    def run_setup(self, p, dyn, eff):
        """Evaluate the (params, dyn)-only prefix once; returns the var
        environment the runtime pass starts from."""
        env = _Env(self, self.n_local)
        self._init_vars(env, None, p, dyn, eff, 0.0, which="setup")
        for st in self.setup_stmts:
            self._exec(st, env, None, p, dyn, eff, 0.0)
        return env.vars

    def _count_stmts(self, stmts):
        n = 0
        for st in stmts:
            n += 1
            for kind, part in self._walk_stmt_parts(st):
                if kind == "stmt":
                    n += self._count_stmts([part])
        return n

    def host_setup(self, p, dyn):
        """Host evaluation of effective params + the setup pass for a
        whole instance group: p maps param names to [n_inst] (or
        [batch, n_inst]) concrete arrays. Returns the [..., n_inst, K]
        setup-value matrix (numpy f64) matching `self.setup_keys`. All
        elementwise, so one eager pass of f64 CPU tensors broadcasts over
        every instance (the vectorized analogue of the reference's
        per-instance temp-update functions). The JAX package jits this
        pass for its CPU; here it runs eagerly, once per solve."""
        p = {k: torch.as_tensor(np.asarray(v, np.float64), dtype=DTYPE)
             for k, v in p.items() if k != "__setup__"}
        dyn = DynSpec(*(torch.as_tensor(f).detach().cpu() for f in dyn))
        shapes = [tuple(v.shape) for v in p.values() if v.ndim]
        shape = np.broadcast_shapes(*shapes) if shapes else ()
        self._host_setup_pass = True
        try:
            eff = self.effective_params(p, dyn)
            sv = self.run_setup(p, dyn, eff)
        finally:
            self._host_setup_pass = False
        merged = dict(eff)
        merged.update(sv)
        if self.setup_keys is None:
            keys, static = [], {}
            for k, v in merged.items():
                if isinstance(v, str):
                    static[k] = v
                else:
                    keys.append(k)
            self.setup_keys = sorted(keys, key=repr)
            self.setup_static = static
        cols = [torch.broadcast_to(torch.as_tensor(merged[k], dtype=DTYPE),
                                   shape)
                for k in self.setup_keys]
        return torch.stack(cols, dim=-1).numpy()

    def _runtime_base(self, u, p, dyn):
        """(eff, base_vars) for a runtime interpretation pass. When the
        solver entry precomputed p['__setup__'] (host-setup path), both are
        read out of that constant vector; otherwise the traced
        effective-params + setup prefix runs inline (fallback — correct
        but compiles the full graph)."""
        if isinstance(p, dict) and "__setup__" in p \
                and self.setup_keys is not None:
            vec = p["__setup__"]
            allv = {k: vec[i] for i, k in enumerate(self.setup_keys)}
            allv.update(self.setup_static)
            eff = {nm: allv[nm] for nm in self.mod.parameters
                   if nm in allv}
            for alias, tgt in self.mod.aliases.items():
                if tgt in allv:
                    eff[alias] = allv[tgt]
            return eff, allv
        eff = self.effective_params(p, dyn)
        sv = self.run_setup(p, dyn, eff)
        return eff, sv

    def _find_noise(self, stmts, branch):
        for st in stmts:
            k = st[0]
            if k == "contrib":
                nets = st[2]
                if len(nets) == 1 and nets[0] in self.mod.branches:
                    tgt = self.mod.branches[nets[0]]
                else:
                    tgt = self._branch_nets(nets)
                self._find_noise_expr(st[3], tgt)
            elif k == "block":
                self._find_noise(st[1], branch)
            elif k == "if":
                self._find_noise([st[2]], branch)
                if st[3] is not None:
                    self._find_noise([st[3]], branch)
            elif k in ("for", "while"):
                self._find_noise([st[-1]], branch)
            elif k == "repeat":
                self._find_noise([st[2]], branch)
            elif k == "case":
                for _, s in st[2]:
                    self._find_noise([s], branch)
            elif k == "event":
                self._find_noise([st[1]], branch)

    def _find_noise_expr(self, e, branch):
        if not isinstance(e, tuple):
            return
        if e[0] == "call" and e[1] in ("white_noise", "flicker_noise"):
            self.noise_sites.append((id(e), e[1], branch))
        for sub in e[1:]:
            if isinstance(sub, tuple):
                self._find_noise_expr(sub, branch)
            elif isinstance(sub, list):
                for x in sub:
                    self._find_noise_expr(x, branch)

    def _toposort_params(self):
        deps = {}
        for nm, p in self.mod.parameters.items():
            d = set()
            self._expr_param_deps(p.default, d)
            deps[nm] = d & set(self.mod.parameters)
        order = []
        pending = dict(deps)
        while pending:
            ready = [k for k, v in pending.items() if not v]
            if not ready:
                raise VACompileError(
                    f"circular parameter defaults: {sorted(pending)}")
            for k in ready:
                order.append(k)
                del pending[k]
            for v in pending.values():
                v.difference_update(ready)
        return order

    def _expr_param_deps(self, e, out):
        if not isinstance(e, tuple):
            return
        if e[0] == "name":
            out.add(e[1])
        for sub in e[1:]:
            if isinstance(sub, tuple):
                self._expr_param_deps(sub, out)
            elif isinstance(sub, list):
                for x in sub:
                    self._expr_param_deps(x, out)

    # ------------------------------------------------------- default values
    def numeric_defaults(self):
        """Host-evaluated defaults (using only defaults) for the params
        dict; plus __given masks."""
        vals = {}
        for nm in self.param_order:
            p = self.mod.parameters[nm]
            try:
                vals[nm] = float(self._host_eval(p.default, vals))
            except Exception:
                vals[nm] = 0.0
        out = {}
        for nm in self.mod.parameters:
            out[nm] = vals.get(nm, 0.0)
            out[nm + "__given"] = 0.0
        return out

    def _host_eval(self, e, scope):
        tag = e[0]
        if tag == "num":
            return e[1]
        if tag == "str":
            return 0.0
        if tag == "name":
            if e[1] in scope:
                return scope[e[1]]
            cst = _VA_CONSTANTS.get(e[1])
            if cst is not None:
                return cst
            raise VACompileError(f"unknown name {e[1]!r} in default")
        if tag == "un":
            v = self._host_eval(e[2], scope)
            return {"-": -v, "+": v, "!": float(v == 0), "~": float(~int(v))
                    }[e[1]]
        if tag == "bin":
            a = self._host_eval(e[2], scope)
            b = self._host_eval(e[3], scope)
            return _host_binop(e[1], a, b)
        if tag == "cond":
            return (self._host_eval(e[2], scope)
                    if self._host_eval(e[1], scope) != 0
                    else self._host_eval(e[3], scope))
        if tag == "call":
            args = [self._host_eval(a, scope) for a in e[2]]
            f = getattr(math, e[1], None)
            if e[1] == "ln":
                return math.log(args[0])
            if e[1] == "limexp":
                return math.exp(min(args[0], 80.0))
            if e[1] == "pow":
                return args[0] ** args[1]
            if e[1] in ("min", "max"):
                return (min if e[1] == "min" else max)(*args)
            if f:
                return f(*args)
        if tag == "sysfn":
            if e[1] == "$temperature":
                return 300.15
            if e[1] == "$vt":
                return KB * 300.15 / QE
        raise VACompileError(f"cannot host-evaluate {e!r}")

    # ------------------------------------------------------------ interpret
    def effective_params(self, p, dyn):
        """Traced: resolve (value, given) pairs through default exprs."""
        eff = {}
        for nm in self.param_order:
            par = self.mod.parameters[nm]
            default = self._eval_expr(par.default, _Env(self, self.n_local),
                                      None, p, dyn, eff, 0.0)
            given = p[nm + "__given"]
            eff[nm] = _where(given > 0, p[nm], default)
        for alias, tgt in self.mod.aliases.items():
            eff[alias] = eff[tgt]
        return eff

    def make_residual(self):
        comp = self

        def residual(u, p, dyn):
            eff, sv = comp._runtime_base(u, p, dyn)
            zero = torch.zeros((), dtype=DTYPE, device=u.device)

            def block(s):
                env = _Env(comp, comp.n_local)
                env.vars = dict(sv)
                # no ddx prepass on the hot residual path: in practice ddx
                # feeds op-vars/noise only (PSP gates them behind OPderiv);
                # the opvars/noise paths run the full prepass. A model that
                # CONTRIBUTED a var-chain ddx result would see 0 here.
                comp._init_vars(env, u, p, dyn, eff, s)
                for st in comp.runtime_stmts:
                    comp._exec(st, env, u, p, dyn, eff, s)
                comp._close_switch_branches(env, u)
                return _stack(env.contrib, zero)

            f, q = _fjvp(block, (zero,), (torch.ones_like(zero),))
            return f, q

        return residual

    def _limit_branch(self, acc):
        """Resolve a $limit probe V(p[,n]) / V(branch) to (p, n) nets."""
        nets = acc[2]
        if len(nets) == 1 and nets[0] in self.mod.branches:
            return self.mod.branches[nets[0]]
        return self._branch_nets(nets)

    def _find_limits(self, stmts):
        def walk_expr(e):
            if not isinstance(e, tuple):
                return
            if e[0] == "sysfn" and e[1] == "$limit" and e[2]:
                acc = e[2][0]
                if acc[0] == "acc" and acc[1] == "V":
                    fn = "pnjlim"
                    extra = []
                    if len(e[2]) > 1:
                        fe = e[2][1]
                        if fe[0] in ("str", "name"):
                            fn = fe[1]
                        extra = e[2][2:]
                    branch = self._limit_branch(acc)
                    if branch not in self.limit_branches:
                        self.limit_branches.append(branch)
                    b = self.limit_branches.index(branch)
                    self.limit_site_ids[id(e)] = len(self.limit_sites)
                    self.limit_sites.append((b, fn, list(extra)))
            for sub in e[1:]:
                if isinstance(sub, tuple):
                    walk_expr(sub)
                elif isinstance(sub, list):
                    for x in sub:
                        walk_expr(x)

        def walk(st):
            for sub in st[1:]:
                if isinstance(sub, tuple) and sub and \
                        isinstance(sub[0], str) and sub[0] in (
                            "block", "if", "for", "while", "repeat",
                            "case", "contrib", "assign", "assign_idx",
                            "sys", "event"):
                    walk(sub)
                elif isinstance(sub, tuple):
                    walk_expr(sub)
                elif isinstance(sub, list):
                    for x in sub:
                        if isinstance(x, tuple) and x and \
                                isinstance(x[0], str) and x[0] in (
                                    "block", "if", "contrib", "assign"):
                            walk(x)
                        else:
                            walk_expr(x)

        for st in stmts:
            walk(st)

    def make_residual_lim(self):
        """residual_lim(u, d, w, p, dyn) -> ((f, q), (w_new, vnew, wsite)).

        Reference-exact $limit semantics (vasim.jl:1257-1338): per probe
        branch one limiter-state variable w[b] (the voltage the device
        evaluated at last iteration); each call site computes
        w_site = fn(vnew, w[b], args...) — interpreting user limiter
        functions (DEVlimitOldGet/NewSet wrapping DEVpnjlim/fetlim) or the
        builtin pnjlim/fetlim/limvds — records it as the branch's new
        state, and returns a straight-through passthrough: value = w_site,
        gradient = ∂vnew/∂u (undamped conductance at the limited point,
        the ngspice/OSDI convention) plus d[site] for the lim_rhs
        companion anchoring (F += ∂F/∂w · (vnew − w), applied by the
        assembler via one extra linearization tangent)."""
        if not self.limit_sites:
            return None
        comp = self
        S = len(self.limit_sites)
        B = len(self.limit_branches)

        def residual_lim(u, d, w, p, dyn):
            eff, sv = comp._runtime_base(u, p, dyn)
            zero = torch.zeros((), dtype=DTYPE, device=u.device)

            def block(s):
                env = _Env(comp, comp.n_local)
                env.vars = dict(sv)
                env.lim_w = w
                env.lim_d = d
                env.lim_rec = {}
                env.lim_vnew = {}
                env.lim_wsite = {}
                comp._init_vars(env, u, p, dyn, eff, s)
                for st in comp.runtime_stmts:
                    comp._exec(st, env, u, p, dyn, eff, s)
                comp._close_switch_branches(env, u)
                w_new = _stack([env.lim_rec.get(b, w[b])
                                for b in range(B)], zero)
                vnew = _stack([env.lim_vnew.get(j, 0.0)
                               for j in range(S)], zero)
                wsite = _stack([env.lim_wsite.get(j, 0.0)
                                for j in range(S)], zero)
                return _stack(env.contrib, zero), (w_new, vnew, wsite)

            f, q, aux = _fjvp(block, (zero,), (torch.ones_like(zero),),
                              has_aux=True)
            return (f, q), aux

        return residual_lim

    def make_delay_probe(self):
        """probe(u, p, dyn) -> (vals, taus), each [n_delay_sites]: the
        instantaneous value of every absdelay'd expression and its delay,
        in site order. The transient runner records vals into a per-site
        history ring on every accepted step and interpolates at t - tau
        for the residual (reference DDE history function,
        `src/mna/delay.jl:20-28`)."""
        if not self.delay_sites:
            return None
        comp = self
        S = len(self.delay_sites)

        def probe(u, p, dyn):
            eff, sv = comp._runtime_base(u, p, dyn)
            env = _Env(comp, comp.n_local)
            env.vars = dict(sv)
            env.delay_rec = {}
            if comp.ddx_sites:
                env.ddx_vals = comp._ddx_prepass(u, p, dyn, eff, 0.0,
                                                 setup_vals=sv)
            comp._init_vars(env, u, p, dyn, eff, 0.0)
            for st in comp.runtime_stmts:
                comp._exec(st, env, u, p, dyn, eff, 0.0)
            zero = torch.zeros((), dtype=DTYPE, device=u.device)
            vals = _stack([env.delay_rec[j][0] for j in range(S)], zero)
            taus = _stack([env.delay_rec[j][1] for j in range(S)], zero)
            return vals, taus

        return probe

    def make_noise(self):
        comp = self
        if not self.noise_sites:
            return None, ()

        def noise_fn(u, p, dyn):
            eff, sv = comp._runtime_base(u, p, dyn)
            env = _Env(comp, comp.n_local)
            env.vars = dict(sv)
            if comp.ddx_sites:
                env.ddx_vals = comp._ddx_prepass(u, p, dyn, eff, 0.0,
                                                 setup_vals=sv)
            comp._init_vars(env, u, p, dyn, eff, 0.0)
            for st in comp.runtime_stmts:
                comp._exec(st, env, u, p, dyn, eff, 0.0)
            got = {sid: (w, fl) for sid, w, fl in env.noise_acc}
            zero = torch.zeros((), dtype=DTYPE, device=u.device)
            return _stack([got.get(sid, (0.0, 0.0))[0]
                           for sid, kind, branch in comp.noise_sites], zero)

        def flicker_fn(u, p, dyn):
            eff, sv = comp._runtime_base(u, p, dyn)
            env = _Env(comp, comp.n_local)
            env.vars = dict(sv)
            if comp.ddx_sites:
                env.ddx_vals = comp._ddx_prepass(u, p, dyn, eff, 0.0,
                                                 setup_vals=sv)
            comp._init_vars(env, u, p, dyn, eff, 0.0)
            for st in comp.runtime_stmts:
                comp._exec(st, env, u, p, dyn, eff, 0.0)
            got = {sid: (w, fl) for sid, w, fl in env.noise_acc}
            nums, exps = [], []
            for sid, kind, branch in comp.noise_sites:
                w, fl = got.get(sid, (0.0, 1.0))
                if kind == "flicker_noise":
                    nums.append(w)
                    exps.append(fl)
                else:
                    nums.append(0.0)
                    exps.append(1.0)
            zero = torch.zeros((), dtype=DTYPE, device=u.device)
            return _stack(nums, zero), _stack(exps, zero)

        # ground-referenced pairs: second index must be a harmless slot;
        # structure.py wires locals, so reuse the first port for (p,)
        fixed_pairs = []
        for sid, kind, branch in self.noise_sites:
            pn, nn = branch if branch else (self.ports[0], self.ports[0])
            pi = self.node_idx[pn]
            ni = self.node_idx[nn] if nn else pi
            fixed_pairs.append((pi, ni))
        # white_noise only in `noise_fn`; flicker separately

        def white_only(u, p, dyn):
            w = noise_fn(u, p, dyn)
            kinds = [float(k == "white_noise")
                     for _, k, _ in comp.noise_sites]
            return w * torch.tensor(kinds, dtype=DTYPE, device=w.device)

        return (white_only, flicker_fn, tuple(fixed_pairs))

    # ---- statement execution
    def _exec(self, st, env, u, p, dyn, eff, s):
        k = st[0]
        if k == "block":
            for sub in st[1]:
                self._exec(sub, env, u, p, dyn, eff, s)
        elif k == "assign":
            env.vars[st[1]] = self._eval_expr(st[2], env, u, p, dyn, eff, s)
        elif k == "assign_idx":
            # array variables: store under (name, host_index)
            idx = self._try_host(st[2], env, eff)
            env.vars[(st[1], idx)] = self._eval_expr(st[3], env, u, p, dyn,
                                                     eff, s)
        elif k == "contrib":
            self._contrib(st, env, u, p, dyn, eff, s)
        elif k == "if":
            cond = self._eval_expr(st[1], env, u, p, dyn, eff, s)
            self._exec_masked(st[2], st[3], cond, env, u, p, dyn, eff, s)
        elif k == "case":
            sel = self._eval_expr(st[1], env, u, p, dyn, eff, s)
            # lower to if/else chain
            taken = None
            for matches, body in st[2]:
                if matches is None:
                    cond_val = 1.0
                else:
                    cond_val = 0.0
                    for me in matches:
                        mv = self._eval_expr(me, env, u, p, dyn, eff, s)
                        cond_val = _where(sel == mv, 1.0, cond_val)
                cond_val = cond_val * (1.0 - (taken if taken is not None
                                              else 0.0))
                self._exec_masked(body, None, cond_val, env, u, p, dyn,
                                  eff, s)
                taken = (taken if taken is not None else 0.0) + cond_val
        elif k == "for":
            self._exec(st[1], env, u, p, dyn, eff, s)
            for _ in range(10000):
                c = self._try_host(st[2], env, eff)
                if c is None:
                    # condition involves traced values (e.g. an early-exit
                    # `iter = 25` under a data-dependent if): bound the trip
                    # count from a host shadow of the loop control alone and
                    # run the remaining iterations masked
                    trips = self._trip_bound(st, env, eff)
                    if trips is None:
                        raise VACompileError(
                            "for-loop condition must be host-evaluable or "
                            "have a host-boundable trip count")
                    for _ in range(trips):
                        cond = self._eval_expr(st[2], env, u, p, dyn, eff,
                                               s)
                        self._exec_masked(("block", [st[4], st[3]]), None,
                                          cond, env, u, p, dyn, eff, s)
                    break
                if not c:
                    break
                self._exec(st[4], env, u, p, dyn, eff, s)
                self._exec(st[3], env, u, p, dyn, eff, s)
            else:
                raise VACompileError("for loop exceeded 10000 iterations")
        elif k == "while":
            c0 = self._try_host(st[1], env, eff)
            if c0 is None:
                # traced condition (e.g. PSP stress loop over NF fingers):
                # bounded masked unroll — iterations beyond the true count
                # execute with mask 0 and change nothing. Cap chosen from
                # the structural value of the comparison bound when
                # host-evaluable, else a fixed 12.
                cap = 12
                if st[1][0] == "bin" and st[1][1] in ("<", "<="):
                    b = self._try_host(st[1][3], env, eff)
                    if b is not None and 0 < b < 64:
                        cap = int(math.ceil(b)) + 1
                for _ in range(cap):
                    cond = self._eval_expr(st[1], env, u, p, dyn, eff, s)
                    self._exec_masked(st[2], None, cond, env, u, p, dyn,
                                      eff, s)
            else:
                for _ in range(10000):
                    c = self._try_host(st[1], env, eff)
                    if c is None:
                        raise VACompileError(
                            "while-loop condition must be host-evaluable")
                    if not c:
                        break
                    self._exec(st[2], env, u, p, dyn, eff, s)
        elif k == "repeat":
            cnt = self._try_host(st[1], env, eff)
            if cnt is None:
                raise VACompileError("repeat count must be host-evaluable")
            for _ in range(int(cnt)):
                self._exec(st[2], env, u, p, dyn, eff, s)
        elif k == "sys":
            pass  # $strobe/$display/$finish: no-op at runtime
        elif k == "callstmt":
            if st[1] in self.mod.functions:
                self._user_fn(st[1], st[2], env, u, p, dyn, eff, s)
            # unknown task calls (e.g. vendor debug hooks): no-op
        elif k == "event":
            self._exec(st[1], env, u, p, dyn, eff, s)
        else:
            raise VACompileError(f"unhandled statement {k!r}")

    def _exec_masked(self, then_st, else_st, cond, env, u, p, dyn, eff, s):
        condf = _flag(cond != 0)
        saved_vars = dict(env.vars)
        saved_mask = env.mask
        saved_contrib = env.contrib
        env.mask = _times(saved_mask, condf)
        env.contrib = [0.0] * len(saved_contrib)
        self._exec(then_st, env, u, p, dyn, eff, s)
        then_vars = env.vars
        then_contrib = env.contrib
        env.vars = dict(saved_vars)
        env.contrib = [0.0] * len(saved_contrib)
        env.mask = _times(saved_mask, 1.0 - condf)
        if else_st is not None:
            self._exec(else_st, env, u, p, dyn, eff, s)
        else_vars = env.vars
        else_contrib = env.contrib
        env.mask = saved_mask
        # merge: contributions were already mask-scaled inside _contrib
        env.contrib = [_plus(_plus(a, b), c) for a, b, c in
                       zip(saved_contrib, then_contrib, else_contrib)]
        merged = dict(saved_vars)
        # sorted, NOT set-ordered: string-set iteration order is hash-
        # randomized per process; the JAX package keeps its emitted merge
        # order stable across processes, and the port merges in the same
        # order
        for key in sorted(set(then_vars) | set(else_vars)):
            tv = then_vars.get(key, saved_vars.get(key))
            ev = else_vars.get(key, saved_vars.get(key))
            if tv is None:
                merged[key] = ev
            elif ev is None or tv is ev:
                # untouched by both branches (same object): no merge op —
                # critical for giant models (bsim3v3: ~500 ifs x ~400 vars
                # would otherwise emit 200k dead where-ops)
                merged[key] = tv
            else:
                merged[key] = _where(condf != 0, tv, ev)
        env.vars = merged

    def _contrib(self, st, env, u, p, dyn, eff, s):
        acc, nets, expr = st[1], st[2], st[3]
        raw = self._eval_expr(expr, env, u, p, dyn, eff, s)
        # where-based masking, NOT raw*mask: an untaken branch may evaluate
        # to NaN/inf (sqrt/log of out-of-domain values) and 0*NaN = NaN
        # would poison the residual
        val = _where(env.mask != 0, _times(raw, env.mask), 0.0)
        if len(nets) == 1 and nets[0] in self.mod.branches:
            tgt = self.mod.branches[nets[0]]     # named branch
        else:
            tgt = self._branch_nets(nets)
        if acc == "V" and self._is_collapsed(tgt):
            # short-circuited branch: the nodes are merged at elaboration,
            # the constraint row and its current unknown do not exist
            return
        pi = self.node_idx[tgt[0]]
        ni = self.node_idx[tgt[1]] if tgt[1] else None
        if acc == "I":
            env.add(pi, val)
            if ni is not None:
                env.add(ni, -val)
        else:  # V contribution: branch row + current injection
            j = self.vbranches[tgt]
            ib = u[j]
            env.add(pi, _times(env.mask, ib))
            if ni is not None:
                env.add(ni, -_times(env.mask, ib))
            vb = u[pi] - (u[ni] if ni is not None else 0.0)
            env.add(j, _times(env.mask, vb) - val)
            env.vmask[j] = _plus(env.vmask.get(j, 0.0), env.mask)

    def _trip_bound(self, st, env, eff, cap=10000):
        """Max trip count of a for-loop, simulating ONLY its control
        (init; cond; step) on host values — ignores body mutations, so it
        is an upper bound for loops whose body only escapes early."""
        _, init, cond, step, _ = st
        sh = _Env(self, 1)
        sh.vars = dict(env.vars)
        if init[0] == "assign":
            v = self._try_host(init[2], env, eff)
            if v is None:
                return None
            sh.vars[init[1]] = v
        n = 0
        while n < cap:
            c = self._try_host(cond, sh, eff)
            if c is None:
                return None
            if not c:
                return n
            if step[0] != "assign":
                return None
            v = self._try_host(step[2], sh, eff)
            if v is None:
                return None
            sh.vars[step[1]] = v
            n += 1
        return None

    def _try_host(self, e, env, eff):
        """Host-evaluate an expression if it only involves python values."""
        try:
            v = self._host_eval_env(e, env, eff)
            return v
        except Exception:
            return None

    def _host_eval_env(self, e, env, eff):
        tag = e[0]
        if tag == "num":
            return e[1]
        if tag == "name":
            if e[1] in env.vars:
                # traced values raise -> not host
                return self._host_float(env.vars[e[1]])
            if e[1] in eff:
                try:
                    return self._host_float(eff[e[1]])
                except Exception:
                    # traced parameter: fall back to its structural
                    # (default) value — loop bounds must be static
                    if self._ndefaults and e[1] in self._ndefaults:
                        return self._ndefaults[e[1]]
                    raise
            if e[1] in _VA_CONSTANTS:
                return _VA_CONSTANTS[e[1]]
            raise VACompileError(e[1])
        if tag == "bin":
            return _host_binop(e[1], self._host_eval_env(e[2], env, eff),
                               self._host_eval_env(e[3], env, eff))
        if tag == "un":
            v = self._host_eval_env(e[2], env, eff)
            return {"-": -v, "+": v, "!": float(v == 0)}[e[1]]
        if tag == "cond":
            return (self._host_eval_env(e[2], env, eff)
                    if self._host_eval_env(e[1], env, eff) != 0
                    else self._host_eval_env(e[3], env, eff))
        raise VACompileError(str(e))

    def _host_float(self, v):
        if self._host_setup_pass and isinstance(v, torch.Tensor):
            raise VACompileError("traced value")
        return _concrete(v)

    @staticmethod
    def _cse(env, key, thunk, pins):
        hit = env.cse.get(key)
        if hit is not None:
            return hit[-1]
        r = thunk()
        env.cse[key] = pins + (r,)
        return r

    # ---- expression evaluation (traced)
    def _eval_expr(self, e, env, u, p, dyn, eff, s):
        tag = e[0]
        if tag == "num":
            return e[1]
        if tag == "str":
            return e[1]
        if tag == "name":
            nm = e[1]
            if nm in env.vars:
                return env.vars[nm]
            if nm in eff:
                return eff[nm]
            if nm in _VA_CONSTANTS:
                return _VA_CONSTANTS[nm]
            raise VACompileError(f"undefined identifier {nm!r}")
        if tag == "index":
            idx = self._try_host(e[2], env, eff)
            return env.vars[(e[1], idx)]
        if tag == "acc":
            return self._access(e, env, u)
        if tag == "un":
            v = self._eval_expr(e[2], env, u, p, dyn, eff, s)
            if e[1] == "-":
                return self._cse(env, ("u-", _cse_key(v)),
                                 lambda: -v, (v,))
            if e[1] == "+":
                return v
            return self._cse(env, ("u!", _cse_key(v)),
                             lambda: _flag(v == 0), (v,))
        if tag == "bin":
            a = self._eval_expr(e[2], env, u, p, dyn, eff, s)
            b = self._eval_expr(e[3], env, u, p, dyn, eff, s)
            return self._cse(env, ("b", e[1], _cse_key(a), _cse_key(b)),
                             lambda: _traced_binop(e[1], a, b), (a, b))
        if tag == "cond":
            c = self._eval_expr(e[1], env, u, p, dyn, eff, s)
            t = self._eval_expr(e[2], env, u, p, dyn, eff, s)
            f = self._eval_expr(e[3], env, u, p, dyn, eff, s)
            return self._cse(env, ("c", _cse_key(c), _cse_key(t),
                                   _cse_key(f)),
                             lambda: _where(c != 0, t, f), (c, t, f))
        if tag == "call":
            return self._call(e, env, u, p, dyn, eff, s)
        if tag == "sysfn":
            return self._sysfn(e, env, u, p, dyn, eff, s)
        raise VACompileError(f"unhandled expression {e!r}")

    def _access(self, e, env, u):
        kind, nets = e[1], e[2]
        if kind == "V":
            if nets in self.mod.branches or (len(nets) == 1 and
                                             nets[0] in self.mod.branches):
                bn = nets[0]
                pn, nn = self.mod.branches[bn]
                pi = self.node_idx[pn]
                v = u[pi]
                if nn is not None:
                    v = v - u[self.node_idx[nn]]
                return v
            v = u[self.node_idx[nets[0]]]
            if len(nets) > 1:
                v = v - u[self.node_idx[nets[1]]]
            return v
        # I() access
        if len(nets) == 1 and nets[0] in self.mod.branches:
            pn, nn = self.mod.branches[nets[0]]
            key = (pn, nn)
        else:
            key = self._branch_nets(nets)
        if key in self.vbranches:
            return u[self.vbranches[key]]
        if len(nets) == 1 and nets[0] in self.mod.branches:
            # current read of a flow-contributed named branch: only noise
            # sources feed these in practice (bsim4 correlated noise) and
            # they contribute exactly 0 to the value path
            return 0.0
        raise VACompileError(
            f"I({','.join(nets)}) access requires a voltage-contributed "
            f"branch")

    def _call(self, e, env, u, p, dyn, eff, s):
        fn = e[1]
        if fn == "ddt":
            x = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
            return s * x
        if fn in ("idt", "idtmod"):
            j = self.idt_sites[id(e)]
            x = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
            # row j: d/dt y - x = 0 stamped via contributions
            env.add(j, _times(env.mask, s * u[j] - x))
            return u[j]
        if fn in ("laplace_nd", "laplace_zp", "laplace_np", "laplace_zd"):
            # H(s) = N(s)/D(s) filter as controllable-canonical states:
            # z_i' = z_{i+1} (i < m-1), D(d/dt) z = x; y = N(d/dt) z
            # (reference `src/mna/laplace.jl` state-space stamping)
            j0, m, num, den = self.laplace_sites[id(e)]
            x = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
            for i in range(m - 1):
                env.add(j0 + i,
                        _times(env.mask, s * u[j0 + i] - u[j0 + i + 1]))
            # last row: sum d_i z_i + d_m * s*z_{m-1} = x
            acc = den[m] * s * u[j0 + m - 1]
            for i in range(m):
                acc = acc + den[i] * u[j0 + i]
            env.add(j0 + m - 1, _times(env.mask, acc - x))
            y = 0.0
            for i, ni in enumerate(num):
                y = y + ni * u[j0 + i]
            return y
        if fn == "transition" or fn == "slew":
            # quasi-static fallback: pass the value through (full slew
            # filtering lands with event timing support)
            return self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
        if fn == "absdelay":
            # transport delay (reference `src/mna/delay.jl:20-28`).
            # Probe pass: record (value now, tau) for the history ring.
            # Residual pass inside the transient runner: read the
            # interpolated past value from p['__dly__'] (explicit
            # coupling: the delayed value is history, constant with
            # respect to the current unknowns). DC and every evaluation
            # without a runner take the instantaneous value (absdelay is
            # the identity at DC).
            j = self.delay_sites[id(e)]
            if env.delay_rec is not None:
                val = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
                tau = self._eval_expr(e[2][1], env, u, p, dyn, eff, s)
                env.delay_rec[j] = (val, tau)
                return val
            if isinstance(p, dict) and "__dly__" in p:
                return p["__dly__"][j]
            return self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
        if fn == "limexp":
            return _limexp(self._eval_expr(e[2][0], env, u, p, dyn, eff, s))
        if fn == "white_noise":
            psd = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
            env.noise_acc.append((id(e), _times(psd, env.mask), 0.0))
            return 0.0
        if fn == "flicker_noise":
            psd = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
            ex = self._eval_expr(e[2][1], env, u, p, dyn, eff, s) \
                if len(e[2]) > 1 else 1.0
            env.noise_acc.append((id(e), _times(psd, env.mask), ex))
            return 0.0
        if fn == "ddx":
            inner, wrt = e[2][0], e[2][1]
            if wrt[0] != "acc":
                raise VACompileError("ddx needs an access-function arg")
            sid = id(e)
            if env.ddx_recording is not None:
                # jvp pre-pass sub-evaluation: record this site's inner
                # value at its program point; nested ddx results are not
                # differentiated through (return 0 tangent carrier)
                if sid in self.ddx_sites:
                    val = self._eval_expr(inner, env, u, p, dyn, eff, s)
                    env.ddx_recording[sid] = val
                return 0.0
            if env.ddx_vals is not None and sid in env.ddx_vals:
                return env.ddx_vals[sid]
            # fallback (ddx inside a user function / non-prepassed path):
            # differentiate the leaf expression in the CURRENT variable
            # environment (upstream assignment chains are constants here)
            ni = self.node_idx[wrt[2][0]]

            def fleaf(uv):
                sub = _Env(self, self.n_local)
                sub.vars = dict(env.vars)
                u2 = _set(u, ni, uv)
                return uv * 0.0 + self._eval_expr(inner, sub, u2, p, dyn,
                                                  eff, 0.0)
            return _fgrad(fleaf)(u[ni])
        if fn in self.mod.functions:
            return self._user_fn(fn, e[2], env, u, p, dyn, eff, s)
        args = [self._eval_expr(a, env, u, p, dyn, eff, s) for a in e[2]]
        if fn in _F1 and len(args) == 1:
            a0 = args[0]
            return self._cse(env, ("f", fn, _cse_key(a0)),
                             lambda: _fold(_F1[fn], a0), (a0,))
        if fn in _F2 and len(args) == 2:
            a0, a1 = args
            return self._cse(env, ("f2", fn, _cse_key(a0), _cse_key(a1)),
                             lambda: _fold(_F2[fn], a0, a1), (a0, a1))
        if fn == "analysis":
            kind = e[2][0][1] if e[2] and e[2][0][0] == "str" else ""
            if kind in ("static", "dc"):
                return _flag(dyn.mode == MODE_DCOP)
            if kind in ("tran",):
                return _flag(dyn.mode == MODE_TRAN)
            if kind in ("noise", "ac", "smsig"):
                return _flag(dyn.mode == MODE_AC)
            return 0.0
        raise VACompileError(f"unknown function {fn!r}/{len(e[2])}")

    def _apply_limiter(self, fn, vnew, vold, extra_exprs, env, u, p, dyn,
                       eff, s):
        """Evaluate the $limit limiter fn(vnew, vold, extra...)."""
        if fn in self.mod.functions:
            return self._user_fn(
                fn, [None, None] + list(extra_exprs), env, u, p, dyn, eff,
                s, pre_args=[vnew, vold])
        extra = [self._eval_expr(a, env, u, p, dyn, eff, s)
                 for a in extra_exprs]
        if fn == "pnjlim":
            vt = extra[0] if extra else dyn.vt
            vcrit = (extra[1] if len(extra) > 1
                     else _fold(lambda v: v * torch.log(
                         v / (1.41421356 * 1e-14)), vt))
            return pnjlim(vnew, vold, vt, vcrit)
        if fn == "fetlim":
            return fetlim(vnew, vold,
                          _tensor(extra[0] if extra else 0.0, vnew))
        if fn == "limvds":
            return limvds(vnew, vold)
        raise VACompileError(f"$limit: unknown limiter function {fn!r}")

    def _close_switch_branches(self, env, u):
        """After a block evaluation: every V-contribution branch whose
        activation mask is (partially) inactive gets its current unknown
        constrained toward 0 — open switch branch (VA LRM 5.3)."""
        for j in self.vbranches.values():
            act = env.vmask.get(j, 0.0)
            if isinstance(act, float) and act == 1.0:
                continue
            open_w = 1.0 - _fold(lambda a: _clip(a, 0.0, 1.0), act)
            env.add(j, open_w * u[j])

    def _init_vars(self, env, u, p, dyn, eff, s, which="runtime"):
        """Module-level variable initializers (`real x = expr;`).
        which="setup" evaluates the (params, dyn)-only initializers;
        "runtime" the analog-dependent rest (rare)."""
        for nm, vinfo in self.mod.variables.items():
            init = vinfo[2] if len(vinfo) > 2 else None
            if init is None:
                continue
            is_setup = not self._expr_has_analog(init)
            if (which == "setup") == is_setup:
                env.vars[nm] = self._eval_expr(init, env, u, p, dyn, eff,
                                               s)

    def _user_fn(self, fname, arg_exprs, env, u, p, dyn, eff, s,
                 pre_args=None):
        """Interpret a user analog function call.

        arg_exprs: call-site argument expressions (entries may be None when
        pre_args supplies the value directly, e.g. $limit's (vnew, vold)).
        inout/output arguments write back to the caller's variable when the
        call-site expression is a plain name (reference analog task calls
        with output args, vasim.jl:2519-2620)."""
        f = self.mod.functions[fname]
        pre = list(pre_args) if pre_args else []
        args = []
        for i, (nm, direction) in enumerate(f.args):
            if i < len(pre):
                args.append(pre[i])
            elif i < len(arg_exprs) and arg_exprs[i] is not None:
                args.append(self._eval_expr(arg_exprs[i], env, u, p, dyn,
                                            eff, s))
            else:
                args.append(0.0)
        sub = _Env(self, self.n_local)
        sub.vars = {nm: 0.0 for nm in f.locals}
        sub.vars.update(zip((nm for nm, _ in f.args), args))
        sub.vars[fname] = 0.0
        sub.mask = env.mask
        sub.contrib = env.contrib
        sub.noise_acc = env.noise_acc
        sub.cse = env.cse
        sub.lim_w, sub.lim_d = env.lim_w, env.lim_d
        sub.lim_rec, sub.lim_vnew, sub.lim_wsite = (env.lim_rec,
                                                    env.lim_vnew,
                                                    env.lim_wsite)
        for st in f.body:
            self._exec(st, sub, u, p, dyn, eff, s)
        env.contrib = sub.contrib
        # inout/output writeback
        for i, (nm, direction) in enumerate(f.args):
            if direction == "input" or i >= len(arg_exprs):
                continue
            ae = arg_exprs[i]
            if ae is not None and ae[0] == "name":
                env.vars[ae[1]] = sub.vars.get(nm, 0.0)
        return sub.vars.get(fname, 0.0)

    def _table_model(self, e, env, u, p, dyn, eff, s):
        """$table_model(x[, y], "file"[, ctrl]): 1-D/2-D gridded linear
        interpolation loaded once at compile time (reference
        `src/mna/table_model.jl`, VA LRM 9.21)."""
        import os
        args = e[2]
        coord_exprs = [a for a in args if a[0] != "str"]
        fname = next((a[1] for a in args if a[0] == "str" and
                      not set(a[1]) <= set("1LCI,ED")), None)
        if fname is None:
            raise VACompileError("$table_model needs a table file path")
        key = ("table", fname)
        if key not in self._tables:
            path = fname
            if not os.path.isabs(path):
                for d in list(self.include_dirs) + ["."]:
                    cand = os.path.join(d, fname)
                    if os.path.exists(cand):
                        path = cand
                        break
            rows = []
            with open(path) as fh:
                for line in fh:
                    line = line.split("#")[0].split("%")[0].strip()
                    if line:
                        rows.append([float(v) for v in line.split()])
            data = np.asarray(rows)
            self._tables[key] = data
        data = self._tables[key]
        ndim = data.shape[1] - 1
        if len(coord_exprs) != ndim:
            raise VACompileError(
                f"$table_model: table has {ndim} coordinate column(s), "
                f"got {len(coord_exprs)} arguments")
        coords = [self._eval_expr(a, env, u, p, dyn, eff, s)
                  for a in coord_exprs]
        if ndim == 1:
            order = np.argsort(data[:, 0])
            return _fold(lambda x: _interp(x, data[order, 0],
                                           data[order, 1]), coords[0])
        if ndim == 2:
            xs = np.unique(data[:, 0])
            ys = np.unique(data[:, 1])
            grid = np.full((len(xs), len(ys)), np.nan)
            xi = np.searchsorted(xs, data[:, 0])
            yi = np.searchsorted(ys, data[:, 1])
            grid[xi, yi] = data[:, 2]
            if np.isnan(grid).any():
                raise VACompileError("$table_model: 2-D table must be a "
                                     "full rectilinear grid")
            return _fold(lambda x, y: _bilinear(x, y, xs, ys, grid),
                         *coords)
        raise VACompileError("$table_model supports 1-D and 2-D tables")

    def _sysfn(self, e, env, u, p, dyn, eff, s):
        name = e[1]
        if name == "$temperature":
            return dyn.temp
        if name == "$vt":
            if e[2]:
                t = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
                return KB * t / QE
            return dyn.vt
        if name == "$abstime":
            return dyn.time
        if name == "$param_given":
            pn = e[2][0][1]
            return p[pn + "__given"]
        if name == "$simparam":
            key = e[2][0][1] if e[2] and e[2][0][0] == "str" else ""
            default = (self._eval_expr(e[2][1], env, u, p, dyn, eff, s)
                       if len(e[2]) > 1 else 0.0)
            if key == "gmin":
                return dyn.gmin
            if key == "sourceScaleFactor":
                return dyn.srcfact
            return default
        if name == "$table_model":
            return self._table_model(e, env, u, p, dyn, eff, s)
        if name == "$limit":
            vnew = self._eval_expr(e[2][0], env, u, p, dyn, eff, s)
            j = self.limit_site_ids.get(id(e))
            if j is None or env.lim_w is None:
                # unlimited evaluation (noise/opvar/rhs passes, or a probe
                # that is not a V() access)
                return vnew
            b, fn, extra = self.limit_sites[j]
            vold = env.lim_w[b]
            w_site = _detach(self._apply_limiter(
                fn, vnew, vold, extra, env, u, p, dyn, eff, s))
            # record the branch's new state (mask-blended so $limit inside
            # conditionals composes; the reference forbids that case)
            prev = env.lim_rec.get(b, env.lim_w[b])
            env.lim_rec[b] = _where(env.mask != 0, w_site, prev)
            env.lim_vnew[j] = _detach(vnew)
            env.lim_wsite[j] = w_site
            # passthrough dual: value = w_site, gradient = ∂vnew/∂u, plus
            # the site's companion slot (reference vasim.jl:1320-1336)
            return vnew - _detach(vnew) + w_site + env.lim_d[j]
        if name in ("$strobe", "$display", "$debug", "$warning", "$error",
                    "$finish", "$fatal", "$stop"):
            return 0.0
        if name == "$mfactor":
            return 1.0
        if name == "$port_connected":
            # every port must be wired in this framework
            return 1.0
        if name == "$analog_node_alias":
            return 0.0
        raise VACompileError(f"unknown system function {name!r}")


def _roots_pairs_to_poly(pairs):
    """Flat [re0, im0, re1, im1, ...] roots -> real polynomial coefficients
    in ascending powers of s: prod (s - (re + j*im))."""
    import numpy as _np
    roots = [complex(pairs[i], pairs[i + 1])
             for i in range(0, len(pairs), 2)]
    poly = _np.array([1.0 + 0j])
    for r in roots:
        poly = _np.convolve(poly, _np.array([-r, 1.0 + 0j]))
    if _np.max(_np.abs(poly.imag)) > 1e-9 * max(_np.max(_np.abs(poly)), 1):
        raise VACompileError("laplace roots must come in conjugate pairs")
    return [float(c) for c in poly.real]


_VA_CONSTANTS = {
    "M_PI": math.pi, "M_TWO_PI": 2 * math.pi, "M_PI_2": math.pi / 2,
    "M_PI_4": math.pi / 4, "M_1_PI": 1 / math.pi, "M_2_PI": 2 / math.pi,
    "M_SQRT2": math.sqrt(2), "M_SQRT1_2": math.sqrt(0.5),
    "M_E": math.e, "M_LOG2E": math.log2(math.e),
    "M_LOG10E": math.log10(math.e), "M_LN2": math.log(2),
    "M_LN10": math.log(10),
    "P_Q": QE, "P_K": KB, "P_H": 6.62607015e-34,
    "P_EPS0": 8.8541878128e-12, "P_U0": 4e-7 * math.pi,
    "P_C": 299792458.0, "P_CELSIUS0": 273.15,
}


def _host_binop(op, a, b):
    return {
        "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
        "/": lambda: a / b, "%": lambda: math.fmod(a, b),
        "**": lambda: a ** b,
        "<": lambda: float(a < b), ">": lambda: float(a > b),
        "<=": lambda: float(a <= b), ">=": lambda: float(a >= b),
        "==": lambda: float(a == b), "!=": lambda: float(a != b),
        "&&": lambda: float(a != 0 and b != 0),
        "||": lambda: float(a != 0 or b != 0),
        "&": lambda: float(int(a) & int(b)),
        "|": lambda: float(int(a) | int(b)),
        "^": lambda: float(int(a) ^ int(b)),
        "<<": lambda: float(int(a) << int(b)),
        ">>": lambda: float(int(a) >> int(b)),
    }[op]()


def _bits(fn, a, b):
    """A bitwise op on VA integers (flag packing in big models)."""
    a, b = _tensors(a, b)
    return fn(a.to(torch.int32), b.to(torch.int32)).to(DTYPE)


def _binop_t(op, a, b):
    table = {
        "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
        "/": lambda: _safe_div(a, b),
        "%": lambda: torch.fmod(*_tensors(a, b)),
        "**": lambda: _safe_pow(a, b),
        "<": lambda: _flag(a < b),
        ">": lambda: _flag(a > b),
        "<=": lambda: _flag(a <= b),
        ">=": lambda: _flag(a >= b),
        "==": lambda: _flag(a == b),
        "!=": lambda: _flag(a != b),
        "&&": lambda: _flag((a != 0) & (b != 0)),
        "||": lambda: _flag((a != 0) | (b != 0)),
        "&": lambda: _bits(torch.bitwise_and, a, b),
        "|": lambda: _bits(torch.bitwise_or, a, b),
        "^": lambda: _bits(torch.bitwise_xor, a, b),
        "<<": lambda: _bits(torch.bitwise_left_shift, a, b),
        ">>": lambda: _bits(torch.bitwise_right_shift, a, b),
    }
    return table[op]()


def _traced_binop(op, a, b):
    if _num(a) and _num(b):
        return _fold(lambda x, y: _binop_t(op, x, y), a, b)
    return _binop_t(op, a, b)


def _interp(x, xs, vs):
    """jnp.interp of a 0-d tensor x on the host grid (xs, vs): linear
    inside, flat outside; searchsorted plus gathers, so it traces under
    torch.func (as `mna/waveforms.py` evaluates PWL sources)."""
    xs = torch.as_tensor(xs, dtype=DTYPE, device=x.device)
    vs = torch.as_tensor(vs, dtype=DTYPE, device=x.device)
    xx = x.reshape(1)
    i = torch.clamp(torch.searchsorted(xs, xx, right=True), 1,
                    xs.shape[0] - 1)
    x_hi, x_lo = xs.gather(0, i), xs.gather(0, i - 1)
    v_hi, v_lo = vs.gather(0, i), vs.gather(0, i - 1)
    dx = x_hi - x_lo
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float64).eps))
    f = torch.where(dx0, v_lo,
                    v_lo + ((xx - x_lo) / torch.where(dx0, 1.0, dx))
                    * (v_hi - v_lo))
    f = torch.where(xx < xs[:1], vs[:1], f)
    f = torch.where(xx > xs[-1:], vs[-1:], f)
    return f[0]


def _bilinear(x, y, xs, ys, grid):
    """Bilinear interpolation on a full rectilinear host grid, clamped to
    its edges (the JAX package's 2-D `$table_model`)."""
    x, y = _tensors(x, y)
    xs_t = torch.as_tensor(xs, dtype=DTYPE, device=x.device)
    ys_t = torch.as_tensor(ys, dtype=DTYPE, device=x.device)
    g = torch.as_tensor(grid, dtype=DTYPE, device=x.device).reshape(-1)
    ny = len(ys)
    ix = torch.clamp(torch.searchsorted(xs_t, x.reshape(1)) - 1, 0,
                     len(xs) - 2)
    iy = torch.clamp(torch.searchsorted(ys_t, y.reshape(1)) - 1, 0,
                     ny - 2)
    x0, x1 = xs_t.gather(0, ix), xs_t.gather(0, ix + 1)
    y0, y1 = ys_t.gather(0, iy), ys_t.gather(0, iy + 1)
    wx = _clip((x - x0) / (x1 - x0), 0.0, 1.0)
    wy = _clip((y - y0) / (y1 - y0), 0.0, 1.0)

    def at(i, j):
        return g.gather(0, i * ny + j)

    out = ((1 - wx) * (1 - wy) * at(ix, iy)
           + wx * (1 - wy) * at(ix + 1, iy)
           + (1 - wx) * wy * at(ix, iy + 1)
           + wx * wy * at(ix + 1, iy + 1))
    return out[0]


# ---------------------------------------------------------------------------
# module hierarchy: flatten child instantiations into the parent by AST
# inlining (the reference emits nested stamp! calls with hierarchical
# instance naming, `vasim.jl:418-461`; here structure must be static, so we
# inline before compilation)

def _rename_expr(e, net_map, sym_map):
    if not isinstance(e, tuple):
        return e
    tag = e[0]
    if tag == "name":
        return ("name", sym_map.get(e[1], e[1]))
    if tag == "acc":
        return ("acc", e[1], tuple(net_map.get(n, n) for n in e[2]))
    if tag == "call":
        return ("call", sym_map.get(e[1], e[1]),
                [_rename_expr(a, net_map, sym_map) for a in e[2]])
    if tag == "sysfn":
        return ("sysfn", e[1],
                [_rename_expr(a, net_map, sym_map) for a in e[2]])
    if tag in ("bin",):
        return ("bin", e[1], _rename_expr(e[2], net_map, sym_map),
                _rename_expr(e[3], net_map, sym_map))
    if tag == "un":
        return ("un", e[1], _rename_expr(e[2], net_map, sym_map))
    if tag == "cond":
        return tuple(["cond"] + [_rename_expr(x, net_map, sym_map)
                                 for x in e[1:]])
    if tag == "array":
        return ("array", [_rename_expr(x, net_map, sym_map) for x in e[1]])
    if tag == "index":
        return ("index", sym_map.get(e[1], e[1]),
                _rename_expr(e[2], net_map, sym_map))
    return e


def _rename_stmt(st, net_map, sym_map):
    k = st[0]
    if k == "block":
        return ("block", [_rename_stmt(s, net_map, sym_map)
                          for s in st[1]])
    if k == "assign":
        return ("assign", sym_map.get(st[1], st[1]),
                _rename_expr(st[2], net_map, sym_map))
    if k == "assign_idx":
        return ("assign_idx", sym_map.get(st[1], st[1]),
                _rename_expr(st[2], net_map, sym_map),
                _rename_expr(st[3], net_map, sym_map))
    if k == "contrib":
        return ("contrib", st[1],
                tuple(net_map.get(n, n) for n in st[2]),
                _rename_expr(st[3], net_map, sym_map))
    if k == "if":
        return ("if", _rename_expr(st[1], net_map, sym_map),
                _rename_stmt(st[2], net_map, sym_map),
                None if st[3] is None else
                _rename_stmt(st[3], net_map, sym_map))
    if k == "for":
        return ("for", _rename_stmt(st[1], net_map, sym_map),
                _rename_expr(st[2], net_map, sym_map),
                _rename_stmt(st[3], net_map, sym_map),
                _rename_stmt(st[4], net_map, sym_map))
    if k == "while":
        return ("while", _rename_expr(st[1], net_map, sym_map),
                _rename_stmt(st[2], net_map, sym_map))
    if k == "repeat":
        return ("repeat", _rename_expr(st[1], net_map, sym_map),
                _rename_stmt(st[2], net_map, sym_map))
    if k == "case":
        return ("case", _rename_expr(st[1], net_map, sym_map),
                [(None if m is None else
                  [_rename_expr(x, net_map, sym_map) for x in m],
                  _rename_stmt(s, net_map, sym_map)) for m, s in st[2]])
    if k == "sys":
        return ("sys", st[1], [_rename_expr(a, net_map, sym_map)
                               for a in st[2]])
    if k == "callstmt":
        return ("callstmt", sym_map.get(st[1], st[1]),
                [_rename_expr(a, net_map, sym_map) for a in st[2]])
    if k == "event":
        return ("event", _rename_stmt(st[1], net_map, sym_map))
    return st


def inline_hierarchy(mod: VAModule, lib: dict) -> VAModule:
    """Flatten child module instantiations into `mod` (recursively).

    Child nets map: ports -> parent nets; internals get '<inst>_' prefixes;
    child parameters become '<inst>_<p>' parent parameters whose defaults
    are the instantiation overrides (evaluated in the parent namespace) or
    the child defaults with child-param references renamed."""
    if not mod.instances:
        return mod
    import copy
    out = copy.deepcopy(mod)
    out.instances = []
    for (subname, inst, nets, overrides) in mod.instances:
        if subname not in lib:
            raise VACompileError(f"{mod.name}: unknown module {subname!r} "
                                 f"instantiated as {inst!r}")
        sub = inline_hierarchy(lib[subname], lib)
        sub_ports = [p[0] for p in sub.ports]
        if len(nets) != len(sub_ports):
            raise VACompileError(
                f"{mod.name}.{inst}: {subname} has {len(sub_ports)} ports, "
                f"got {len(nets)}")
        net_map = dict(zip(sub_ports, nets))
        for nn in sub.internal_nodes:
            net_map[nn] = f"{inst}_{nn}"
            out.internal_nodes.append(net_map[nn])
        sym_map = {}
        for pn, par in sub.parameters.items():
            new = f"{inst}_{pn}"
            sym_map[pn] = new
        for vn in sub.variables:
            sym_map[vn] = f"{inst}_{vn}"
        for fn in sub.functions:
            sym_map[fn] = f"{inst}_{fn}"
        for pn, par in sub.parameters.items():
            new = sym_map[pn]
            if pn in overrides:
                default = overrides[pn]   # parent-namespace expression
            else:
                default = _rename_expr(par.default, {}, sym_map)
            out.parameters[new] = VAParam(new, par.ptype, default,
                                          par.ranges, par.units, par.desc)
        for vn, vinfo in sub.variables.items():
            ty, attrs = vinfo[0], vinfo[1]
            init = vinfo[2] if len(vinfo) > 2 else None
            if init is not None:
                init = _rename_expr(init, net_map, sym_map)
            out.variables[sym_map[vn]] = (ty, attrs, init)
        for fn, f in sub.functions.items():
            out.functions[sym_map[fn]] = VAFunction(
                sym_map[fn], f.ftype,
                [(nm, d) for nm, d in f.args], dict(f.locals),
                [_rename_stmt(s,
                              {}, dict(sym_map, **{fn: sym_map[fn]}))
                 for s in f.body])
        for bn, (p, n) in sub.branches.items():
            out.branches[f"{inst}_{bn}"] = (net_map.get(p, p),
                                            net_map.get(n, n) if n else None)
            net_map[bn] = f"{inst}_{bn}"
        for st in sub.analog:
            out.analog.append(_rename_stmt(st, net_map, sym_map))
    return out


# ---------------------------------------------------------------------------
# public API

def compile_va_module(mod: VAModule, include_dirs=(),
                      collapsed=(), _specialize=True) -> DeviceModel:
    """VAModule -> DeviceModel (the `make_mna_device` analogue).

    `collapsed`: branch keys taking the `V(a,b) <+ 0` short-circuit path
    for this parameter signature (reference detect_short_circuits,
    `src/vasim.jl:2723`). The base model (collapsed=()) carries a
    `va_specialize` callback when candidates exist; the frontend calls it
    with each instance's parameter overrides. For big (host-setup) models
    specialization also PRUNES parameter-static branches (va/prune.py) —
    the untaken sides of SWGIDL/SWJUNCAP/NQS-class switches never enter
    the traced graph."""
    comp = VACompiler(mod, include_dirs=include_dirs, collapsed=collapsed)
    # node-merge alias table for the elaborator: collapsed internal ->
    # target (terminal / other internal / None=ground)
    internal_set = set(mod.internal_nodes)
    collapses = []
    for (pn, nn) in comp.collapsed:
        if nn is None:
            collapses.append((pn, None))
        elif pn in internal_set:
            collapses.append((pn, nn))
        else:
            collapses.append((nn, pn))
    internals = []
    for nm in mod.internal_nodes:
        internals.append((nm, CLASS_V))
    for (pn, nn), j in sorted(comp.vbranches.items(),
                              key=lambda kv: kv[1]):
        internals.append((f"i_{pn}_{nn}" if nn else f"i_{pn}", CLASS_I))
    for sid, j in sorted(comp.idt_sites.items(), key=lambda kv: kv[1]):
        internals.append((f"idt{j}", CLASS_V))
    for sid, (j0, m, num, den) in sorted(comp.laplace_sites.items(),
                                         key=lambda kv: kv[1][0]):
        for i in range(m):
            internals.append((f"lp{j0}_{i}", CLASS_V))
    noise_pack = comp.make_noise()
    noise_fn, flicker_fn, noise_pairs = (None, None, ())
    if noise_pack[0] is not None:
        noise_fn, flicker_fn, noise_pairs = noise_pack

    # operating-point variables: (* desc/units *)-attributed module vars
    # (reference is_op_var_attributed, `vasim.jl:156-164`, `:3036-3056`)
    op_names = [nm for nm, vinfo in mod.variables.items()
                if vinfo[1] and ("desc" in vinfo[1] or "units" in vinfo[1])]
    opvars_fn = None
    if op_names:
        def opvars_fn(u, p, dyn):
            eff, sv = comp._runtime_base(u, p, dyn)
            env = _Env(comp, comp.n_local)
            env.vars = dict(sv)
            if comp.ddx_sites:
                env.ddx_vals = comp._ddx_prepass(u, p, dyn, eff, 0.0,
                                                 setup_vals=sv)
            comp._init_vars(env, u, p, dyn, eff, 0.0)
            for st in comp.runtime_stmts:
                comp._exec(st, env, u, p, dyn, eff, 0.0)
            return {nm: env.vars.get(nm, 0.0) for nm in op_names}

    model = DeviceModel(
        name=f"va:{mod.name}",
        terminals=tuple(comp.ports),
        residual=comp.make_residual(),
        residual_lim=comp.make_residual_lim(),
        lim_branches=tuple(
            (comp.node_idx[pn],
             comp.node_idx[nn] if nn not in (None, "0") else None)
            for (pn, nn) in comp.limit_branches),
        n_lim_sites=len(comp.limit_sites),
        internals=tuple(internals),
        defaults=comp.numeric_defaults(),
        noise=noise_fn,
        flicker=flicker_fn,
        noise_pairs=noise_pairs,
        opvars=opvars_fn,
        structural_params=tuple(sorted(comp.structural_params)),
        n_delay_sites=len(comp.delay_sites),
        delay_probe=comp.make_delay_probe(),
        collapses=tuple(sorted(collapses, key=str)),
        va_setup=comp.host_setup if comp.host_setup_enabled else None,
        va_compiler=comp,
    )
    if _specialize and not collapsed and (comp.collapse_cands
                                          or comp.host_setup_enabled):
        # per-parameter-signature specialization: static branch pruning
        # (big models) + node collapse, cached by (prune, collapse) keys
        by_sig = {}
        cell = {}

        def va_specialize(overrides):
            overrides = overrides or {}
            try:
                sig_key = tuple(sorted(
                    (k, float(v)) for k, v in overrides.items()))
            except Exception:
                sig_key = None
            if sig_key is not None and sig_key in by_sig:
                return by_sig[sig_key]
            mod_p, psig = (mod, "")
            if comp.host_setup_enabled:
                from .prune import prune_module
                mod_p, psig = prune_module(mod, overrides)
            if mod_p is mod:
                keys = comp.decide_collapses(overrides)
                ck = ("", keys)
                if ck not in cell:
                    cell[ck] = (model if not keys else compile_va_module(
                        mod, include_dirs, collapsed=keys,
                        _specialize=False))
            else:
                comp_p = VACompiler(mod_p, include_dirs=include_dirs)
                keys = comp_p.decide_collapses(overrides)
                ck = (psig, keys)
                if ck not in cell:
                    cell[ck] = compile_va_module(
                        mod_p, include_dirs, collapsed=keys,
                        _specialize=False)
            if sig_key is not None:
                by_sig[sig_key] = cell[ck]
            return cell[ck]

        model = dataclasses.replace(model, va_specialize=va_specialize)
    return model


def _resolve_sibling_modules(lib: dict, include_dirs):
    """Instantiated modules not defined in the same file resolve to
    sibling '<Name>.va' files on the include path (the reference model
    packages compile each .va into one package namespace; the photonic
    models instantiate Polar2Cartesian etc. across files)."""
    import os
    changed = True
    while changed:
        changed = False
        needed = set()
        for m in lib.values():
            for inst in m.instances:
                if inst[0] not in lib:
                    needed.add(inst[0])
        for name in needed:
            for d in include_dirs:
                path = os.path.join(d, name + ".va")
                if os.path.exists(path):
                    with open(path) as fh:
                        for mm in parse_va(fh.read(), include_dirs):
                            if mm.name not in lib:
                                lib[mm.name] = mm
                                changed = True
                    break


def compile_va(text: str, include_dirs=()) -> dict:
    """VA source -> {module_name: DeviceModel}. Multi-module files may
    instantiate sibling modules (same file or sibling .va files on the
    include path); hierarchy is flattened by inlining."""
    mods = parse_va(text, include_dirs)
    lib = {m.name: m for m in mods}
    _resolve_sibling_modules(lib, include_dirs)
    return {m.name: compile_va_module(inline_hierarchy(m, lib),
                                      include_dirs=include_dirs)
            for m in mods}


def load_va_file(path: str) -> dict:
    import os
    with open(path) as fh:
        text = fh.read()
    return compile_va(text, include_dirs=[os.path.dirname(
        os.path.abspath(path))])
