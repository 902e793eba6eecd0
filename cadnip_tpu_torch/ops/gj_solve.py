"""Kernel K1: batched dense Gauss-Jordan solve with partial pivoting.

`gj_solve(A, B)` solves A X = B for a batch of small dense systems. On a
CUDA tensor it launches the hand-written Hopper kernel in
`csrc/gj_solve.cu`; on a CPU tensor it runs the same algorithm in torch
ops (`plain_twin`: `gj_solve_plain` where the warp variant would take
the shape, `gj_solve_blocked_plain` elsewhere). There is no fallback
between the two: a CUDA tensor launches the kernel or raises. The kernel
has three variants (`variant(n, k, itemsize, batch)` picks), in two
forms: "warp", one warp per system with the rows in registers, for the
circuit-sized systems (n <= 32, n + k <= 64), the unblocked elimination;
"block" and "grid", a blocked Gauss-Jordan in panels of PANEL columns,
the pivot chain inside one block with one barrier per pivot and the
trailing update on the f64 tensor cores: "block" with the system in one
block's shared memory, one block per system, up to what it holds
(`block_bytes`; n = 167 in f64 with k = 1), "grid" beyond that (the
Schur complement of the block-bordered-diagonal solve, an AC sweep of a
circuit above about 84 unknowns, a dense solve up to the BBD threshold,
n = 1536) and where a small batch of wide systems runs faster on it
(GRID_BATCH_MAX, GRID_COLS_MIN): one cooperative launch whose teams of
blocks keep [A | B] in device memory (L2-resident at these sizes). All
take the same pivots as `gj_solve_plain`; the blocked form agrees with
it to rounding, not bit for bit (a blocked product sums in another
order).

`gj_solve` is differentiable, forward and reverse, through `GJSolve`
(a `torch.autograd.Function` that `torch.func` transforms accept). Each
derivative rule is one K1 launch: the tangent dX = A^-1 (dB - dA X) and
the cotangents gB = A^-T gX, gA = -gB X^T, each with its products inside
the kernel (`launch_tangent`, `launch_adjoint`; their plain twins
`gj_tangent_plain`, `gj_adjoint_plain`). A rule computes on the tensors it
is given, one transform level down where that level only carries primal
values (`_rule_operands`), and goes back through `GJSolve.apply` only where
an outer transform or autograd must see its arithmetic. Under `vmap` the
mapped axis folds into the kernel's right-hand-side columns (when A is
shared) or into its batch grid, so a `jacfwd` over several parameters is
still one launch per solve. `GJSolve.apply` crosses functorch's dispatch
once per solve, through a single-level function built once
(`_GJSolveLevel`) rather than functorch's, which it builds on every call.

Replaces the TPU kernel `cadnip_tpu/ops/pallas_solve.py::_gj_kernel`. In
f64 it is the counterpart of the JAX package's full-f64 Gauss-Jordan
method "gauss"; in f32 it reproduces `gj_solve_f32`.

The kernel is compiled at first use with nvcc for sm_90a into
`build/cadnip_tpu_torch/` of the checkout, keyed by a hash of its sources
(`ops/nvcc.py`), and bound with ctypes.
"""
from __future__ import annotations

import ctypes

import torch
import torch._C._functorch as _ft
from torch._functorch.autograd_function import custom_function_call
from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter
from torch.autograd import forward_ad
from torch.autograd.forward_ad import _set_fwd_grad_enabled
from torch.autograd.function import _SingleLevelFunction

from ..config import DTYPE, F32
from . import nvcc

#: shared memory a block may use on Hopper (227 KB); the block variant's is
#: all dynamic
MAX_SMEM = 232448

_lib = None


def load_library():
    """Build (once per source hash) and load the K1 shared library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = nvcc.load("gj_solve")
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    for fn in (lib.gj_solve_f64, lib.gj_solve_f32):
        fn.argtypes = [vp, ll, ll, ll, vp, ll, ll, ll, vp, ci, ci, ci, ci,
                       vp]
        fn.restype = ci
    for fn in (lib.gj_block_plan_f64, lib.gj_block_plan_f32):
        fn.argtypes = [ll, ci, ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci),
                       ctypes.POINTER(ll), ctypes.POINTER(ci)]
        fn.restype = ci
    for fn in (lib.gj_solve_warp_f64, lib.gj_solve_warp_f32):
        fn.argtypes = [vp, ll, ll, ll, vp, ll, ll, ll, vp, ci, ci, ci, vp]
        fn.restype = ci
    pi = ctypes.POINTER(ci)
    for fn in (lib.gj_grid_plan_f64, lib.gj_grid_plan_f32):
        fn.argtypes = [ll, ci, ci, ci, pi, pi, pi, pi]
        fn.restype = ci
    for fn in (lib.gj_solve_grid_f64, lib.gj_solve_grid_f32):
        fn.argtypes = [vp, ll, ll, ll, vp, ll, ll, ll, vp, vp, vp, vp, ll,
                       ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    for fn in (lib.gj_rule_f64, lib.gj_rule_f32):
        fn.argtypes = [ci, ci, vp, ll, ll, ll, vp, ll, ll, ll, vp, ll, ll, ll,
                       vp, ll, ll, ll, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    _lib = lib
    return lib


def gj_solve_plain(A, B, return_pivots=False):
    """The kernel's algorithm in torch ops: A [b, n, n], B [b, n, k].

    Per pivot k: row p = argmax |A[i, k]| over i >= k (first index on ties),
    swap rows k and p, eliminate column k from every other row; then
    X = B / diag(A). With `return_pivots`, also the pivot row p of every
    step k, [b, n]."""
    n = A.shape[-1]
    ab = torch.cat([A, B.to(A.dtype)], dim=-1)
    rows = torch.arange(n, device=A.device)
    lanes = torch.arange(ab.shape[0], device=A.device)
    piv = torch.empty((ab.shape[0], n), dtype=torch.long, device=A.device)
    for k in range(n):
        cand = torch.where(rows >= k, ab[:, :, k].abs(), -1.0)
        p = torch.argmax(cand, dim=1)
        piv[:, k] = p
        rowk = ab[:, k, :].clone()
        rowp = ab[lanes, p, :]
        ab[:, k, :] = rowp
        ab[lanes, p, :] = rowk
        factor = ab[:, :, k] / ab[:, k, k, None]
        factor[:, k] = 0.0
        ab = ab - factor[:, :, None] * ab[:, k, None, :]
    diag = torch.diagonal(ab[:, :, :n], dim1=1, dim2=2)
    X = ab[:, :, n:] / diag[:, :, None]
    return (X, piv) if return_pivots else X


#: panel width of the grid variant's blocked elimination (`NB` of
#: csrc/gj_blocked.cuh)
PANEL = 16


def gj_solve_blocked_plain(A, B, return_pivots=False):
    """The grid variant's blocked Gauss-Jordan in torch ops: A [b, n, n],
    B [b, n, k]; the same pivots as `gj_solve_plain`, the same X to
    rounding.

    For each panel of PANEL columns J = [j0, j1): (a) factor the [n, nb]
    panel column by column (the pivot p of column kk = argmax |P[i, kk]|
    over i >= kk, first index on ties; whole panel rows swap, the factors
    G[i, kk] = P[i, kk] / P[kk, kk] of every other row i are kept, and the
    panel's later columns take the rank-1 update); (b) apply the panel's
    swaps, in order, to the trailing columns [j1, n + k); the pivot rows'
    trailing part T_J gives Z by forward substitution,
    Z[c] = T_J[c] - sum_{c' < c} G[j0 + c, j0 + c'] Z[c']; then every row,
    above and below the panel, takes T -= G Z (a matmul; G is 0 at each
    pivot's own column). (c) X = B / diag, each diagonal entry the pivot of
    its step. With `return_pivots`, also the pivot row of every step,
    [b, n]."""
    n = A.shape[-1]
    W = torch.cat([A, B.to(A.dtype)], dim=-1)   # the columns from j0 on
    b = W.shape[0]
    rows = torch.arange(n, device=A.device)
    lanes = torch.arange(b, device=A.device)[:, None]
    pivots, diag = [], []
    for j0 in range(0, n, PANEL):
        nb = min(PANEL, n - j0)
        P, T = W[:, :, :nb], W[:, :, nb:]
        G = torch.zeros_like(P)
        order = rows.expand(b, n).clone()   # the panel's swaps, composed
        for c in range(nb):
            kk = j0 + c
            cand = torch.where(rows >= kk, P[:, :, c].abs(), -1.0)
            p = torch.argmax(cand, dim=1)
            pivots.append(p)
            swap = rows.expand(b, n).clone()
            swap[:, kk] = p
            swap[lanes[:, 0], p] = kk
            order = order.gather(1, swap)
            P = P[lanes, swap]
            G = G[lanes, swap]
            diag.append(P[:, kk, c])
            f = P[:, :, c] / P[:, kk, c, None]
            f = torch.where(rows == kk, 0.0, f)
            G = torch.where(rows[None, None, :nb] == c, f[:, :, None], G)
            P = P - f[:, :, None] * P[:, kk, None, :]
        T = T[lanes, order]
        zs = []
        for c in range(nb):
            z = T[:, j0 + c, :]
            for cp in range(c):
                z = z - G[:, j0 + c, cp, None] * zs[cp]
            zs.append(z)
        W = T - G @ torch.stack(zs, dim=1)
    X = W / torch.stack(diag, dim=1)[:, :, None]
    return (X, torch.stack(pivots, dim=1)) if return_pivots else X


#: largest system of the warp variant: one row per lane, and the
#: augmented row in at most 64 registers of each lane
WARP_ROWS, WARP_COLS = 32, 64

#: the block variant's work area (csrc/gj_blocked.cuh): candidates of up to
#: MAX_WARPS warps (two rounds), Z's row padding, and the fewest columns of
#: Z (CW)
_MAX_WARPS, _ZPAD, _ZW_MIN = 8, 4, 16


def block_work_bytes(n: int, zw: int, itemsize: int) -> int:
    """Shared memory of the blocked elimination's work area beside an
    n-unknown system (`gjb::smem_work_bytes`): the candidates (a key, two
    ints, a value and its reciprocal), Z of zw columns, the pivots, the
    slots' logical rows and the pivot slots."""
    cand = 16 + 2 * itemsize
    return (cand * 2 * _MAX_WARPS + itemsize * (PANEL * (zw + _ZPAD) + n)
            + 4 * 2 * n)


def block_bytes(n: int, k: int, itemsize: int = 8) -> int:
    """The least shared memory of the block variant for an [n, n + k]
    system (`block_smem` of csrc/gj_solve.cu with Z at its fewest columns):
    the work area and the system at an odd row stride, with a panel's width
    of padding after it."""
    return block_work_bytes(n, _ZW_MIN, itemsize) \
        + itemsize * (n * ((n + k) | 1) + PANEL)


#: where the grid variant is faster than the block variant although one
#: block holds the system: a batch of at most GRID_BATCH_MAX systems (the
#: grid variant's team then spreads each system's trailing product over two
#: SMs or more of an H100) with n + k >= GRID_COLS_MIN columns (the product
#: outweighs the pivot chain). Measured on an H100 in f64 (PERF.md)
GRID_BATCH_MAX, GRID_COLS_MIN = 64, 145


def variant(n: int, k: int, itemsize: int = 8, batch: int = 1) -> str:
    """The kernel variant for `batch` [n, n] systems with k right-hand sides
    of `itemsize` bytes (8: f64, 4: f32)."""
    if n <= WARP_ROWS and n + k <= WARP_COLS:
        return "warp"
    if block_bytes(n, k, itemsize) > MAX_SMEM:
        return "grid"
    if batch <= GRID_BATCH_MAX and n + k >= GRID_COLS_MIN:
        return "grid"
    return "block"


#: the grid variant's entries, by the plan's number (csrc/gj_solve.cu): the
#: panel in the owner block's shared memory, or in L2 beyond it
GRID_ENTRIES = ("grid", "grid-l2")


def grid_plan(A, B, entry=None):
    """The grid variant's plan for CUDA tensors A [b, n, n], B [b, n, k]:
    (entry, blocks per system, systems at once, the work area's row
    stride); `entry` forces one of GRID_ENTRIES (None: the plan's own).
    Raises where the card cannot take the plan."""
    lib = load_library()
    batch, n, _ = A.shape
    k = B.shape[-1]
    want = -1 if entry is None else GRID_ENTRIES.index(entry)
    ent, team, teams, ldw = (ctypes.c_int(0) for _ in range(4))
    plan = lib.gj_grid_plan_f64 if A.dtype == DTYPE else lib.gj_grid_plan_f32
    err = plan(batch, n, k, want, ctypes.byref(ent), ctypes.byref(team),
               ctypes.byref(teams), ctypes.byref(ldw))
    if err != 0:
        raise RuntimeError(f"gj_solve: the grid variant cannot be planned on "
                           f"this card for [{batch}, {n}, {n}+{k}] (entry "
                           f"{entry or 'of the plan'}; cudaError {err}: a "
                           f"cooperative launch refused)")
    return GRID_ENTRIES[ent.value], team.value, teams.value, ldw.value


def plain_twin(A, B):
    """The plain twin of the variant that takes A [b, n, n], B [b, n, k]:
    `gj_solve_plain` for the warp variant, else (the block and grid
    variants' panels) `gj_solve_blocked_plain`."""
    warp = variant(A.shape[-1], B.shape[-1], A.element_size()) == "warp"
    return (gj_solve_plain if warp else gj_solve_blocked_plain)(A, B)


def gj_tangent_plain(A, X, dA, dB):
    """The tangent entry's function in torch ops: dX = A^-1 (dB - dA X)
    for A, dA [b, n, n] and X, dB [b, n, k] (dB None: no tangent of B), the
    right-hand side formed first, then `plain_twin`'s elimination."""
    R = -(dA @ X) if dB is None else dB - dA @ X
    return plain_twin(A, R)


def gj_adjoint_plain(A, X, gX, want_gA=True):
    """The adjoint entry's function in torch ops: (gA, gB) with
    gB = A^-T gX (`plain_twin` on A's transposed view) and gA = -gB X^T
    (None unless `want_gA`)."""
    gB = plain_twin(A.transpose(-1, -2), gX)
    return (-gB @ X.transpose(-1, -2) if want_gA else None), gB


def block_plan(batch: int, n: int, k: int, dtype=DTYPE):
    """The block variant's plan on this card for `batch` [n, n + k]
    systems: (threads per block, columns of Z, shared memory bytes per
    block, systems per SM). Raises where the system does not fit one
    block."""
    lib = load_library()
    th, zw, per_sm = (ctypes.c_int(0) for _ in range(3))
    smem = ctypes.c_longlong(0)
    plan = lib.gj_block_plan_f64 if dtype == DTYPE else lib.gj_block_plan_f32
    err = plan(batch, n, k, 0, ctypes.byref(th), ctypes.byref(zw),
               ctypes.byref(smem), ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"gj_solve: no block plan for [{n}, {n}+{k}] "
                           f"(cudaError {err})")
    return th.value, zw.value, smem.value, per_sm.value


def _grid_launch(lib, A, B, X, stream, entry=None):
    """The grid variant: a plan from the library, its work area, one
    cooperative launch on `stream`."""
    batch, n, _ = A.shape
    k = B.shape[-1]
    ent, team, teams, ldw = grid_plan(A, B, entry)
    dev, dt = A.device, A.dtype
    work = torch.empty((teams, n, ldw), dtype=dt, device=dev)
    pslot = torch.empty((teams, n), dtype=torch.int32, device=dev)
    dg = torch.empty((teams, n), dtype=dt, device=dev)
    fn = lib.gj_solve_grid_f64 if dt == DTYPE else lib.gj_solve_grid_f32
    return fn(A.data_ptr(), *A.stride(), B.data_ptr(), *B.stride(),
              X.data_ptr(), work.data_ptr(), pslot.data_ptr(), dg.data_ptr(),
              batch, n, k, GRID_ENTRIES.index(ent), team, teams, stream)


def launch(A, B, which=None, entry=None):
    """One kernel launch on CUDA tensors A [b, n, n], B [b, n, k]; `which`
    forces "warp", "block" or "grid" (default `variant(n, k, itemsize,
    b)`), `entry` one of the grid variant's GRID_ENTRIES (default its
    plan's)."""
    lib = load_library()
    batch, n, _ = A.shape
    k = B.shape[-1]
    itemsize = A.element_size()
    which = which or variant(n, k, itemsize, batch)
    if which == "block" and block_bytes(n, k, itemsize) > MAX_SMEM:
        raise ValueError(
            f"gj_solve: [{n}, {n}+{k}] does not fit one block's shared "
            f"memory ({MAX_SMEM} bytes); the grid variant takes it")
    if which == "warp" and variant(n, k) != "warp":
        raise ValueError(f"gj_solve: the warp variant takes n <= "
                         f"{WARP_ROWS} and n + k <= {WARP_COLS}, got "
                         f"[{n}, {n}+{k}]")
    X = torch.empty((batch, n, k), dtype=A.dtype, device=A.device)
    f64 = A.dtype == DTYPE
    stream = torch.cuda.current_stream(A.device).cuda_stream
    args = (A.data_ptr(), *A.stride(), B.data_ptr(), *B.stride(),
            X.data_ptr(), batch, n, k)
    if which == "warp":
        fn = lib.gj_solve_warp_f64 if f64 else lib.gj_solve_warp_f32
        err = fn(*args, stream)
    elif which == "block":
        fn = lib.gj_solve_f64 if f64 else lib.gj_solve_f32
        err = fn(*args, 0, stream)
    else:
        err = _grid_launch(lib, A, B, X, stream, entry)
    if err != 0:
        raise RuntimeError(f"gj_solve kernel launch failed: cudaError {err}")
    gj_solve.launches += 1
    gj_solve.f32_launches += int(not f64)
    return X


#: the rule entries' modes (csrc/gj_solve.cu, RuleMode)
TANGENT, ADJOINT = 1, 2


def _launch_rule(mode, A, B, X, dA, out, gA, which):
    """One launch of a rule entry (warp or block form) on CUDA tensors;
    A is passed by its strides (the adjoint's, A's transposed view)."""
    lib = load_library()
    batch, n, _ = A.shape
    k = X.shape[-1]
    fn = lib.gj_rule_f64 if A.dtype == DTYPE else lib.gj_rule_f32
    bp, bs = (0, (0, 0, 0)) if B is None else (B.data_ptr(), B.stride())
    dp, ds = (0, (0, 0, 0)) if dA is None else (dA.data_ptr(), dA.stride())
    err = fn(int(which == "warp"), mode, A.data_ptr(), *A.stride(), bp, *bs,
             X.data_ptr(), *X.stride(), dp, *ds, out.data_ptr(),
             0 if gA is None else gA.data_ptr(), batch, n, k, 0,
             torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gj_solve rule launch failed: cudaError {err}")
    gj_solve.launches += 1
    gj_solve.rule_launches += 1
    gj_solve.f32_launches += int(A.dtype == F32)


def launch_tangent(A, X, dA, dB, which=None):
    """dX = A^-1 (dB - dA X) in one kernel launch on CUDA tensors A, dA
    [b, n, n], X, dB [b, n, k] (dB None: no tangent of B; any strides): the
    warp and block forms form the right-hand side while they stage it, the
    grid variant takes it from a torch product. `which` forces a variant."""
    batch, n, _ = A.shape
    k = X.shape[-1]
    which = which or variant(n, k, A.element_size(), batch)
    if which == "grid":
        return launch(A, -(dA @ X) if dB is None else dB - dA @ X, "grid")
    dX = torch.empty((batch, n, k), dtype=A.dtype, device=A.device)
    _launch_rule(TANGENT, A, dB, X, dA, dX, None, which)
    return dX


def launch_adjoint(A, X, gX, want_gA=True, which=None):
    """(gA, gB): gB = A^-T gX and gA = -gB X^T (None unless `want_gA`) in
    one kernel launch on CUDA tensors A [b, n, n], X, gX [b, n, k]; the
    kernel reads A by its transposed strides and writes gA in its epilogue
    (the grid variant: its solve, then a torch product). `which` forces a
    variant."""
    batch, n, _ = A.shape
    k = X.shape[-1]
    At = A.transpose(-1, -2)
    which = which or variant(n, k, A.element_size(), batch)
    if which == "grid":
        gB = launch(At, gX, "grid")
        return (-gB @ X.transpose(-1, -2) if want_gA else None), gB
    gB = torch.empty((batch, n, k), dtype=A.dtype, device=A.device)
    gA = torch.empty((batch, n, n), dtype=A.dtype,
                     device=A.device) if want_gA else None
    _launch_rule(ADJOINT, At, gX, X, None, gB, gA, which)
    return gA, gB


def _by_device(kernel, twin, *args):
    """The kernel on a CUDA tensor, its plain twin on a CPU tensor."""
    dev = args[0].device.type
    if dev == "cuda":
        return kernel(*args)
    if dev == "cpu":
        with torch.no_grad():
            return twin(*args)
    raise ValueError(f"gj_solve: unsupported device {args[0].device}")


def _free(ts):
    """Whether the kernel (or its twin) may take these tensors as they
    are: none is a functorch wrapper, and autograd records none."""
    grad = torch.is_grad_enabled()
    return not any(t is not None and (_ft.is_functorch_wrapped_tensor(t)
                                      or (grad and t.requires_grad))
                   for t in ts)


def _unwrap_dead(t):
    """t without the wrappers of transforms that have exited (the tensors
    torch.func.vjp saved)."""
    while t is not None and _ft.is_functorch_wrapped_tensor(t) \
            and _ft.is_dead_tensor_wrapper(t):
        t = _ft.unwrap_if_dead(t)
    return t


def _rule_operands(ctx, ts, kind):
    """A rule's operands without the wrappers it may drop, and the
    interpreter of the level dropped (None if none): the dead wrappers,
    then, where the innermost live transform is of the rule's `kind` (a
    jvp level for the tangent, a grad level for the cotangent), that
    level's own. Inside its rule that level carries primal values only, so
    the rule computes one level down and wraps its results at the level
    again (`_at_level`). The interpreter is the one `_GJSolveLevel` kept on
    ctx where its level is that one."""
    ts = tuple(_unwrap_dead(t) for t in ts)
    top = _ft.peek_interpreter_stack()
    if top is None or top.key() != kind:
        return ts, None
    level = top.level()
    interp = getattr(ctx, "interp", None)
    if interp is None or interp.level() != level:
        interp = retrieve_current_functorch_interpreter()
    return (tuple(None if t is None else _ft._unwrap_for_grad(t, level)
                  for t in ts), interp)


def _at_level(interp, fn, *args):
    """fn(*args) one level below `interp` (as-is where it is None), under
    the grad modes that level was entered with (as functorch passes an op
    to the next level), its tensors wrapped at that level again."""
    if interp is None:
        return fn(*args)
    with torch.enable_grad(), _set_fwd_grad_enabled(True), interp.lower():
        out = fn(*args)
    level = interp.level()
    wrap = (lambda t: None if t is None else _ft._wrap_for_grad(t, level))
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _solve(A, B):
    """X = A^-1 B: the kernel or its twin where the operands are free,
    else through `GJSolve.apply`."""
    if _free((A, B)):
        return GJSolve.forward(A, B)
    return GJSolve.apply(A, B)


def _tangent(A, X, dA, dB):
    """dX of a solve: one fused launch (or its twin) where the operands are
    free, else the right-hand side by torch ops and one solve through
    `GJSolve.apply`."""
    if dA is None:
        return _solve(A, dB)
    if _free((A, X, dA, dB)):
        return _by_device(launch_tangent, gj_tangent_plain, A, X, dA, dB)
    return GJSolve.apply(A, -(dA @ X) if dB is None else dB - dA @ X)


def _adjoint(A, X, gX, want_gA):
    """(gA, gB) of a solve: one fused launch (or its twin) where the
    operands are free, else one solve through `GJSolve.apply` on A's
    transposed view and a torch product."""
    if _free((A, X, gX)):
        return _by_device(launch_adjoint, gj_adjoint_plain, A, X, gX,
                          want_gA)
    gB = GJSolve.apply(A.transpose(-1, -2), gX)
    return (-gB @ X.transpose(-1, -2) if want_gA else None), gB


class GJSolve(torch.autograd.Function):
    """X = A^-1 B for A [b, n, n] and B [b, n, k] (any strides), with
    derivative rules that are one K1 launch each."""

    @staticmethod
    def forward(A, B):
        return _by_device(launch, plain_twin, A, B)

    @classmethod
    def apply(cls, A, B):
        """`Function.apply` for (A, B) without its per-call binding of
        `forward`'s signature. Under a grad or jvp transform, one crossing
        through `_GJSolveLevel`; under vmap, functorch's dispatch."""
        A, B = _unwrap_dead(A), _unwrap_dead(B)
        top = _ft.peek_interpreter_stack()
        if top is None:
            return super(torch.autograd.Function, cls).apply(A, B)
        if top.key() in (_ft.TransformType.Grad, _ft.TransformType.Jvp):
            interp = retrieve_current_functorch_interpreter()
            lift = interp._cptr.lift
            allowed = _ft.get_single_level_autograd_function_allowed()
            _ft.set_single_level_autograd_function_allowed(True)
            try:
                return _GJSolveLevel.apply(lift(A), lift(B), interp)
            finally:
                _ft.set_single_level_autograd_function_allowed(allowed)
        return custom_function_call(cls, A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _ = inputs
        ctx.save_for_backward(A, output)
        ctx.save_for_forward(A, output)

    @staticmethod
    def jvp(ctx, dA, dB):
        ops, interp = _rule_operands(ctx, ctx.saved_tensors + (dA, dB),
                                     _ft.TransformType.Jvp)
        return _at_level(interp, _tangent, *ops)

    @staticmethod
    def backward(ctx, gX):
        (A, X, gX), interp = _rule_operands(ctx, ctx.saved_tensors + (gX,),
                                            _ft.TransformType.Grad)
        return _at_level(interp, _adjoint, A, X, gX, ctx.needs_input_grad[0])

    @staticmethod
    def vmap(info, in_dims, A, B):
        dA, dB = in_dims
        V = info.batch_size
        if dA is None:
            # shared systems: the V mapped right-hand sides become columns
            Bv = B.movedim(dB, -1)
            b, n, k = Bv.shape[:3]
            X = _solve(A, Bv.reshape(b, n, k * V))
            return X.reshape(b, n, k, V).movedim(-1, 0), 0
        A = A.movedim(dA, 0)
        B = B.expand((V,) + B.shape) if dB is None else B.movedim(dB, 0)
        X = _solve(A.reshape((-1,) + A.shape[2:]),
                   B.reshape((-1,) + B.shape[2:]))
        return X.reshape(B.shape), 0


class _GJSolveLevel(_SingleLevelFunction):
    """`GJSolve` at one grad or jvp transform level: what functorch's
    `generate_single_level_function` (torch/_functorch/autograd_function.py)
    builds anew on every call, built once. Its forward takes the level's
    interpreter beside A and B, unwraps them at the level, solves one level
    down and wraps X at the level; its rules are GJSolve's."""

    @staticmethod
    def forward(A, B, interp):
        level = interp.level()
        A, B = _ft._unwrap_for_grad(A, level), _ft._unwrap_for_grad(B, level)
        with torch.enable_grad(), _set_fwd_grad_enabled(True), interp.lower():
            X = _solve(A, B)
        return _ft._wrap_for_grad(X, level)

    @staticmethod
    def setup_context(ctx, inputs, output):
        GJSolve.setup_context(ctx, inputs[:2], output)
        ctx.interp = inputs[2]

    @staticmethod
    def jvp(ctx, dA, dB, _):
        return GJSolve.jvp(ctx, dA, dB)

    @staticmethod
    def backward(ctx, gX):
        return GJSolve.backward(ctx, gX) + (None,)


def _derivative_may_flow(A, B):
    """Whether a derivative can pass through this solve: a torch.func
    transform is active, a forward-AD level is open, or reverse-mode grad
    is on with an input that requires it. Otherwise `gj_solve` calls
    `GJSolve.forward` itself, which saves the ~20 us of host time that
    `Function.apply` costs on every plain Newton solve."""
    return (torch._C._are_functorch_transforms_active()
            or forward_ad._current_level >= 0
            or (torch.is_grad_enabled()
                and (A.requires_grad or B.requires_grad)))


def gj_solve(A, B):
    """Solve A X = B. A: [n, n] or [b, n, n]; B: [n], [n, k] or [b, n],
    [b, n, k] (a vector right-hand side per system comes back as a vector).
    Both f64 or both f32, contiguous, on one device. Differentiable."""
    if A.ndim not in (2, 3) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"gj_solve: A must be [n, n] or [b, n, n], got "
                         f"{tuple(A.shape)}")
    vec = B.ndim == A.ndim - 1
    A3 = A if A.ndim == 3 else A[None]
    B3 = B[..., None] if vec else B
    B3 = B3 if B3.ndim == 3 else B3[None]
    if B3.ndim != 3 or B3.shape[:2] != A3.shape[:2]:
        raise ValueError(f"gj_solve: B {tuple(B.shape)} does not match A "
                         f"{tuple(A.shape)}")
    if A.dtype not in (DTYPE, F32) or B.dtype != A.dtype:
        raise TypeError(f"gj_solve: A and B must both be float64 or both "
                        f"float32, got {A.dtype} and {B.dtype}")
    if A.device != B.device:
        raise ValueError(f"gj_solve: A on {A.device}, B on {B.device}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("gj_solve: A and B must be contiguous")
    X = GJSolve.apply(A3, B3) if _derivative_may_flow(A3, B3) \
        else GJSolve.forward(A3, B3)
    X = X if A.ndim == 3 else X[0]
    return X[..., 0] if vec else X


#: kernel launches since the last reset, every variant and the derivative
#: rules included (plain-twin calls do not count)
gj_solve.launches = 0
#: launches of the fused rule entries (`launch_tangent`, `launch_adjoint`
#: in the warp and block forms) since the last reset, also counted in
#: `launches`
gj_solve.rule_launches = 0
#: launches in f32 (the "gjpl32ir" inverses among them) since the last
#: reset, also counted in `launches`
gj_solve.f32_launches = 0
