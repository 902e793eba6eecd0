"""Kernel K1: batched dense Gauss-Jordan solve with partial pivoting.

`gj_solve(A, B)` solves A X = B for a batch of small dense systems. On a
CUDA tensor it launches the hand-written Hopper kernel in
`csrc/gj_solve.cu`; on a CPU tensor it runs `gj_solve_plain`, the same
algorithm in torch ops. There is no fallback between the two: a CUDA
tensor launches the kernel or raises. The kernel has three variants with
one arithmetic (`variant(n, k, itemsize)` picks): "warp", one warp per
system with the rows in registers, for the circuit-sized systems
(n <= 32, n + k <= 64); "block", one thread block per system with the
augmented block in shared memory, up to what one block's shared memory
holds; "grid", one cooperative launch whose teams of blocks keep the
augmented block in device memory (L2-resident at these sizes) with a
grid-wide barrier between the phases of each pivot, for the systems
beyond that: the Schur complement of the block-bordered-diagonal solve,
an AC sweep of a circuit above about 84 unknowns, a dense solve up to
the BBD threshold (n = 1536).

`gj_solve` is differentiable, forward and reverse, through `GJSolve`
(a `torch.autograd.Function` that `torch.func` transforms accept). Each
derivative rule is one more K1 solve: the tangent dX = A^-1 (dB - dA X),
the cotangents gB = A^-T gX and gA = -gB X^T. Under `vmap` the mapped
axis folds into the kernel's right-hand-side columns (when A is shared)
or into its batch grid, so a `jacfwd` over several parameters is still
one launch per solve.

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
from torch.autograd import forward_ad

from ..config import DTYPE, F32
from . import nvcc

#: dynamic shared memory a block may use on Hopper (227 KB), less the
#: kernel's static reduction scratch
MAX_SMEM = 232448 - 1024

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
    for fn in (lib.gj_solve_warp_f64, lib.gj_solve_warp_f32):
        fn.argtypes = [vp, ll, ll, ll, vp, ll, ll, ll, vp, ci, ci, ci, vp]
        fn.restype = ci
    pi = ctypes.POINTER(ci)
    for fn in (lib.gj_grid_plan_f64, lib.gj_grid_plan_f32):
        fn.argtypes = [ll, ci, ci, pi, pi]
        fn.restype = ci
    for fn in (lib.gj_solve_grid_f64, lib.gj_solve_grid_f32):
        fn.argtypes = [vp, ll, ll, ll, vp, ll, ll, ll, vp, vp, vp, vp, ll,
                       ci, ci, ci, ci, vp]
        fn.restype = ci
    _lib = lib
    return lib


def gj_solve_plain(A, B):
    """The kernel's algorithm in torch ops: A [b, n, n], B [b, n, k].

    Per pivot k: row p = argmax |A[i, k]| over i >= k (first index on ties),
    swap rows k and p, eliminate column k from every other row; then
    X = B / diag(A)."""
    n = A.shape[-1]
    ab = torch.cat([A, B.to(A.dtype)], dim=-1)
    rows = torch.arange(n, device=A.device)
    lanes = torch.arange(ab.shape[0], device=A.device)
    for k in range(n):
        cand = torch.where(rows >= k, ab[:, :, k].abs(), -1.0)
        p = torch.argmax(cand, dim=1)
        rowk = ab[:, k, :].clone()
        rowp = ab[lanes, p, :]
        ab[:, k, :] = rowp
        ab[lanes, p, :] = rowk
        factor = ab[:, :, k] / ab[:, k, k, None]
        factor[:, k] = 0.0
        ab = ab - factor[:, :, None] * ab[:, k, None, :]
    diag = torch.diagonal(ab[:, :, :n], dim1=1, dim2=2)
    return ab[:, :, n:] / diag[:, :, None]


#: largest system of the warp variant: one row per lane, and the
#: augmented row in at most 64 registers of each lane
WARP_ROWS, WARP_COLS = 32, 64


def variant(n: int, k: int, itemsize: int = 8) -> str:
    """The kernel variant for an [n, n] system with k right-hand sides of
    `itemsize` bytes (8: f64, 4: f32)."""
    if n <= WARP_ROWS and n + k <= WARP_COLS:
        return "warp"
    return "block" if itemsize * n * (n + k) <= MAX_SMEM else "grid"


def _grid_launch(lib, A, B, X, stream):
    """The grid variant: a plan from the library (blocks per system,
    systems at once), its work area and candidates, one cooperative
    launch on `stream`."""
    batch, n, _ = A.shape
    k = B.shape[-1]
    f64 = A.dtype == DTYPE
    team, teams = ctypes.c_int(0), ctypes.c_int(0)
    plan = lib.gj_grid_plan_f64 if f64 else lib.gj_grid_plan_f32
    err = plan(batch, n, k, ctypes.byref(team), ctypes.byref(teams))
    if err != 0:
        raise RuntimeError(f"gj_solve: the grid variant cannot be planned "
                           f"on this card (cudaError {err}; it needs a "
                           f"cooperative launch)")
    work = torch.empty((teams.value, n, n + k), dtype=A.dtype,
                       device=A.device)
    cand_v = torch.empty(teams.value * team.value, dtype=A.dtype,
                         device=A.device)
    cand_i = torch.empty(teams.value * team.value, dtype=torch.int32,
                         device=A.device)
    fn = lib.gj_solve_grid_f64 if f64 else lib.gj_solve_grid_f32
    return fn(A.data_ptr(), *A.stride(), B.data_ptr(), *B.stride(),
              X.data_ptr(), work.data_ptr(), cand_v.data_ptr(),
              cand_i.data_ptr(), batch, n, k, team.value, teams.value,
              stream)


def launch(A, B, which=None):
    """One kernel launch on CUDA tensors A [b, n, n], B [b, n, k]; `which`
    forces "warp", "block" or "grid" (default `variant(n, k, itemsize)`)."""
    lib = load_library()
    batch, n, _ = A.shape
    k = B.shape[-1]
    itemsize = A.element_size()
    which = which or variant(n, k, itemsize)
    if which == "block" and itemsize * n * (n + k) > MAX_SMEM:
        raise ValueError(
            f"gj_solve: [{n}, {n}+{k}] does not fit one block's shared "
            f"memory ({MAX_SMEM} bytes); the grid variant takes it")
    if which == "warp" and variant(n, k) != "warp":
        raise ValueError(f"gj_solve: the warp variant takes n <= "
                         f"{WARP_ROWS} and n + k <= {WARP_COLS}, got "
                         f"[{n}, {n}+{k}]")
    if which == "grid" and itemsize * (n + k) > MAX_SMEM:
        raise ValueError(
            f"gj_solve: the grid variant stages one row of [A | B] in "
            f"shared memory, so it takes n + k <= {MAX_SMEM // itemsize} "
            f"at {itemsize} bytes an element, got [{n}, {n}+{k}]")
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
        err = fn(*args, 32 * min(8, n), stream)
    else:
        err = _grid_launch(lib, A, B, X, stream)
    if err != 0:
        raise RuntimeError(f"gj_solve kernel launch failed: cudaError {err}")
    gj_solve.launches += 1
    return X


class GJSolve(torch.autograd.Function):
    """X = A^-1 B for A [b, n, n] and B [b, n, k], contiguous, with
    derivative rules that are K1 solves themselves."""

    @staticmethod
    def forward(A, B):
        if A.device.type == "cuda":
            return launch(A, B)
        if A.device.type == "cpu":
            with torch.no_grad():
                return gj_solve_plain(A, B)
        raise ValueError(f"gj_solve: unsupported device {A.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _ = inputs
        ctx.save_for_backward(A, output)
        ctx.save_for_forward(A, output)

    @staticmethod
    def jvp(ctx, dA, dB):
        A, X = ctx.saved_tensors
        rhs = torch.zeros_like(X) if dB is None else dB
        if dA is not None:
            rhs = rhs - dA @ X
        return GJSolve.apply(A, rhs.contiguous())

    @staticmethod
    def backward(ctx, gX):
        A, X = ctx.saved_tensors
        gB = GJSolve.apply(A.transpose(-1, -2).contiguous(), gX.contiguous())
        return -gB @ X.transpose(-1, -2), gB

    @staticmethod
    def vmap(info, in_dims, A, B):
        dA, dB = in_dims
        V = info.batch_size
        if dA is None:
            # shared systems: the V mapped right-hand sides become columns
            Bv = B.movedim(dB, -1)
            b, n, k = Bv.shape[:3]
            X = GJSolve.apply(A, Bv.reshape(b, n, k * V).contiguous())
            return X.reshape(b, n, k, V).movedim(-1, 0), 0
        A = A.movedim(dA, 0)
        B = B.expand((V,) + B.shape) if dB is None else B.movedim(dB, 0)
        X = GJSolve.apply(A.reshape((-1,) + A.shape[2:]).contiguous(),
                          B.reshape((-1,) + B.shape[2:]).contiguous())
        return X.reshape(B.shape), 0


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
