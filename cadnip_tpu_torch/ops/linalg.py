"""Dense linear solves for MNA systems (PyTorch port of
`cadnip_tpu/ops/linalg.py`, its four methods).

  * "gauss" — full-f64 Gauss-Jordan with partial pivoting through kernel K1
    (`ops/gj_solve.py`): the hand-written Hopper kernel on a CUDA tensor
    (its warp, block or grid variant by size, so every n), its plain twin
    on a CPU tensor. The port's default on every device and size; it is
    the counterpart of the JAX method of the same name.
  * "lu64" — `torch.linalg.lu_factor`/`lu_solve` in f64, the JAX package's
    CPU default (the method that produced the checked-in goldens).
  * "gjpl32ir" — the JAX package's accelerator method: the matrix is
    equilibrated in f64 (rows, then columns, to unit max-norm), its f32
    inverse comes from ONE launch of K1 in f32 for the whole batch
    (`gj_solve(As, I)`, k = n right-hand sides), and each solve applies
    x = c * (Ainv @ (r * b)) in f32 with `refine` steps of f64 iterative
    refinement x += c * (Ainv @ (r * (b - A x))). On a CUDA tensor the
    inverse is the kernel's or the call raises; it is never computed in
    another method's place.
  * "lu32ir" — the same scheme with an f32 LU of the equilibrated matrix
    (`torch.linalg.lu_factor` / `lu_solve`, a library call, as `jsl` is in
    the JAX package).

Systems are batched: A [..., n, n], b [..., n] or [..., n, k]; the k
columns of a matrix right-hand side go through together (the JAX package
vmaps over them, with the same arithmetic per column). The f32 products run
at full FP32: TF32 must stay off (`torch.backends.cuda.matmul.allow_tf32`
False, float32 matmul precision "highest"), which are torch's defaults.
"""
from __future__ import annotations

import torch

from ..config import DTYPE, F32
from .gj_solve import gj_solve

METHODS = ("gauss", "lu64", "gjpl32ir", "lu32ir")


def _equilibrate(A):
    """Row, then column max-norm scaling in f64 (the JAX package's
    arithmetic): (As, r, c) with As = diag(r) A diag(c), r and c [..., n]."""
    r = 1.0 / torch.clamp(A.abs().amax(-1), min=1e-300)
    As = A * r[..., :, None]
    c = 1.0 / torch.clamp(As.abs().amax(-2), min=1e-300)
    return As * c[..., None, :], r, c


def _f32_inverse(As):
    """The f32 inverse of every [n, n] system of As [..., n, n] (f64):
    one K1 launch in f32 over the flattened batch, with the identity as
    its n right-hand sides."""
    n = As.shape[-1]
    A3 = As.reshape(-1, n, n).to(F32).contiguous()
    eye = torch.eye(n, dtype=F32, device=As.device).expand(
        A3.shape[0], n, n).contiguous()
    return gj_solve(A3, eye).reshape(As.shape)


class DenseLU:
    """Factorization handle supporting repeated solves: `lu` holds the LU
    factors ("lu64", "lu32ir") or the f32 inverse ("gjpl32ir"), `r` and
    `c` the equilibration of the mixed-precision methods."""

    __slots__ = ("lu", "piv", "r", "c", "A", "method")

    def __init__(self, lu, piv, r, c, A, method):
        self.lu, self.piv, self.r, self.c, self.A, self.method = (
            lu, piv, r, c, A, method)

    def solve(self, b, refine: int = 2):
        if self.method == "gauss":
            return gj_solve(self.A, b)
        vec = b.ndim == self.A.ndim - 1
        B = b[..., None] if vec else b
        if self.method == "lu64":
            x = torch.linalg.lu_solve(self.lu, self.piv, B)
        else:
            r, c = self.r[..., :, None], self.c[..., :, None]
            if self.method == "gjpl32ir":
                def inner(v):
                    return self.lu @ v
            else:
                def inner(v):
                    return torch.linalg.lu_solve(self.lu, self.piv, v)

            def apply(v):
                return c * inner((r * v).to(F32)).to(DTYPE)

            x = apply(B)
            for _ in range(refine):
                x = x + apply(B - self.A @ x)
        return x[..., 0] if vec else x


def resolve_method(method: str | None, n: int) -> str:
    """'auto'/None -> "gauss" (K1 in f64) on every device and size; an
    explicit method stays as given."""
    if method in (None, "auto"):
        return "gauss"
    if method not in METHODS:
        raise ValueError(f"unknown solve method {method!r}; the methods are "
                         f"{METHODS} (or 'auto')")
    return method


def factorize(A, method: str | None = "auto") -> DenseLU:
    method = resolve_method(method, A.shape[-1])
    if method == "gauss":
        return DenseLU(None, None, None, None, A, method)
    if method == "lu64":
        lu, piv = torch.linalg.lu_factor(A)
        return DenseLU(lu, piv, None, None, A, method)
    As, r, c = _equilibrate(A)
    if method == "gjpl32ir":
        return DenseLU(_f32_inverse(As), None, r, c, A, method)
    lu, piv = torch.linalg.lu_factor(As.to(F32))
    return DenseLU(lu, piv, r, c, A, method)


def solve(A, b, method: str | None = "auto", refine: int = 2):
    return factorize(A, method).solve(b, refine=refine)


def solve_complex(Ar, Ai, br, bi, method: str | None = "auto",
                  refine: int = 2):
    """Solve (Ar + j Ai) x = (br + j bi) through the real 2N x 2N embedding
    [[Ar, -Ai], [Ai, Ar]] [xr; xi] = [br; bi], batched over the leading
    axes (Ar, Ai [..., n, n]; br, bi [..., n]): with "gauss" or "gjpl32ir",
    one K1 launch for the whole batch. The mixed-precision methods
    equilibrate the embedded system. Returns (xr, xi)."""
    n = Ar.shape[-1]
    lead = br.shape[:-1]
    A = torch.cat([torch.cat([Ar, -Ai], dim=-1),
                   torch.cat([Ai, Ar], dim=-1)], dim=-2)
    b = torch.cat([br, bi], dim=-1)
    if len(lead) > 1:
        A, b = A.reshape(-1, 2 * n, 2 * n), b.reshape(-1, 2 * n)
    x = solve(A, b, method, refine).reshape(lead + (2 * n,))
    return x[..., :n], x[..., n:]
