"""Dense linear solves for MNA systems (PyTorch port of
`cadnip_tpu/ops/linalg.py`, two methods).

  * "gauss" — full-f64 Gauss-Jordan with partial pivoting through kernel K1
    (`ops/gj_solve.py`): the hand-written Hopper kernel on a CUDA tensor
    (its warp, block or grid variant by size, so every n), its plain twin
    on a CPU tensor. The port's default on every device and size; it is
    the counterpart of the JAX method of the same name, and takes the
    sizes the JAX package sent to its TPU kernel (method gjpl32ir, up to
    n = 1024) too.
  * "lu64" — `torch.linalg.lu_factor`/`lu_solve` in f64, the JAX package's
    CPU default (the method that produced the checked-in goldens).

Systems are batched: A [..., n, n], b [..., n] or [..., n, k].
"""
from __future__ import annotations

import torch

from .gj_solve import gj_solve

METHODS = ("gauss", "lu64")


class DenseLU:
    """Factorization handle supporting repeated solves."""

    __slots__ = ("lu", "piv", "A", "method")

    def __init__(self, lu, piv, A, method):
        self.lu, self.piv, self.A, self.method = lu, piv, A, method

    def solve(self, b):
        if self.method == "gauss":
            return gj_solve(self.A, b)
        vec = b.ndim == self.A.ndim - 1
        x = torch.linalg.lu_solve(self.lu, self.piv,
                                  b[..., None] if vec else b)
        return x[..., 0] if vec else x


def resolve_method(method: str | None, n: int) -> str:
    """'auto'/None -> "gauss" (K1) on every device and size."""
    if method in (None, "auto"):
        return "gauss"
    if method not in METHODS:
        raise NotImplementedError(
            f"solve method {method!r} is not ported to cadnip_tpu_torch yet "
            f"(available: {METHODS}; gjpl32ir/lu32ir are later work)")
    return method


def factorize(A, method: str | None = "auto") -> DenseLU:
    method = resolve_method(method, A.shape[-1])
    if method == "gauss":
        return DenseLU(None, None, A, method)
    lu, piv = torch.linalg.lu_factor(A)
    return DenseLU(lu, piv, A, method)


def solve(A, b, method: str | None = "auto"):
    return factorize(A, method).solve(b)


def solve_complex(Ar, Ai, br, bi, method: str | None = "auto"):
    """Solve (Ar + j Ai) x = (br + j bi) through the real 2N x 2N embedding
    [[Ar, -Ai], [Ai, Ar]] [xr; xi] = [br; bi], batched over the leading
    axes (Ar, Ai [..., n, n]; br, bi [..., n]): with "gauss", one K1 launch
    for the whole batch. Returns (xr, xi)."""
    n = Ar.shape[-1]
    lead = br.shape[:-1]
    A = torch.cat([torch.cat([Ar, -Ai], dim=-1),
                   torch.cat([Ai, Ar], dim=-1)], dim=-2)
    b = torch.cat([br, bi], dim=-1)
    if len(lead) > 1:
        A, b = A.reshape(-1, 2 * n, 2 * n), b.reshape(-1, 2 * n)
    x = solve(A, b, method).reshape(lead + (2 * n,))
    return x[..., :n], x[..., n:]
