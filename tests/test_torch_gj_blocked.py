"""K1's grid variant on the CPU: its plain twin `gj_solve_blocked_plain`
(cadnip_tpu_torch/ops/gj_solve.py), the blocked Gauss-Jordan that the
CUDA grid kernel runs, against the JAX package's `linalg.solve` ("gauss"
and "lu64") and its Pallas kernel in f32 (interpret mode); its pivots
against the unblocked twin `gj_solve_plain`; and `gj_solve` on a CPU
tensor at a grid shape, which takes it, with `GJSolve`'s derivative
rules. The CUDA kernel itself runs only on the card (the `gpu` tests of
tests/test_torch_bbd.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp

from cadnip_tpu.ops.linalg import solve as jax_solve
from cadnip_tpu.ops.pallas_solve import gj_solve_f32
from cadnip_tpu_torch.ops import gj_solve as K1
from cadnip_tpu_torch.ops.gj_solve import (PANEL, GJSolve, gj_solve,
                                           gj_solve_blocked_plain,
                                           gj_solve_plain, variant)

torch.set_num_threads(1)

#: relative bound of the blocked twin against JAX's f64 solves: a blocked
#: product sums in another order than the unblocked elimination (observed
#: below 1e-14 on these well-conditioned systems)
JAX_TOL = 1e-11
#: chip_smoke.py's RESID_TOL: ||A x - b||_inf / (||A||_inf ||x||_inf)
RESID_TOL = 1e-13
#: the f32 twin against the f32 Pallas kernel: both eliminate in f32, in
#: another summation order (observed 4.6e-7 of max |x| at n = 180)
F32_TOL = 1e-5


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _systems(n):
    """Two systems of size n, with n + 4 right-hand sides each: k = 1, 3 and
    n take the leading columns."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((2, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    return A, rng.standard_normal((2, n, n + 4))


@functools.lru_cache(maxsize=None)
def _jax_ref(n, lane, method):
    """JAX's solve of system `lane` for all n + 4 columns at once (each
    column is eliminated on its own, so the first k columns are the
    k-column solve); "gauss" runs eagerly (its unrolled loop takes seconds
    to compile at these sizes)."""
    A, B = _systems(n)
    with jax.disable_jit():
        return np.asarray(jax_solve(jnp.asarray(A[lane]),
                                    jnp.asarray(B[lane]), method=method))


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("k", [1, 3, "n"])
@pytest.mark.parametrize("n", [170, 173, 254, 300])
def test_blocked_twin_matches_jax_gauss_and_lu64(n, k, b):
    assert n % PANEL != 0           # a ragged last panel in every case
    k = n if k == "n" else k
    assert variant(n, k) == "grid"
    A, B = _systems(n)
    A, B = A[:b], B[:b, :, :k]
    X = gj_solve_blocked_plain(torch.as_tensor(A), torch.as_tensor(B))
    X = X.numpy()
    for method in ("gauss", "lu64"):
        ref = np.stack([_jax_ref(n, lane, method)[:, :k] for lane in range(b)])
        assert _rel(X, ref) <= JAX_TOL, method
    res = np.abs(A @ X - B).max(axis=(1, 2))
    scale = np.abs(A).sum(-1).max(-1) * np.abs(X).max(axis=(1, 2))
    assert float((res / scale).max()) <= RESID_TOL


def _pivots(A, B):
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    X1, p1 = gj_solve_blocked_plain(At, Bt, return_pivots=True)
    X2, p2 = gj_solve_plain(At, Bt, return_pivots=True)
    return X1.numpy(), p1.numpy(), X2.numpy(), p2.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_pivots_equal_the_unblocked_twin(seed):
    rng = np.random.default_rng(seed)
    n = 200
    A = rng.standard_normal((2, n, n))          # pivoting does real work
    B = rng.standard_normal((2, n, 2))
    X1, p1, X2, p2 = _pivots(A, B)
    np.testing.assert_array_equal(p1, p2)
    assert _rel(X1, X2) <= 1e-9


def test_blocked_exact_ties_take_the_first_row():
    # 2 x 2 blocks [[1, 1], [1, -1]] with their rows scattered: every
    # column's candidates tie exactly (|1| = |1|) and every step is exact
    m = 90
    blocks = np.kron(np.eye(m), np.array([[1.0, 1.0], [1.0, -1.0]]))
    perm = np.random.default_rng(3).permutation(2 * m)
    A = blocks[perm][None]
    B = np.arange(2 * m, dtype=np.float64)[None, :, None]
    assert variant(2 * m, 1) == "grid"
    X1, p1, X2, p2 = _pivots(A, B)
    np.testing.assert_array_equal(p1, p2)
    # step 0: the lower of the two rows holding column 0 wins
    assert p1[0, 0] == np.flatnonzero(A[0, :, 0]).min()
    np.testing.assert_array_equal(X1, X2)
    np.testing.assert_allclose(X1[0], np.linalg.solve(A[0], B[0]), rtol=0,
                               atol=1e-13)


def test_blocked_zero_leading_diagonal():
    rng = np.random.default_rng(5)
    n = 190
    A = rng.standard_normal((1, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    A[0, 0, 0] = A[0, 5, 5] = A[0, 17, 17] = 0.0   # MNA's V-source rows
    B = rng.standard_normal((1, n, 1))
    X1, p1, _, p2 = _pivots(A, B)
    np.testing.assert_array_equal(p1, p2)
    assert p1[0, 0] != 0
    assert _rel(X1[0], np.linalg.solve(A[0], B[0])) <= 1e-12


def test_blocked_singular_gives_nonfinite_without_raising():
    A = np.random.default_rng(2).standard_normal((1, 180, 180))
    A[0, :, 7] = 0.0
    X = gj_solve_blocked_plain(torch.as_tensor(A),
                               torch.ones((1, 180, 1), dtype=torch.float64))
    assert not bool(torch.isfinite(X).all())


def test_blocked_f32_matches_pallas_kernel():
    n = 180
    rng = np.random.default_rng(180)
    A = (rng.standard_normal((n, n)) / np.sqrt(n)
         + 2.0 * np.eye(n)).astype(np.float32)
    B = rng.standard_normal((n, 3)).astype(np.float32)
    X = gj_solve_blocked_plain(torch.as_tensor(A)[None],
                               torch.as_tensor(B)[None])[0].numpy()
    ref = np.asarray(gj_solve_f32(jnp.asarray(A), jnp.asarray(B),
                                  interpret=True))
    assert X.dtype == np.float32
    assert _rel(X, ref) <= F32_TOL


@pytest.mark.parametrize("n, grid", [(180, True), (120, False)])
def test_gj_solve_on_cpu_takes_the_blocked_twin_at_grid_shapes(
        n, grid, monkeypatch):
    calls = []
    twin = K1.gj_solve_blocked_plain

    def counted(A, B, **kw):
        calls.append(A.shape)
        return twin(A, B, **kw)

    monkeypatch.setattr(K1, "gj_solve_blocked_plain", counted)
    A, B = _systems(173)
    At = torch.as_tensor(A[:1, :n, :n]).contiguous()
    Bt = torch.as_tensor(B[:1, :n, :1]).contiguous()
    assert (variant(n, 1) == "grid") == grid
    X = gj_solve(At, Bt)
    assert len(calls) == int(grid)
    assert _rel(X.numpy(), np.linalg.solve(At.numpy(), Bt.numpy())) <= 1e-12


def test_derivative_rules_at_a_grid_shape_match_autodiff_of_the_twin():
    rng = np.random.default_rng(11)
    n, k = 170, 2
    assert variant(n, k) == "grid"
    A, B = _systems(n)
    At = torch.as_tensor(A[:1])
    Bt = torch.as_tensor(B[:1, :, :k]).contiguous()
    dA = torch.as_tensor(rng.standard_normal((1, n, n)))
    dB = torch.as_tensor(rng.standard_normal((1, n, k)))
    gX = torch.as_tensor(rng.standard_normal((1, n, k)))
    X, dX = jvp(GJSolve.apply, (At, Bt), (dA, dB))
    Xp, dXp = jvp(gj_solve_blocked_plain, (At, Bt), (dA, dB))
    assert _rel(X.numpy(), Xp.numpy()) <= 1e-13
    assert _rel(dX.numpy(), dXp.numpy()) <= 1e-12
    grads = vjp(GJSolve.apply, At, Bt)[1](gX)
    grads_p = vjp(gj_solve_blocked_plain, At, Bt)[1](gX)
    for g, gp in zip(grads, grads_p):
        assert _rel(g.numpy(), gp.numpy()) <= 1e-12
