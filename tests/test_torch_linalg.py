"""Dense solves of the port (cadnip_tpu_torch/ops/linalg.py): "gauss"
(kernel K1's plain twin on the CPU) and "lu64" against the JAX package's
f64 LU on batched, well-conditioned 19x19 systems; the mixed-precision
methods "gjpl32ir" (K1's f32 twin on the equilibrated matrix) and
"lu32ir" against the JAX package's same methods on batched MNA-scaled
19x19 systems (rows from 1e-12 to 1e3), its Pallas kernel in interpret
mode. The f32 stages of the two packages differ by f32 rounding (another
elimination order), so each refinement level has its own bar, about ten
times the gap measured on these systems (relative to each system's
max |x|): 2.7e-6 with no refinement, 2.3e-11 after one step, 1.1e-14
after two."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu.ops.pallas_solve as pallas_solve
from cadnip_tpu.ops.linalg import solve as jax_solve
from cadnip_tpu_torch.ops.linalg import (METHODS, factorize, resolve_method,
                                         solve, solve_complex)

torch.set_num_threads(1)

#: port against JAX, relative to max |x| per system, by refinement steps
MIXED_TOL = {0: 3e-5, 1: 2e-10, 2: 1e-13}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's f32 Pallas kernel in interpret mode, as its own
    tests run it on the CPU (`factorize` imports it at call time)."""
    monkeypatch.setattr(pallas_solve, "gj_solve_f32", functools.partial(
        pallas_solve.gj_solve_f32, interpret=True))


def _mna(seed, B=6, n=19):
    """B systems whose rows span 1e-12..1e3 (gmin rows to source rows),
    one zero diagonal (a voltage-source row)."""
    rng = np.random.default_rng(seed)
    s = np.logspace(-12, 3, n)
    rng.shuffle(s)
    A = (rng.standard_normal((B, n, n)) / np.sqrt(n)
         + 2.0 * np.eye(n)) * s[None, :, None]
    A[:, 3, 3] = 0.0
    return A, rng.standard_normal((B, n)) * s


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)
                        / np.abs(ref).max(-1, keepdims=True)))


@pytest.mark.parametrize("method", ["gauss", "lu64"])
def test_batched_solve_matches_jax_lu64(method):
    rng = np.random.default_rng(7)
    B, n = 6, 19
    A = rng.standard_normal((B, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    b = rng.standard_normal((B, n))
    ref = np.asarray(jax.vmap(lambda a, v: jax_solve(a, v, method="lu64"))(
        jnp.asarray(A), jnp.asarray(b)))
    x = solve(torch.as_tensor(A), torch.as_tensor(b), method=method).numpy()
    assert x.shape == (B, n)
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-12)


def test_matrix_rhs_and_method_resolution():
    rng = np.random.default_rng(8)
    n = 19
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    Bm = rng.standard_normal((n, 4))
    for method in ("gauss", "lu64"):
        X = solve(torch.as_tensor(A), torch.as_tensor(Bm),
                  method=method).numpy()
        np.testing.assert_allclose(X, np.linalg.solve(A, Bm), atol=1e-12)
    assert resolve_method(None, n) == "gauss"
    assert resolve_method("auto", 5000) == "gauss"
    for method in METHODS:
        assert resolve_method(method, n) == method
    with pytest.raises(ValueError, match="gjpl32ir"):
        resolve_method("gjpl64", n)


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("method", ["gjpl32ir", "lu32ir"])
def test_mixed_precision_matches_jax(method, refine, pallas_interpret):
    """Batched MNA-scaled systems against the JAX method, one system at a
    time (its Pallas kernel) and vmapped (its batched XLA elimination)."""
    A, b = _mna(11)
    x = solve(torch.as_tensor(A), torch.as_tensor(b), method,
              refine).numpy()
    one = np.stack([np.asarray(jax_solve(jnp.asarray(a), jnp.asarray(v),
                                         method=method, refine=refine))
                    for a, v in zip(A, b)])
    vm = np.asarray(jax.vmap(lambda a, v: jax_solve(
        a, v, method=method, refine=refine))(jnp.asarray(A),
                                             jnp.asarray(b)))
    assert x.shape == b.shape and x.dtype == np.float64
    assert _rel(x, one) <= MIXED_TOL[refine]
    assert _rel(x, vm) <= MIXED_TOL[refine]
    if refine == 2:
        ex = np.linalg.solve(A, b[..., None])[..., 0]
        assert _rel(x, ex) <= 1e-11


@pytest.mark.parametrize("method", ["gjpl32ir", "lu32ir"])
def test_mixed_precision_matrix_rhs(method, pallas_interpret):
    """All k columns go through together; each agrees with its own vector
    solve (a matrix product sums in another order than a matrix-vector
    product) and with the JAX method's solve of the same matrix."""
    A, _ = _mna(12, B=1)
    A = A[0]
    Bm = np.random.default_rng(13).standard_normal((19, 5))
    lu = factorize(torch.as_tensor(A), method)
    X = lu.solve(torch.as_tensor(Bm)).numpy()
    cols = np.stack([lu.solve(torch.as_tensor(Bm[:, j])).numpy()
                     for j in range(5)], 1)
    assert _rel(X.T, cols.T) <= MIXED_TOL[2]
    ref = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(Bm),
                               method=method))
    assert _rel(X.T, ref.T) <= MIXED_TOL[2]


def test_mixed_precision_equilibrates_in_f64_and_inverts_in_f32():
    """gjpl32ir keeps the f32 inverse of diag(r) A diag(c) with r, c the
    JAX package's row and column scales."""
    from cadnip_tpu.ops.linalg import _equilibrate as jax_equilibrate
    A, _ = _mna(14, B=1)
    lu = factorize(torch.as_tensor(A), "gjpl32ir")
    As, r, c = (np.asarray(v) for v in jax_equilibrate(jnp.asarray(A[0])))
    np.testing.assert_array_equal(lu.r[0].numpy(), r)
    np.testing.assert_array_equal(lu.c[0].numpy(), c)
    assert lu.lu.dtype == torch.float32 and lu.lu.shape == A.shape
    err = np.abs(lu.lu[0].double().numpy() @ As - np.eye(19)).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("method", ["gjpl32ir", "lu32ir"])
def test_solve_complex_mixed_precision_matches_jax(method,
                                                   pallas_interpret):
    """(G + jwC) x = b over a batch of frequencies through the real 2N
    form, equilibrated after the embedding (the JAX order)."""
    rng = np.random.default_rng(15)
    n, nf = 9, 4
    s = np.logspace(-9, 2, n)
    G = (rng.standard_normal((n, n)) + 3 * np.eye(n)) * s[:, None]
    C = np.abs(rng.standard_normal((n, n))) * 1e-12
    w = 2 * np.pi * np.logspace(3, 9, nf)
    br = rng.standard_normal(n)
    xr, xi = solve_complex(torch.as_tensor(G).expand(nf, n, n),
                           torch.as_tensor(w[:, None, None] * C),
                           torch.as_tensor(br).expand(nf, n),
                           torch.zeros((nf, n), dtype=torch.float64),
                           method)
    from cadnip_tpu.ops.linalg import solve_complex as jax_complex
    for k in range(nf):
        jr, ji = jax_complex(jnp.asarray(G), jnp.asarray(w[k] * C),
                             jnp.asarray(br), jnp.zeros(n), method=method)
        got = np.concatenate([xr[k].numpy(), xi[k].numpy()])
        want = np.concatenate([np.asarray(jr), np.asarray(ji)])
        assert _rel(got[None], want[None]) <= MIXED_TOL[2], k
