"""Kernel K1 (cadnip_tpu_torch/ops/gj_solve.py): the plain twin against the
JAX package's Pallas Gauss-Jordan kernel (interpret mode) in f32 and its
full-f64 `gauss_solve`, the wrapper's argument checks, and the derivative
rules of `GJSolve` (jvp, vjp, vmap) against autodiff of the twin and of
`jnp.linalg.solve`, and the choice between the kernel's warp and block
variants. The CUDA kernel itself runs only on the card (the `gpu`
marker): there the warp variant is held to `gj_solve_plain`, and the block
variant at the same shapes to `gj_solve_blocked_plain` (the two forms sum
in other orders, so they agree to rounding, not bit for bit), and each
rule's fused entry (`launch_tangent`, `launch_adjoint`) to its twin. Here
the twins of the rule entries are held to JAX, the rules' route is counted
(one crossing of `GJSolve.apply` per solve) and nested transforms go
through them."""
import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from torch.func import grad, jacfwd, jacrev, jvp, vjp, vmap

from cadnip_tpu.ops.linalg import gauss_solve
from cadnip_tpu.ops.pallas_solve import gj_solve_f32
import cadnip_tpu_torch.ops.gj_solve as K1
from cadnip_tpu_torch.ops.gj_solve import (GJSolve, gj_adjoint_plain,
                                           gj_solve, gj_solve_blocked_plain,
                                           gj_solve_plain, gj_tangent_plain,
                                           launch, launch_adjoint,
                                           launch_tangent, variant)

torch.set_num_threads(1)


def _case(name):
    rng = np.random.default_rng({"zero_diag": 0, "matrix_rhs": 1,
                                 "batch": 2}[name])
    if name == "zero_diag":
        n = 19
        A = rng.standard_normal((n, n)) + np.eye(n) * 3
        A[5, 5] = 0.0          # MNA V-source row: zero diagonal forces pivot
        return A, rng.standard_normal(n)
    if name == "matrix_rhs":
        n = 12
        A = rng.standard_normal((n, n)) + np.eye(n) * 4
        return A, rng.standard_normal((n, 3))
    n = 12
    A = rng.standard_normal((4, n, n)) + np.eye(n) * 4
    return A, rng.standard_normal((4, n))


@pytest.mark.parametrize("name", ["zero_diag", "matrix_rhs", "batch"])
def test_plain_f32_matches_pallas_kernel(name):
    A, B = _case(name)
    x = gj_solve(torch.as_tensor(A, dtype=torch.float32),
                 torch.as_tensor(B, dtype=torch.float32)).numpy()
    if A.ndim == 3:
        ref = np.stack([np.asarray(gj_solve_f32(
            jnp.asarray(a), jnp.asarray(b), interpret=True))
            for a, b in zip(A, B)])
    else:
        ref = np.asarray(gj_solve_f32(jnp.asarray(A), jnp.asarray(B),
                                      interpret=True))
    assert x.dtype == np.float32 and x.shape == ref.shape
    # same algorithm and arithmetic order in f32
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_f64_matches_gauss_solve_and_numpy(seed):
    rng = np.random.default_rng(seed)
    n = 19
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    A[3, 3] = 0.0
    b = rng.standard_normal(n)
    x = gj_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    ref = np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=0, atol=1e-10)


def test_plain_ties_take_the_first_row():
    # |A[:, 0]| ties between rows 1 and 2: jax.lax.argmax takes row 1
    A = np.array([[0.0, 1.0, 2.0], [-2.0, 1.0, 0.0], [2.0, 0.0, 1.0]])
    b = np.array([1.0, 2.0, 3.0])
    x = gj_solve_plain(torch.as_tensor(A)[None],
                       torch.as_tensor(b)[None, :, None])[0, :, 0].numpy()
    ref = np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_array_equal(x, ref)


@pytest.mark.parametrize("bad", ["nonsquare", "rhs_rows", "dtype_mix",
                                 "int", "noncontiguous"])
def test_wrapper_rejects_bad_arguments(bad):
    A = torch.eye(4, dtype=torch.float64)
    B = torch.ones(4, dtype=torch.float64)
    if bad == "nonsquare":
        A = torch.ones((4, 3), dtype=torch.float64)
    elif bad == "rhs_rows":
        B = torch.ones(5, dtype=torch.float64)
    elif bad == "dtype_mix":
        B = B.to(torch.float32)
    elif bad == "int":
        A, B = A.to(torch.int64), B.to(torch.int64)
    else:
        A = torch.eye(8, dtype=torch.float64)[::2, ::2]
    with pytest.raises((ValueError, TypeError)):
        gj_solve(A, B)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(3)
    for n, k, b, dtype, tol in ((19, 1, 1, torch.float64, 1e-12),
                                (19, 19, 8, torch.float64, 1e-12),
                                (19, 1, 4096, torch.float64, 1e-12),
                                (19, 1, 2, torch.float32, 1e-5)):
        A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        A[:, 5, 5] = 0.0
        At = torch.as_tensor(A, dtype=dtype, device="cuda")
        Bt = torch.as_tensor(rng.standard_normal((b, n, k)), dtype=dtype,
                             device="cuda")
        before = gj_solve.launches
        X = gj_solve(At, Bt)
        assert gj_solve.launches == before + 1
        # FMA contraction in the kernel: rounding-level differences
        torch.testing.assert_close(X, gj_solve_plain(At, Bt), rtol=tol,
                                   atol=tol)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rule_inputs(shape, seed, device="cpu"):
    b, n, k = shape
    rng = np.random.default_rng(seed)
    # well-conditioned, with rows 0 and 1 swapped to force a pivot (a zeroed
    # diagonal would leave some of 4096 systems nearly singular)
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    A[:, [0, 1]] = A[:, [1, 0]]
    arrs = (A, rng.standard_normal((b, n, k)),
            rng.standard_normal((b, n, n)), rng.standard_normal((b, n, k)),
            rng.standard_normal((b, n, k)))
    return arrs, [torch.as_tensor(a, device=device) for a in arrs]


#: the Newton solve, the sensitivity solve (k = parameters), 4096 lanes
RULE_SHAPES = [(1, 19, 1), (1, 19, 3), (4096, 19, 1)]


@pytest.mark.parametrize("shape", RULE_SHAPES[:2] + [(64, 19, 1)])
def test_derivative_rules_match_autodiff(shape):
    (A, B, dA, dB, gX), (At, Bt, dAt, dBt, gXt) = _rule_inputs(shape, 7)
    X, dX = jvp(GJSolve.apply, (At, Bt), (dAt, dBt))
    Xp, dXp = jvp(gj_solve_plain, (At, Bt), (dAt, dBt))
    assert _rel(X, Xp) <= 1e-12 and _rel(dX, dXp) <= 1e-12
    grads = vjp(GJSolve.apply, At, Bt)[1](gXt)
    grads_p = vjp(gj_solve_plain, At, Bt)[1](gXt)
    for g, gp in zip(grads, grads_p):
        assert _rel(g, gp) <= 1e-12
    _, dXj = jax.jvp(jnp.linalg.solve, (A, B), (dA, dB))
    assert _rel(dX, torch.as_tensor(np.array(dXj))) <= 1e-12
    _, pull = jax.vjp(jnp.linalg.solve, A, B)
    for g, gj in zip(grads, pull(gX)):
        assert _rel(g, torch.as_tensor(np.array(gj))) <= 1e-12


@pytest.mark.parametrize("shared", [True, False])
def test_jacfwd_folds_the_mapped_axis(shared):
    # jacfwd over three parameters vmaps the jvp rule: a shared A takes the
    # three tangent systems as extra right-hand-side columns, a mapped A
    # as more systems in the batch
    (A, B, dA, dB, _), (At, Bt, dAt, dBt, _) = _rule_inputs((2, 6, 2), 11)
    p0 = np.array([0.3, -0.2, 0.5])

    def f(p, solve, A, B, dA, dB):
        if shared:          # p moves only the right-hand side
            return solve(A, B * p[0] + dB * p[1] + dB * dB * p[2])
        return solve(A + dA * p[0] + dA * dA * p[1], B * (1.0 + p[2]))

    pt = torch.as_tensor(p0)
    J = jacfwd(lambda p: f(p, gj_solve, At, Bt, dAt, dBt))(pt)
    Jp = jacfwd(lambda p: f(p, gj_solve_plain, At, Bt, dAt, dBt))(pt)
    Jj = jax.jacfwd(lambda p: f(p, jnp.linalg.solve, A, B, dA, dB))(
        jnp.asarray(p0))
    assert J.shape == (2, 6, 2, 3)
    assert _rel(J, Jp) <= 1e-12
    assert _rel(J, torch.as_tensor(np.array(Jj))) <= 1e-12


@pytest.mark.parametrize("route", ["plain", "forward_ad", "autograd"])
def test_gj_solve_keeps_derivatives_on_every_route(route, monkeypatch):
    # gj_solve skips Function.apply only where no derivative can flow; the
    # tangent of a forward-AD level and the gradient of torch.autograd
    # must still come through the rules (on the card, the kernel's forward
    # alone would drop the tangent)
    (A, B, dA, dB, gX), (At, Bt, dAt, dBt, gXt) = _rule_inputs((3, 7, 2), 5)
    rule_calls = []
    jvp_rule = GJSolve.jvp
    monkeypatch.setattr(GJSolve, "jvp", staticmethod(
        lambda *a: rule_calls.append(1) or jvp_rule(*a)))
    _, dXp = jvp(gj_solve_plain, (At, Bt), (dAt, dBt))
    if route == "plain":
        with torch.no_grad():
            X = gj_solve(At, Bt)
        assert not X.requires_grad
        assert _rel(X, gj_solve_plain(At, Bt)) <= 1e-12
    elif route == "forward_ad":
        from torch.autograd import forward_ad as fwad
        with fwad.dual_level():
            X = gj_solve(fwad.make_dual(At, dAt), fwad.make_dual(Bt, dBt))
            dX = fwad.unpack_dual(X).tangent
        assert rule_calls and dX is not None and _rel(dX, dXp) <= 1e-12
    else:
        Ar, Br = At.clone().requires_grad_(), Bt.clone().requires_grad_()
        gA, gB = torch.autograd.grad(gj_solve(Ar, Br), (Ar, Br), gXt)
        for g, gp in zip((gA, gB), vjp(gj_solve_plain, At, Bt)[1](gXt)):
            assert _rel(g, gp) <= 1e-12


@pytest.mark.gpu
def test_cuda_derivative_rules_match_plain_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for shape in RULE_SHAPES:
        _, (At, Bt, dAt, dBt, gXt) = _rule_inputs(shape, 7, "cuda")
        before, rules = gj_solve.launches, gj_solve.rule_launches
        X, dX = jvp(GJSolve.apply, (At, Bt), (dAt, dBt))
        grads = vjp(GJSolve.apply, At, Bt)[1](gXt)
        # forward, its tangent, forward again and the cotangent solve; the
        # tangent and the cotangent each one launch of a fused entry
        assert gj_solve.launches == before + 4
        assert gj_solve.rule_launches == rules + 2
        Xp, dXp = jvp(gj_solve_plain, (At, Bt), (dAt, dBt))
        grads_p = vjp(gj_solve_plain, At, Bt)[1](gXt)
        assert _rel(dX, dXp) <= 1e-12
        for g, gp in zip(grads, grads_p):
            assert _rel(g, gp) <= 1e-12


#: the rule entries' shapes: the Newton and sensitivity solves and the
#: Monte Carlo's 4096 lanes (warp), a block-variant batch, and a grid-variant
#: system (its rules take torch products around the solve)
FUSED_SHAPES = [(1, 19, 1), (4096, 19, 1), (64, 128, 1), (1, 241, 1)]


@pytest.mark.parametrize("shape, want", [
    ((3, 19, 2), "warp"), ((2, 40, 1), "block"), ((1, 170, 1), "grid")])
def test_rule_twins_match_jax(shape, want):
    # the fused entries' functions in torch ops: dX = A^-1 (dB - dA X) (and
    # without dB), gB = A^-T gX with gA = -gB X^T, against jax.jvp and
    # jax.vjp of jnp.linalg.solve, at a shape of each variant
    (A, B, dA, dB, gX), (At, Bt, dAt, dBt, gXt) = _rule_inputs(shape, 13)
    assert variant(shape[1], shape[2], 8, shape[0]) == want
    X, dXj = jax.jvp(jnp.linalg.solve, (A, B), (dA, dB))
    Xt = torch.as_tensor(np.array(X))
    assert _rel(gj_tangent_plain(At, Xt, dAt, dBt),
                torch.as_tensor(np.array(dXj))) <= 1e-12
    _, dXa = jax.jvp(jnp.linalg.solve, (A, B), (dA, np.zeros_like(B)))
    assert _rel(gj_tangent_plain(At, Xt, dAt, None),
                torch.as_tensor(np.array(dXa))) <= 1e-12
    gAj, gBj = jax.vjp(jnp.linalg.solve, A, B)[1](gX)
    gA, gB = gj_adjoint_plain(At, Xt, gXt)
    assert _rel(gA, torch.as_tensor(np.array(gAj))) <= 1e-12
    assert _rel(gB, torch.as_tensor(np.array(gBj))) <= 1e-12
    assert gj_adjoint_plain(At, Xt, gXt, want_gA=False)[0] is None


def _count_route(monkeypatch):
    """Count `GJSolve.apply` calls and solves (calls of the twin)."""
    calls = {"apply": 0, "solve": 0}
    apply, twin = GJSolve.apply.__func__, K1.plain_twin

    def counted_apply(cls, A, B):
        calls["apply"] += 1
        return apply(cls, A, B)

    def counted_twin(A, B):
        calls["solve"] += 1
        return twin(A, B)

    monkeypatch.setattr(GJSolve, "apply", classmethod(counted_apply))
    monkeypatch.setattr(K1, "plain_twin", counted_twin)
    return calls


@pytest.mark.parametrize("transform", ["jvp", "vjp", "jacfwd", "jacrev"])
def test_rules_cross_once_per_solve(transform, monkeypatch):
    # each rule computes on the tensors it is given (one transform level
    # down): under jvp and vjp only the user's call crosses GJSolve.apply;
    # under jacfwd and jacrev the rule's solve crosses once more, into the
    # vmap rule (its tangents or cotangents are batched). Never more
    # crossings than solves, and the results equal autodiff of the twin
    _, (At, Bt, dAt, dBt, gXt) = _rule_inputs((2, 7, 1), 3)
    calls = _count_route(monkeypatch)
    if transform == "jvp":
        got = jvp(gj_solve, (At, Bt), (dAt, dBt))[1]
        want = jvp(gj_solve_plain, (At, Bt), (dAt, dBt))[1]
        route = {"apply": 1, "solve": 2}
    elif transform == "vjp":
        got = vjp(gj_solve, At, Bt)[1](gXt)[0]
        want = vjp(gj_solve_plain, At, Bt)[1](gXt)[0]
        route = {"apply": 1, "solve": 2}
    elif transform == "jacfwd":
        got = jacfwd(gj_solve, argnums=1)(At, Bt)
        want = jacfwd(gj_solve_plain, argnums=1)(At, Bt)
        route = {"apply": 2, "solve": 2}
    else:
        got = jacrev(gj_solve)(At, Bt)
        want = jacrev(gj_solve_plain)(At, Bt)
        route = {"apply": 2, "solve": 2}
    assert calls["solve"] - calls["apply"] >= 0
    assert {k: calls[k] for k in route} == route
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("nest", ["jacfwd_jacrev", "vmap_grad", "jvp_jvp",
                                  "double_backward"])
def test_nested_transforms_through_the_rules(nest):
    # a transform over a rule: the rule's own arithmetic must carry the
    # outer level's derivative (the rule goes back through GJSolve.apply);
    # held to autodiff of the twin and to JAX's jnp.linalg.solve
    (A, B, dA, _, _), (At, Bt, dAt, _, _) = _rule_inputs((2, 6, 1), 17)
    w = np.linspace(-1.0, 1.0, 12).reshape(2, 6, 1)
    wt = torch.as_tensor(w)

    def f(solve, a, wv):
        return (solve(a, B if isinstance(a, jnp.ndarray) else Bt) * wv).sum()

    if nest == "jacfwd_jacrev":
        got = jacfwd(jacrev(lambda a: f(gj_solve, a, wt)))(At)
        want = jacfwd(jacrev(lambda a: f(gj_solve_plain, a, wt)))(At)
        ref = jax.jacfwd(jax.jacrev(lambda a: f(jnp.linalg.solve, a, w)))(A)
    elif nest == "vmap_grad":
        Ws = torch.stack([wt, 2.0 * wt, -wt])
        got = vmap(grad(lambda a, wv: f(gj_solve, a, wv)),
                   in_dims=(None, 0))(At, Ws)
        want = vmap(grad(lambda a, wv: f(gj_solve_plain, a, wv)),
                    in_dims=(None, 0))(At, Ws)
        ref = jax.vmap(jax.grad(lambda a, wv: f(jnp.linalg.solve, a, wv)),
                       in_axes=(None, 0))(A, jnp.asarray(Ws.numpy()))
    elif nest == "jvp_jvp":
        def inner(solve, a):
            return jvp(lambda x: solve(x, Bt), (a,), (dAt,))[1]
        got = jvp(lambda a: inner(gj_solve, a), (At,), (dAt,))[1]
        want = jvp(lambda a: inner(gj_solve_plain, a), (At,), (dAt,))[1]
        ref = jax.jvp(lambda a: jax.jvp(lambda x: jnp.linalg.solve(x, B),
                                        (a,), (dA,))[1], (A,), (dA,))[1]
    else:
        Ar = At.clone().requires_grad_()
        g1, = torch.autograd.grad(f(gj_solve, Ar, wt), Ar, create_graph=True)
        got, = torch.autograd.grad((g1 * dAt).sum(), Ar)
        Ap = At.clone().requires_grad_()
        p1, = torch.autograd.grad(f(gj_solve_plain, Ap, wt), Ap,
                                  create_graph=True)
        want, = torch.autograd.grad((p1 * dAt).sum(), Ap)
        ref = jax.grad(lambda a: (jax.grad(lambda x: f(jnp.linalg.solve, x,
                                                       w))(a) * dA).sum())(A)
    assert _rel(got, want) <= 1e-12
    assert _rel(got, torch.as_tensor(np.array(ref))) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_cuda_fused_rules_match_twins(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, (At, Bt, dAt, dBt, gXt) = _rule_inputs(shape, 19, "cuda")
    X = gj_solve(At, Bt)
    forms = ([None, "block"] if variant(*shape[1:], 8, shape[0]) == "warp"
             else [None])
    for which in forms:
        for dB in (dBt, None):
            before = gj_solve.launches
            dX = launch_tangent(At, X, dAt, dB, which)
            assert gj_solve.launches == before + 1
            assert _rel(dX, gj_tangent_plain(At, X, dAt, dB)) <= 1e-12
        for want_gA in (True, False):
            before = gj_solve.launches
            gA, gB = launch_adjoint(At, X, gXt, want_gA, which)
            assert gj_solve.launches == before + 1
            pA, pB = gj_adjoint_plain(At, X, gXt)
            assert _rel(gB, pB) <= 1e-12
            assert (gA is None) != want_gA
            if want_gA:
                assert _rel(gA, pA) <= 1e-12


@pytest.mark.parametrize("n, k, batch, want", [
    (19, 1, 1, "warp"), (19, 19, 1, "warp"), (32, 1, 4096, "warp"),
    (33, 1, 1, "block"), (128, 1, 1, "block"), (19, 64, 1, "block"),
    (38, 1, 801, "block"), (128, 1, 64, "block"), (104, 40, 10, "block"),
    (167, 1, 801, "block"), (168, 1, 801, "grid"), (160, 20, 801, "grid"),
    # a small batch of wide systems: the grid variant's team is faster
    (104, 86, 10, "grid"), (160, 1, 1, "grid"), (144, 1, 64, "grid"),
    (144, 1, 65, "block"), (143, 1, 1, "block")])
def test_variant_choice(n, k, batch, want):
    # one row per lane (n <= 32), the augmented row in <= 64 registers;
    # then the system at an odd row stride and the blocked elimination's
    # work area in one block's shared memory (n = 167 the last at k = 1),
    # but for batches of at most 64 systems of n + k >= 145 columns
    assert variant(n, k, 8, batch) == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _variants_agree(At, Bt):
    """The warp variant against its twin `gj_solve_plain` (1e-10 in f64:
    the kernel's FMAs), and the block variant at the same shape against
    its twin `gj_solve_blocked_plain` (chip_smoke.py's GRID_BLOCK_TOL,
    1e-12); the same NaN pattern each. The two forms sum in other orders,
    so they are held to their twins, not to each other's bits."""
    def amax(t):
        return float(t.abs().max()) if t.numel() else 0.0

    f64 = At.dtype == torch.float64
    for which, twin, tol in (("warp", gj_solve_plain, 1e-10 if f64 else 1e-4),
                             ("block", gj_solve_blocked_plain,
                              1e-12 if f64 else 1e-4)):
        X, Xp = launch(At, Bt, which), twin(At, Bt)
        assert torch.equal(torch.isnan(X), torch.isnan(Xp)), which
        fin = torch.isfinite(Xp)
        scale = max(amax(Xp[fin]), 1.0)
        assert amax((X - Xp)[fin]) <= tol * scale, which


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4096])
@pytest.mark.parametrize("k", [1, 3, 19])
@pytest.mark.parametrize("n", [1, 2, 9, 19, 31, 32])
def test_warp_variant_matches_block_on_gpu(cuda, n, k, b):
    rng = np.random.default_rng(n * 100 + k)
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    At = torch.as_tensor(A, device=cuda)
    Bt = torch.as_tensor(rng.standard_normal((b, n, k)), device=cuda)
    assert variant(n, k) == "warp"
    before = gj_solve.launches
    X = gj_solve(At, Bt)
    assert gj_solve.launches == before + 1
    assert torch.equal(X, launch(At, Bt, "warp"))
    _variants_agree(At, Bt)
    _variants_agree(At.float(), Bt.float())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["forced_pivot", "tie", "nan_column"])
def test_warp_variant_pivots_like_block_on_gpu(cuda, case):
    rng = np.random.default_rng(8)
    n, b = 19, 64
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    if case == "forced_pivot":
        A[:, 5, 5] = 0.0
    elif case == "tie":
        # |A[i, 0]| ties between rows 4 and 9 (opposite signs) above every
        # other row of column 0: row 4 wins, as jax.lax.argmax
        A[:, 0, 0] = 0.5
        A[:, [4, 9], 0] = np.array([-4.0, 4.0])
    else:
        A[:, :, 4] = np.nan
    At = torch.as_tensor(A, device=cuda)
    Bt = torch.as_tensor(rng.standard_normal((b, n, 2)), device=cuda)
    _variants_agree(At, Bt)
