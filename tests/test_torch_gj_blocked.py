"""K1's blocked form: its plain twin `gj_solve_blocked_plain`
(cadnip_tpu_torch/ops/gj_solve.py), the blocked Gauss-Jordan that the
CUDA block and grid variants run, against the JAX package's
`linalg.solve` ("gauss" and "lu64"), its `gauss_solve` and its Pallas
kernel in f32 (interpret mode), at the grid variant's shapes and at the
block variant's; its pivots against the unblocked twin `gj_solve_plain`;
and `gj_solve` on a CPU tensor at a block or grid shape, which takes it,
with `GJSolve`'s derivative rules. The CUDA kernels run only on the card:
the `gpu` tests here (the block variant) and in tests/test_torch_bbd.py
(the grid variant)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp

from cadnip_tpu.ops.linalg import gauss_solve
from cadnip_tpu.ops.linalg import solve as jax_solve
from cadnip_tpu.ops.pallas_solve import gj_solve_f32
from cadnip_tpu_torch.ops import gj_solve as K1
from cadnip_tpu_torch.ops.gj_solve import (PANEL, GJSolve, block_plan,
                                           gj_solve, gj_solve_blocked_plain,
                                           gj_solve_plain, launch, variant)

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


#: the block variant's shapes (n, k, b): the DFF's AC and noise sweeps
#: (2n = 38), the nested BBD level's block solves ([10, 104, 190]), K2's
#: largest circuit (127), the first block shape (33), a full panel count
#: (64) and the top of the range at b = 1 (160)
BLOCK_SHAPES = [(33, 1, 2), (38, 1, 3), (64, 3, 2), (104, 86, 1),
                (127, 1, 1), (160, 1, 1)]
#: the blocked twin against JAX's f64 Gauss-Jordan and LU at the block
#: variant's shapes, relative
BLOCK_JAX_TOL = 1e-12


@pytest.mark.parametrize("n, k, b", BLOCK_SHAPES)
def test_blocked_twin_at_block_shapes_matches_jax_gauss_solve(n, k, b):
    # one block holds the system (the plan may still give a small batch of
    # wide systems to the grid variant: the same panels)
    assert variant(n, k, 8, 801) == "block"
    rng = np.random.default_rng(1000 + n)
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    A[:, [0, 1]] = A[:, [1, 0]]       # a zero-ish leading pivot: a swap
    B = rng.standard_normal((b, n, k))
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    X, piv = gj_solve_blocked_plain(At, Bt, return_pivots=True)
    _, piv_plain = gj_solve_plain(At, Bt, return_pivots=True)
    np.testing.assert_array_equal(piv.numpy(), piv_plain.numpy())
    X = X.numpy()
    with jax.disable_jit():
        ref = np.stack([np.asarray(gauss_solve(jnp.asarray(a), jnp.asarray(r)))
                        for a, r in zip(A, B)])
    assert _rel(X, ref) <= BLOCK_JAX_TOL
    lu = np.stack([np.asarray(jax_solve(jnp.asarray(a), jnp.asarray(r),
                                        method="lu64")) for a, r in zip(A, B)])
    assert _rel(X, lu) <= BLOCK_JAX_TOL
    # and gj_solve on a CPU tensor is the blocked twin here
    assert torch.equal(gj_solve(At, Bt), torch.as_tensor(X))


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


@pytest.mark.parametrize("n, grid", [(180, True), (120, True), (30, False)])
def test_gj_solve_on_cpu_takes_the_blocked_twin_at_grid_shapes(
        n, grid, monkeypatch):
    # every shape but the warp variant's (n <= 32) takes the blocked twin:
    # the block variant runs the same panels as the grid variant
    calls = []
    twin = K1.gj_solve_blocked_plain

    def counted(A, B, **kw):
        calls.append(A.shape)
        return twin(A, B, **kw)

    monkeypatch.setattr(K1, "gj_solve_blocked_plain", counted)
    A, B = _systems(173)
    At = torch.as_tensor(A[:1, :n, :n]).contiguous()
    Bt = torch.as_tensor(B[:1, :n, :1]).contiguous()
    assert (variant(n, 1) != "warp") == grid
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


# ---- the block variant on the card (gpu) -----------------------------------

#: the block variant against the blocked twin on the card, relative: the
#: kernel contracts its products into FMAs and sums the trailing product
#: on the tensor cores, the twin rounds each product (chip_smoke.py's
#: GRID_BLOCK_TOL); f32: the f32 twin's bar of chip_smoke.py
BLOCK_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _block_agrees(At, Bt):
    """The block variant against the blocked twin on the same card: the
    same NaN pattern, BLOCK_TOL of the solution's size elsewhere, and two
    launches give the same bits."""
    def amax(t):
        return float(t.abs().max()) if t.numel() else 0.0

    X = launch(At, Bt, "block")
    Xp = gj_solve_blocked_plain(At, Bt)
    assert torch.equal(torch.isnan(X), torch.isnan(Xp))
    fin = torch.isfinite(Xp)
    scale = max(amax(Xp[fin]), 1.0)
    assert amax((X - Xp)[fin]) <= BLOCK_TOL[At.dtype] * scale
    assert torch.equal(_bits(X), _bits(launch(At, Bt, "block")))
    return X


def _cuda_system(n, k, b, seed, device, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    A[:, [0, 1]] = A[:, [1, 0]]
    return (torch.as_tensor(A, dtype=dtype, device=device),
            torch.as_tensor(rng.standard_normal((b, n, k)), dtype=dtype,
                            device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, k, b", BLOCK_SHAPES + [(38, 1, 801),
                                                    (128, 1, 64),
                                                    (167, 1, 1)])
def test_block_variant_matches_blocked_twin_on_gpu(cuda, n, k, b, dtype):
    At, Bt = _cuda_system(n, k, b, n, cuda, dtype)
    assert variant(n, k, At.element_size(), 801) == "block"
    before = gj_solve.launches
    X = gj_solve(At, Bt)
    assert gj_solve.launches == before + 1
    Xb = _block_agrees(At, Bt)
    if variant(n, k, At.element_size(), b) == "block":
        assert torch.equal(_bits(X), _bits(Xb))
    else:
        # a small batch of wide systems: the grid variant, the same panels
        scale = max(float(Xb.abs().max()), 1.0)
        assert float((X - Xb).abs().max()) <= BLOCK_TOL[At.dtype] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zero_leading_diagonal", "tie",
                                  "nan_column", "singular"])
def test_block_variant_pivot_cases_on_gpu(cuda, case):
    rng = np.random.default_rng(9)
    n, b = 64, 8
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    if case == "zero_leading_diagonal":
        A[:, 0, 0] = A[:, 5, 5] = A[:, 17, 17] = 0.0
    elif case == "tie":
        # 2 x 2 blocks [[1, 1], [1, -1]], rows scattered: every column's
        # candidates tie exactly; the first logical row wins
        blocks = np.kron(np.eye(n // 2), np.array([[1.0, 1.0],
                                                   [1.0, -1.0]]))
        A[:] = blocks[rng.permutation(n)]
    elif case == "nan_column":
        A[:, :, 4] = np.nan
    else:
        A[:, :, 7] = 0.0
    B = rng.standard_normal((b, n, 2))
    for dtype in (torch.float64, torch.float32):
        At = torch.as_tensor(A, dtype=dtype, device=cuda)
        Bt = torch.as_tensor(B, dtype=dtype, device=cuda)
        X = _block_agrees(At, Bt)
        if case == "singular":
            assert not bool(torch.isfinite(X).all())
        elif case != "nan_column":
            assert bool(torch.isfinite(X).all())
    if case == "tie":
        _, p1 = gj_solve_blocked_plain(torch.as_tensor(A[:1]),
                                       torch.as_tensor(B[:1]),
                                       return_pivots=True)
        assert int(p1[0, 0]) == int(np.flatnonzero(A[0, :, 0]).min())


@pytest.mark.gpu
def test_block_plan_fits_the_variant_line_on_gpu(cuda):
    # the plan and variant() agree on the footprint: n = 167 is the last
    # f64 block system at k = 1
    th, zw, smem, per_sm = block_plan(1, 167, 1)
    assert smem <= K1.MAX_SMEM and zw >= 16 and per_sm >= 1
    with pytest.raises(RuntimeError):
        block_plan(1, 168, 1)
    assert variant(167, 1, 8, 801) == "block"
    assert variant(168, 1, 8, 801) == "grid"
    # the DFF's AC sweep [801, 38, 39] in one wave of the card's SMs
    th, zw, smem, per_sm = block_plan(801, 38, 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert per_sm * sms >= 801


@pytest.mark.gpu
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_block_thread_count_changes_no_bit_on_gpu(cuda, threads):
    # each element's arithmetic is the same whichever warp does it (the
    # product's tiles differ in shape, not in each element's sum), and the
    # pivot order is fixed by the keys: every block size, the same bits
    At, Bt = _cuda_system(104, 86, 3, 104, cuda)
    X = torch.empty_like(Bt)
    err = K1.load_library().gj_solve_f64(
        At.data_ptr(), *At.stride(), Bt.data_ptr(), *Bt.stride(),
        X.data_ptr(), 3, 104, 86, threads,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(X, launch(At, Bt, "block"))
