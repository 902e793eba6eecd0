"""The block-bordered-diagonal backend of the port
(cadnip_tpu_torch/ops/bbd.py, mna/bbd_assemble.py, its wiring through
Circuit.compile, Newton, dc, tran and dcsweep) and K1's grid variant,
against the JAX package on the circuits of tests/test_bbd.py: the same
grids built through both packages with the same parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.mna.assemble import pad_state as jax_pad
from cadnip_tpu.mna.bbd_assemble import make_bbd_assembler as jax_assembler
from cadnip_tpu.mna.bbd_assemble import \
    nested_border_partition as jax_nested
from cadnip_tpu.ops.bbd import make_bbd_solver as jax_solver
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.mna.assemble import make_assembler, pad_state
from cadnip_tpu_torch.mna.bbd_assemble import (make_bbd_assembler,
                                                nested_border_partition)
from cadnip_tpu_torch.ops.bbd import bbd_matvec, make_bbd_solver
from cadnip_tpu_torch.ops.gj_solve import (MAX_SMEM, block_bytes, gj_solve,
                                           gj_solve_blocked_plain,
                                           gj_solve_plain, grid_plan, launch,
                                           variant)

torch.set_num_threads(1)


def _grid(ct, nx, ny, load_diodes=False, mosfet=False, cload=None):
    """tests/test_bbd.py::_grid in either package: a 1 kOhm grid driven
    at one corner, grounded at the other; diodes on every third node;
    a MOSFET from n3_3 to ground gated by n2_5; a capacitor on the far
    corner."""
    cir = ct.Circuit(f"grid{nx}x{ny}")
    cir.V("vs", "n0_0", "0", dc=1.0)

    def nm(i, j):
        return f"n{i}_{j}"

    for i in range(nx):
        for j in range(ny):
            if i + 1 < nx:
                cir.R(f"rx{i}_{j}", nm(i, j), nm(i + 1, j), 1e3)
            if j + 1 < ny:
                cir.R(f"ry{i}_{j}", nm(i, j), nm(i, j + 1), 1e3)
    cir.R("rl", nm(nx - 1, ny - 1), "0", 1e3)
    if load_diodes:
        for i in range(0, nx, 3):
            for j in range(0, ny, 3):
                cir.D(f"d{i}_{j}", nm(i, j), "0", **{"is": 1e-14})
    if mosfet:
        cir.M("m1", "n3_3", "n2_5", "0", "0", kp=110e-6, w=10e-6, l=1e-6,
              vth=0.3)
    if cload is not None:
        cir.C("cl", nm(nx - 1, ny - 1), "0", cload)
    return cir


def _pair(nx, ny, solver="bbd", block_size=None, **kw):
    """(JAX circuit, port circuit on the CPU) of one grid."""
    return (_grid(jct, nx, ny, **kw).compile(solver=solver,
                                               block_size=block_size),
            _grid(tct, nx, ny, **kw).compile(solver=solver,
                                               block_size=block_size,
                                               device="cpu"))


def _same_partition(pj, pt):
    for f in ("n", "K", "bs", "nb", "nbl"):
        assert getattr(pj, f) == getattr(pt, f), f
    for f in ("kind", "block_of", "local_of", "bmap"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                      getattr(pt, f), err_msg=f)


def _params(jc, tc):
    """JAX's default parameters and the same numbers in the port."""
    pj = jc.params0()
    return pj, params_from_numpy([jax.tree.map(np.array, d) for d in pj],
                                 device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale > 0 else 1.0)


@pytest.mark.parametrize("nx, bs, diodes", [(12, 24, False), (8, 12, True)])
def test_partition_equals_jax(nx, bs, diodes):
    jc, tc = _pair(nx, nx, block_size=bs, load_diodes=diodes)
    _same_partition(jc.bbd, tc.bbd)
    assert int(np.sum(tc.bbd.block_of >= 0)) + tc.bbd.nb == tc.n


NESTED_GRID = (20, 12)   # a 20 x 20 grid at block size 12: border 134


def test_nested_partition_equals_jax():
    jc, tc = _pair(NESTED_GRID[0], NESTED_GRID[0],
                   block_size=NESTED_GRID[1])
    _same_partition(jc.bbd, tc.bbd)
    for bs2 in (24, 48):
        p2j, p2t = jax_nested(jc, jc.bbd, bs2), \
            nested_border_partition(tc, tc.bbd, bs2)
        assert p2t is not None and p2t.nb < tc.bbd.nb
        _same_partition(p2j, p2t)


def _assembled(jc, tc, seed, gshunt=1e-3):
    """Both packages' BBD assembly at one random state."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 0.9, tc.n)
    pj, pt = _params(jc, tc)
    ja = jax_assembler(jc, jc.bbd)
    xj = jax_pad(jnp.asarray(x))
    outj = jax.jit(ja)(xj, ja.init_lim(xj), pj, jc.spec.dyn(gshunt=gshunt))
    ta = make_bbd_assembler(tc, tc.bbd)
    xt = pad_state(torch.as_tensor(x)[None])
    outt = ta(xt, ta.init_lim(xt), pt, tc.spec.dyn("cpu", gshunt=gshunt))
    return outj, outt, x, pt


@pytest.mark.parametrize("case", ["diodes", "mosfet"])
def test_assembler_equals_jax(case):
    kw = dict(load_diodes=True) if case == "diodes" else dict(mosfet=True)
    jc, tc = _pair(8, 8, block_size=12, cload=1e-12, **kw)
    _same_partition(jc.bbd, tc.bbd)
    (Fj, Qj, Gj, Cj, _), (Ft, Qt, Gt, Ct, _), _, _ = _assembled(jc, tc, 1)
    assert _rel(Ft[0], Fj) <= 1e-13 and _rel(Qt[0], Qj) <= 1e-13
    for a, b in zip(Gt + Ct, Gj + Cj):
        assert a.shape[1:] == b.shape
        assert _rel(a[0], b) <= 1e-13


def test_solver_equals_jax_and_dense():
    jc, tc = _pair(8, 8, block_size=12, load_diodes=True, mosfet=True)
    (Fj, _, Gj, _, _), (Ft, _, Gt, _, _), x, pt = _assembled(jc, tc, 2)
    dx = make_bbd_solver(tc.bbd, "cpu")(*Gt, -Ft)
    dxj = jax.jit(jax_solver(jc.bbd, None))(*Gj, -Fj)
    assert _rel(dx[0], dxj) <= 1e-12
    # the dense system of the same circuit at the same point
    dense = _grid(tct, 8, 8, load_diodes=True,
                  mosfet=True).compile(solver="dense", device="cpu")
    da = make_assembler(dense)
    xp = pad_state(torch.as_tensor(x)[None])
    F, _, G, _, _ = da(xp, da.init_lim(xp), pt,
                       dense.spec.dyn("cpu", gshunt=1e-3))
    ref = np.linalg.solve(G[0].numpy(), -F[0].numpy())
    assert _rel(dx[0], ref) <= 1e-12
    # and the BBD product inverts the solve
    r = bbd_matvec(tc.bbd, Gt, dx) + Ft
    assert float(r.abs().max()) <= 1e-12 * float(Ft.abs().max())


def test_nested_solver_equals_single_level_and_jax():
    n, bs = NESTED_GRID
    jc, tc = _pair(n, n, block_size=bs, load_diodes=True)
    (Fj, _, Gj, _, _), (Ft, _, Gt, _, _), _, _ = _assembled(jc, tc, 3)
    p2t = nested_border_partition(tc, tc.bbd, 24)
    single = make_bbd_solver(tc.bbd, "cpu")(*Gt, -Ft)
    nested = make_bbd_solver(tc.bbd, "cpu", nested=p2t)(*Gt, -Ft)
    assert _rel(nested, single) <= 1e-12
    dxj = jax.jit(jax_solver(jc.bbd, None,
                             nested=jax_nested(jc, jc.bbd, 24)))(*Gj, -Fj)
    assert _rel(nested[0], dxj) <= 1e-12


def test_dc_through_the_nested_level_equals_single_level():
    n, bs = NESTED_GRID
    _, tc = _pair(n, n, block_size=bs, load_diodes=True)
    single = tct.dc(tc)
    tc.cache.clear()
    tc.bbd_nested = nested_border_partition(tc, tc.bbd, 24)
    nested = tct.dc(tc)
    assert bool(nested.converged) and int(nested.iters) == int(single.iters)
    assert np.abs(nested.x.numpy() - single.x.numpy()).max() < 1e-12


def test_dc_linear_matches_jax_dense_and_bbd():
    jd = _grid(jct, 10, 10).compile(solver="dense")
    jb, tb = _pair(10, 10, block_size=16)
    x = tct.dc(tb).x.numpy()
    assert bool(tct.dc(tb).converged)
    assert np.abs(x - np.asarray(jct.dc(jd).x)).max() < 1e-9
    assert np.abs(x - np.asarray(jct.dc(jb).x)).max() < 1e-12


def test_dc_diodes_match_jax_dense_and_bbd():
    jd = _grid(jct, 8, 8, load_diodes=True).compile(solver="dense")
    jb, tb = _pair(8, 8, block_size=12, load_diodes=True)
    st, sj = tct.dc(tb), jct.dc(jb)
    assert bool(st.converged) and bool(sj.converged)
    assert np.abs(st.x.numpy() - np.asarray(jct.dc(jd).x)).max() < 1e-8
    assert int(st.iters) == int(sj.iters)
    assert np.abs(st.x.numpy() - np.asarray(sj.x)).max() < 1e-12


def test_tran_matches_jax_bbd_and_dense():
    kw = dict(block_size=10, cload=1e-9)
    jd = _grid(jct, 6, 6, cload=1e-9).compile(solver="dense", block_size=10)
    jb, tb = _pair(6, 6, **kw)
    st = tct.tran(tb, (0, 1e-6), dt=1e-8)
    sj = jct.tran(jb, (0, 1e-6), dt=1e-8)
    assert bool(st.converged)
    counts = [int(v) for v in st.stats[:3]]
    assert counts == [int(v) for v in sj.stats[:3]]
    xs = st.xs.numpy()
    assert np.abs(xs - np.asarray(sj.xs)).max() < 1e-9
    sd = jct.tran(jd, (0, 1e-6), dt=1e-8)
    assert np.abs(xs - np.asarray(sd.xs)).max() < 1e-3


def test_dcsweep_lanes_equal_single_runs_and_jax():
    jb, tb = _pair(8, 8, block_size=12, load_diodes=True)
    vals = [0.8, 1.6]
    sw = tct.dcsweep(tb, tct.Sweep("vs.dc", vals))
    swj = jct.dcsweep(jb, jct.Sweep("vs.dc", vals))
    assert bool(sw.converged.all())
    assert sw.x.shape == (2, tb.n)
    for lane, v in enumerate(vals):
        one = tct.dc(tb, tb.alter(tb.params0(), **{"vs.dc": v}))
        assert int(one.iters) == int(sw.iters[lane])
        assert np.abs(sw.x[lane].numpy() - one.x.numpy()).max() < 1e-12
    np.testing.assert_array_equal(sw.iters.numpy(), np.asarray(swj.iters))
    assert np.abs(sw.x.numpy() - np.asarray(swj.x)).max() < 1e-12


def test_auto_threshold():
    small = tct.Circuit("small")
    small.V("v", "a", "0", dc=1.0)
    small.R("r", "a", "0", 1.0)
    assert small.compile(device="cpu").bbd is None
    # 40 x 40 nodes and the source's branch: n = 1601 > 1536
    cc = _grid(tct, 40, 40).compile(device="cpu")
    assert cc.n == 1601 and cc.bbd is not None
    assert cc.bbd_nested is None or cc.bbd.nb >= 1024
    _same_partition(_grid(jct, 40, 40).compile().bbd, cc.bbd)
    with pytest.raises(ValueError, match="solver"):
        small.compile(solver="klu", device="cpu")


def test_lm_rescue_refuses_bbd():
    from cadnip_tpu_torch.mna.newton import make_lm_rescue
    _, tb = _pair(6, 6, block_size=10)
    with pytest.raises(ValueError, match="dense"):
        make_lm_rescue(tb)


@pytest.mark.parametrize("itemsize", [8, 4])
def test_variant_grid_exactly_beyond_shared_memory(itemsize):
    # the block variant's least footprint: the system at an odd row stride
    # and the blocked elimination's work area (csrc/gj_solve.cu block_smem
    # with 16 columns of Z)
    # (a batch that covers the card: no small-batch rule)
    for n in range(33, 400):
        for k in (1, 2, n):
            fits = block_bytes(n, k, itemsize) <= MAX_SMEM
            assert variant(n, k, itemsize, 801) == ("block" if fits
                                                    else "grid")
    # f64, one right-hand side: n = 167 is the last block system
    assert variant(167, 1, 8, 801) == "block"
    assert variant(168, 1, 8, 801) == "grid"
    assert block_bytes(167, 1) == 231656 <= MAX_SMEM == 232448


@pytest.mark.parametrize("n", [200, 300])
def test_plain_twin_at_grid_sizes_matches_numpy(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((2, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    B = rng.standard_normal((2, n, 1))
    X = gj_solve_plain(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert _rel(X, np.linalg.solve(A, B)) <= 1e-11


def test_linalg_solve_at_300_matches_jax_lu64():
    from cadnip_tpu.ops.linalg import solve as jax_solve
    from cadnip_tpu_torch.ops.linalg import solve
    rng = np.random.default_rng(7)
    n = 300
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    b = rng.standard_normal(n)
    x = solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    xj = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(b),
                              method="lu64"))
    assert _rel(x, xj) <= 1e-11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _system(n, k, b, seed, device):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    return (torch.as_tensor(A, device=device),
            torch.as_tensor(rng.standard_normal((b, n, k)), device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_grid_variant_gives_the_block_bits_on_gpu(cuda, b):
    # the grid variant's blocked product sums in another order than the
    # block variant's elimination: the two agree to rounding (1e-12 of the
    # solution in f64, 1e-4 in f32), and two grid calls give the same bits
    At, Bt = _system(160, 1, b, 160, cuda)
    assert variant(160, 1, 8, 801) == "block"
    Xg = launch(At, Bt, "grid")
    assert _rel(Xg.cpu(), launch(At, Bt, "block").cpu()) <= 1e-12
    assert torch.equal(Xg, launch(At, Bt, "grid"))
    Af, Bf = At.float(), Bt.float()
    Xf = launch(Af, Bf, "grid")
    assert _rel(Xf.cpu(), launch(Af, Bf, "block").cpu()) <= 1e-4
    assert torch.equal(Xf, launch(Af, Bf, "grid"))


@pytest.mark.gpu
@pytest.mark.parametrize("n, b", [(512, 1), (1024, 1), (254, 5),
                                  (180, 2500), (973, 1), (241, 1),
                                  (254, 801), (333, 3)])
def test_grid_variant_matches_plain_on_gpu(cuda, n, b):
    # b = 5, 3: a team of blocks per system; b = 2500, 801: more systems
    # than the card holds blocks, one block per system in rounds; n = 333:
    # a ragged last panel
    At, Bt = _system(n, 1, b, n, cuda)
    assert variant(n, 1) == "grid"
    before = gj_solve.launches
    X = gj_solve(At, Bt)
    assert gj_solve.launches == before + 1
    assert _rel(X.cpu(), gj_solve_blocked_plain(At, Bt).cpu()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("entry, n, b", [("grid-l2", 241, 1),
                                         ("grid-l2", 300, 40)])
def test_grid_entries_match_plain_on_gpu(cuda, entry, n, b):
    # the panel in L2, the plan's entry beyond the owner's shared memory
    # (n > 1627 in f64), forced at shapes the plan keeps on chip
    At, Bt = _system(n, 1, b, n, cuda)
    assert grid_plan(At, Bt, entry)[0] == entry
    X = launch(At, Bt, "grid", entry)
    Xp = gj_solve_blocked_plain(At, Bt)
    assert _rel(X.cpu(), Xp.cpu()) <= 1e-12
    assert torch.equal(X, launch(At, Bt, "grid", entry))


@pytest.mark.gpu
def test_bbd_dc_on_gpu_matches_cpu(cuda):
    n, bs = NESTED_GRID
    got = {}
    for dev in ("cuda", "cpu"):
        cc = _grid(tct, n, n, load_diodes=True).compile(
            solver="bbd", block_size=bs, device=dev)
        gj_solve.launches = 0
        sol = tct.dc(cc)
        got[dev] = (sol.x.cpu().numpy(), int(sol.iters),
                    bool(sol.converged), gj_solve.launches)
    (xg, ig, cg, lg), (xc, ic, cc_, _) = got["cuda"], got["cpu"]
    assert cg and cc_ and ig == ic
    # two K1 launches per Newton iteration: the block solves and the Schur
    assert lg == 2 * ig
    assert np.abs(xg - xc).max() <= 1e-12
