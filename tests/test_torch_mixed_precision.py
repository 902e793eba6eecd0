"""The mixed-precision solve methods of the port ("gjpl32ir": kernel K1 in
f32 on the equilibrated matrix with f64 refinement; "lu32ir") on the
paths the JAX package routes them to, against the JAX package with the
same method (its Pallas kernel in interpret mode, as its own tests run
it; under vmap its batched XLA elimination):

  * the DFF's transient over 0-60 ns at the benchmark's settings: counts
    exact, q within 1e-9 x 5 V (measured: 7.4e-15 V for gjpl32ir, 3.8e-15
    V for lu32ir);
  * the DFF's supply rejection and output noise over 801 frequencies
    through `make_ac_sweep` / `make_noise_sweep(method="gjpl32ir")`:
    1e-9 of max |H| and 1e-9 relative on the PSDs (measured: 1.1e-15 and
    9.6e-16);
  * a BBD grid's DC Newton chain, block and Schur solves, the nested
    level included: iterations equal, x within 1e-12 (measured 1.1e-16);
  * `method=` reaching every dense solve of tran, the uic warmup,
    transweep, the DC chain and the BBD solver;
  * on the card (`gpu`): the DFF under gjpl32ir against the CPU port, with
    at least one f32 K1 launch per Newton pass."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu.ops.pallas_solve as pallas_solve
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses.ac import make_ac_sweep as jax_ac_sweep
from cadnip_tpu.analyses.noise import make_noise_sweep as jax_noise_sweep
from cadnip_tpu.mna.bbd_assemble import \
    nested_border_partition as jax_nested
from cadnip_tpu.mna.newton import make_dc_solver as jax_dc_solver
from cadnip_tpu.mna.spec import MODE_AC
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu.ops.bbd import make_bbd_solver as jax_bbd_solver
from cadnip_tpu_torch.analyses.ac import make_ac_sweep
from cadnip_tpu_torch.analyses.noise import make_noise_sweep
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.mna.bbd_assemble import nested_border_partition
from cadnip_tpu_torch.mna.newton import make_dc_solver
from cadnip_tpu_torch.ops.bbd import make_bbd_solver
from test_torch_bbd import _assembled, _pair, _params

torch.set_num_threads(1)
SPAN, DT = (0, 6e-8), 3.333e-10
Q_TOL = 1e-9 * 5.0
AC_TOL = 1e-9


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's f32 Pallas kernel in interpret mode (its
    `factorize` imports it at call time)."""
    monkeypatch.setattr(pallas_solve, "gj_solve_f32", functools.partial(
        pallas_solve.gj_solve_f32, interpret=True))


@pytest.fixture(scope="module")
def dff():
    jcc = jct.parse_spice(jax_dff())
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    tp = params_from_numpy([jax.tree.map(np.array, d)
                            for d in jcc.params0()], device="cpu")
    return jcc, tcc, tp


def _counts(stats):
    return [int(v) for v in stats[:3]]


@pytest.mark.parametrize("method", ["gjpl32ir", "lu32ir"])
def test_dff_tran_matches_jax(dff, method, pallas_interpret):
    jcc, tcc, tp = dff
    js = jct.tran(jcc, SPAN, dt=DT, max_steps=100000, method=method)
    ts = tct.tran(tcc, SPAN, tp, dt=DT, max_steps=100000, method=method)
    assert bool(ts.converged) and bool(js.converged)
    assert _counts(ts.stats) == _counts(js.stats)
    q = ts["q"].numpy()
    assert np.isfinite(q).all()
    assert np.abs(q - np.asarray(js["q"])).max() <= Q_TOL


@pytest.fixture(scope="module")
def dff_small_signal(dff):
    """(JAX circuit, port circuit, JAX params, port params with acmag = 1
    on vvdd, the operating point, the 801 angular frequencies)."""
    jcc, tcc, tp = dff
    jp = jcc.alter(jcc.params0(), **{"vvdd.acmag": 1.0})
    tpa = tcc.alter(tp, **{"vvdd.acmag": 1.0})
    xop = np.array(jct.dc(jcc).x)
    om = 2 * np.pi * tct.acdec(100, 1e3, 1e11)
    assert len(om) == 801
    return jcc, tcc, jp, tpa, xop, om


def test_dff_ac_sweep_matches_jax(dff_small_signal):
    jcc, tcc, jp, tpa, xop, om = dff_small_signal
    jr, ji = jax.jit(jax_ac_sweep(jcc, "gjpl32ir"))(
        jnp.asarray(xop), jp, jcc.spec.dyn(mode=MODE_AC), jnp.asarray(om))
    tr, ti = make_ac_sweep(tcc, "gjpl32ir")(
        torch.as_tensor(xop), tpa, tcc.spec.dyn("cpu", mode=MODE_AC),
        torch.as_tensor(om))
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = tr.numpy() + 1j * ti.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= AC_TOL * np.abs(want).max()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_dff_noise_sweep_matches_jax(dff_small_signal):
    jcc, tcc, _, _, xop, om = dff_small_signal
    tp = params_from_numpy([jax.tree.map(np.array, d)
                            for d in jcc.params0()], device="cpu")
    e = np.zeros(jcc.n)
    e[jcc.index_of("q")] = 1.0
    b_in = np.zeros(jcc.n)
    gi, slot = jcc.inst_group["vvdd"]
    for local, sign in jcc.groups[gi].model.ac_rhs:
        b_in[jcc.groups[gi].conn[slot, local]] += sign
    sweep, _, _ = jax_noise_sweep(jcc, "gjpl32ir")
    jo, jin, jc = jax.jit(sweep, static_argnames=("want_inoise",))(
        jnp.asarray(xop), jcc.params0(), jcc.spec.dyn(mode=MODE_AC),
        jnp.asarray(om), jnp.asarray(e), jnp.asarray(b_in),
        jnp.zeros(jcc.n), want_inoise=True)
    tsweep, _ = make_noise_sweep(tcc, "gjpl32ir")
    to, tin, tc = tsweep(torch.as_tensor(xop), tp,
                         tcc.spec.dyn("cpu", mode=MODE_AC),
                         torch.as_tensor(om), torch.as_tensor(e),
                         torch.as_tensor(b_in))
    assert (to.numpy() > 0).all()
    assert _rel(to, jo) <= AC_TOL
    assert _rel(tin, jin) <= AC_TOL
    assert _rel(tc, jc) <= AC_TOL


def test_bbd_newton_matches_jax(pallas_interpret):
    """The DC chain's Newton on an 8 x 8 BBD grid (diodes, a MOSFET):
    block solves over B*K systems and the dense Schur solve."""
    jc, tc = _pair(8, 8, block_size=12, load_diodes=True, mosfet=True)
    pj, pt = _params(jc, tc)
    rj = jax.jit(jax_dc_solver(jc, method="gjpl32ir"))(
        jnp.zeros(jc.n), pj, jc.spec.dyn())
    rt = make_dc_solver(tc, method="gjpl32ir")(
        torch.zeros((1, tc.n), dtype=torch.float64), pt,
        tc.spec.dyn("cpu"))
    assert bool(rt.converged[0]) and bool(rj.converged)
    assert int(rt.iters[0]) == int(rj.iters)
    assert np.abs(rt.x[0].numpy() - np.asarray(rj.x)).max() <= 1e-12


def test_bbd_nested_level_matches_jax(pallas_interpret):
    """A 20 x 20 grid at block size 12 with a second BBD level over its
    border (block size 24): one solve at a random state against JAX and
    the single-level f64 solve, then the DC chain through it."""
    jc, tc = _pair(20, 20, block_size=12, load_diodes=True)
    (Fj, _, Gj, _, _), (Ft, _, Gt, _, _), _, _ = _assembled(jc, tc, 3)
    p2t, p2j = (nested_border_partition(tc, tc.bbd, 24),
                jax_nested(jc, jc.bbd, 24))
    nested = make_bbd_solver(tc.bbd, "cpu", "gjpl32ir", nested=p2t)(
        *Gt, -Ft)
    single = make_bbd_solver(tc.bbd, "cpu")(*Gt, -Ft)
    dxj = jax.jit(jax_bbd_solver(jc.bbd, "gjpl32ir", nested=p2j))(*Gj, -Fj)
    assert _rel(nested, single) <= 1e-12
    assert _rel(nested[0], dxj) <= 1e-12
    tc.bbd_nested, jc.bbd_nested = p2t, p2j
    pj, pt = _params(jc, tc)
    rt = make_dc_solver(tc, method="gjpl32ir")(
        torch.zeros((1, tc.n), dtype=torch.float64), pt,
        tc.spec.dyn("cpu"))
    rj = jax.jit(jax_dc_solver(jc, method="gjpl32ir"))(
        jnp.zeros(jc.n), pj, jc.spec.dyn())
    assert bool(rt.converged[0]) and int(rt.iters[0]) == int(rj.iters)
    assert np.abs(rt.x[0].numpy() - np.asarray(rj.x)).max() <= 1e-12


def test_method_reaches_every_dense_solve(monkeypatch):
    """tran (its uic warmup too), transweep and the DC chain on a dense
    RC, and tran on a BBD grid (its block and Schur solves), call the
    dense solve with the method they were given. The transients start
    from x0: their operating points take the default chain, as in the
    JAX package."""
    import cadnip_tpu_torch.mna.newton as newton
    import cadnip_tpu_torch.ops.bbd as bbd
    seen = {"dense": [], "bbd": []}

    def spy(real, where):
        def solve(A, b, method=None, refine=2):
            seen[where].append(method)
            return real(A, b, method, refine)
        return solve

    monkeypatch.setattr(newton, "dense_solve",
                        spy(newton.dense_solve, "dense"))
    monkeypatch.setattr(bbd, "dense_solve", spy(bbd.dense_solve, "bbd"))
    cir = tct.Circuit("rc")
    cir.V("v1", "in", "0", wave=tct.Pulse(0.0, 1.0, 1e-7, 1e-9, 1e-9))
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-10)
    cc = cir.compile(device="cpu")
    x0 = torch.zeros(cc.n, dtype=torch.float64)
    tct.tran(cc, (0, 5e-7), dt=1e-8, method="lu32ir", uic=True)
    tct.transweep(cc, {"r1.r": [1e3, 2e3]}, (0, 5e-7), dt=1e-8, x0=x0,
                  method="lu32ir")
    make_dc_solver(cc, method="lu32ir")(
        torch.zeros((1, cc.n), dtype=torch.float64), cc.params0(),
        cc.spec.dyn("cpu"))
    _, tb = _pair(6, 6, block_size=10, cload=1e-9)
    tct.tran(tb, (0, 2e-7), dt=1e-8, method="lu32ir",
             x0=torch.zeros(tb.n, dtype=torch.float64))
    assert len(seen["dense"]) > 0 and set(seen["dense"]) == {"lu32ir"}
    # two solves per BBD Newton iteration: the blocks, then the Schur
    assert len(seen["bbd"]) >= 2 and len(seen["bbd"]) % 2 == 0
    assert set(seen["bbd"]) == {"lu32ir"}


@pytest.mark.gpu
def test_dff_tran_on_cuda_matches_cpu_in_f32_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    cpu = tct.tran(tct.parse_spice(tct.dff_netlist(), device="cpu"), SPAN,
                   dt=DT, max_steps=100000, method="gjpl32ir")
    gj_solve.f32_launches = 0
    card = tct.tran(tct.parse_spice(tct.dff_netlist(), device="cuda"), SPAN,
                    dt=DT, max_steps=100000, method="gjpl32ir")
    assert _counts(card.stats) == _counts(cpu.stats)
    assert gj_solve.f32_launches >= int(card.stats.nnewton)
    assert (card["q"].cpu() - cpu["q"]).abs().max().item() <= Q_TOL
