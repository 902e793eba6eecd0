"""Sweeps and Monte Carlo tables of the port
(cadnip_tpu_torch/analyses/sweeps.py) against the JAX package's
`cadnip_tpu/analyses/sweeps.py`: the same tables, the same batched DC and
transient solves lane for lane, the neighbour-seeded rescue of `dcsweep`,
`chunk=`, and the tables of bench.py's DFF Monte Carlo (its lanes run in
tests/test_torch_sweeps_dff.py)."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses import sweeps as jsw
from cadnip_tpu.models.dff import dff_netlist as jax_dff_netlist
from cadnip_tpu_torch.analyses import sweeps as tsw

torch.set_num_threads(1)
DFF_SPREADS = {"cq.c": 0.1, "mno1.w": 0.1, "mpo1.w": 0.1}   # bench.py:381
DIODE_CHAIN = """diode chain
.model dd d is=1e-15 n=1
vs in 0 dc 0
r1 in a 10
d1 a b dd
d2 b c dd
d3 c d dd
d4 d e dd
d5 e 0 dd
.end
"""


def _on_cpu(ct):
    """The keyword that puts a circuit of the port on the host; the JAX
    package takes none."""
    return {"device": "cpu"} if ct is tct else {}


def _divider(ct):
    cir = ct.Circuit("div")
    cir.V("v1", "in", "0", dc=5.0)
    cir.R("r1", "in", "out", 1e3)
    cir.R("r2", "out", "0", 1e3)
    return cir.compile(**_on_cpu(ct))


def _rc(ct):
    cir = ct.Circuit("rcs")
    cir.V("vs", "in", "0", wave=ct.Pulse(0.0, 1.0, tr=1e-9))
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-6)
    return cir.compile(**_on_cpu(ct))


def _sweeps(m):
    return {
        "1d": m.Sweep("r2.r", tuple(np.linspace(0.5e3, 4e3, 8))),
        "product": m.ProductSweep(m.Sweep("r1.r", (1e3, 2e3)),
                                  m.Sweep("r2.r", (1e3, 3e3, 5e3))),
        "tandem": m.TandemSweep(m.Sweep("r1.r", (1e3, 2e3)),
                                m.Sweep("r2.r", (1e3, 2e3))),
        "serial": m.SerialSweep(m.Sweep("r1.r", (2e3, 4e3)),
                                m.Sweep("r2.r", (3e3,)),
                                m.Sweep("v1.dc", (1.0, 2.0))),
    }


@pytest.mark.parametrize("kind", ["1d", "product", "tandem", "serial"])
def test_tables_and_dcsweep_match_jax(kind):
    jt, tt = _sweeps(jsw)[kind].table(), _sweeps(tsw)[kind].table()
    assert list(jt) == list(tt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])
    ref = jct.dcsweep(_divider(jct), _sweeps(jsw)[kind])
    sol = tct.dcsweep(_divider(tct), _sweeps(tsw)[kind])
    assert sol.converged.all() and np.asarray(ref.converged).all()
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=1e-12,
                               atol=1e-15)


def test_dcsweep_neighbour_rescue_matches_jax():
    # a 5-diode chain up to 100 V with a crippled fallback chain: the cold
    # batched solve fails on some lanes, the neighbour-seeded rerun
    # converges them (tests/test_sweeps.py::test_dcsweep_neighbor_rescue)
    import jax
    import jax.numpy as jnp
    from cadnip_tpu.mna.newton import make_dc_solver as jax_dc_solver
    vals = np.linspace(0.0, 100.0, 21)
    jcc = jct.parse_spice(DIODE_CHAIN, spec=jct.SimSpec(
        max_newton_iters=5, gmin_steps=2, src_steps=2))
    tcc = tct.parse_spice(DIODE_CHAIN, spec=tct.SimSpec(
        max_newton_iters=5, gmin_steps=2, src_steps=2), device="cpu")
    bp, axes = jsw.batch_params(jcc, {"vs.dc": vals})
    cold_ref = jax.vmap(jax_dc_solver(jcc), in_axes=(None, axes, None))(
        jnp.zeros(jcc.n), bp, jcc.spec.dyn())
    cold = tct.dc(tcc, tsw.batch_params(tcc, {"vs.dc": vals}), rescue=False)
    cold_conv = cold.converged.numpy()
    assert cold_conv.any() and not cold_conv.all()
    np.testing.assert_array_equal(cold_conv, np.asarray(cold_ref.converged))
    ref = jct.dcsweep(jcc, {"vs.dc": vals})
    sol = tct.dcsweep(tcc, {"vs.dc": vals})
    assert sol.converged.all() and np.asarray(ref.converged).all()
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-12)


def _tran_case(sol, ref):
    for field in ("naccept", "nreject", "nnewton", "fail"):
        np.testing.assert_array_equal(getattr(sol.stats, field).numpy(),
                                      np.asarray(getattr(ref.stats, field)))
    np.testing.assert_array_equal(sol.op_converged.numpy(),
                                  np.asarray(ref.op_converged))


def test_transweep_rc_matches_jax():
    rs = np.array([0.5e3, 1e3, 2e3])
    ref = jct.transweep(_rc(jct), {"r1.r": rs}, (0, 2e-3), dt=2e-5)
    sol = tct.transweep(_rc(tct), {"r1.r": rs}, (0, 2e-3), dt=2e-5)
    assert sol.xs.shape == (3, 101, 3) and sol.converged.all()
    _tran_case(sol, ref)
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(ref.xs),
                               rtol=1e-12, atol=1e-12)


def test_transweep_chunked_equals_unchunked():
    cc = _rc(tct)
    rs = np.linspace(0.5e3, 2e3, 7)   # odd count: the last chunk is padded
    full = tct.transweep(cc, {"r1.r": rs}, (0, 1e-3), dt=1e-5)
    chk = tct.transweep(cc, {"r1.r": rs}, (0, 1e-3), dt=1e-5, chunk=3)
    assert chk.xs.shape == full.xs.shape == (7, 101, 3)
    np.testing.assert_array_equal(chk.xs.numpy(), full.xs.numpy())
    for a, b in zip(chk.stats, full.stats):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert chk.op_converged.all() and chk.converged.all()


def test_transweep_uic_skips_the_warmup_like_jax():
    # the JAX package runs the uic warmup only on an unbatched transient
    # (`tran.py:579`): a uic transweep starts from zeros + .ic as they are
    # (the JAX call needs the batched zeros spelled out as x0)
    rs = np.array([0.5e3, 1e3, 2e3])
    kw = dict(dt=1e-5, uic=True, ic={"out": 0.3})
    jcc = _rc(jct)
    ref = jct.transweep(jcc, {"r1.r": rs}, (0, 1e-3),
                        x0=np.zeros((3, jcc.n)), **kw)
    sol = tct.transweep(_rc(tct), {"r1.r": rs}, (0, 1e-3), **kw)
    _tran_case(sol, ref)
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(ref.xs),
                               rtol=1e-12, atol=1e-12)
    # the branch current of vs starts at 0, not at the warmed-up -0.3/R
    assert (sol["vs#i"][:, 0] == 0.0).all()


def test_montecarlo_tables_are_jax_bit_for_bit():
    spreads = {"r1.r": 0.05, "r2.r": (2e3, 100.0), "v1.dc": 0.02}
    ref = jct.montecarlo_table(_divider(jct), {"r1.r": 0.05,
                                               "r2.r": (2e3, 100.0)}, 64,
                               seed=1)
    tab = tct.montecarlo_table(_divider(tct), spreads, 64, seed=1)
    for k in ref:
        np.testing.assert_array_equal(tab[k], ref[k])
    assert abs(tab["v1.dc"].mean() - 5.0) < 0.05
    jcc = jct.parse_spice(jax_dff_netlist())
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    ref = jct.montecarlo_table(jcc, DFF_SPREADS, 4096, seed=42)
    tab = tct.montecarlo_table(tcc, DFF_SPREADS, 4096, seed=42)
    for k in ref:
        np.testing.assert_array_equal(tab[k], ref[k])
