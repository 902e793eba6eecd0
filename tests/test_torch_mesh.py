"""The sweep mesh of the port (cadnip_tpu_torch/parallel/mesh.py): the
padding against the JAX package's `_pad_batch`; `sharded_dcsweep` over
three host shards against the port's plain DC chain on the whole table
(bit for bit, lane by lane) and the JAX package's `sharded_dcsweep` over
three of the eight virtual CPU devices (within 1e-12); `sharded_transweep`
of a 10-lane DFF Monte Carlo over four host shards (two padding lanes)
against the port's `transweep` (bit for bit over 0-20 ns, before the
latch edge, from which on the CPU lanes part in the last bits at equal
counts: 1.1e-11 V over 0-100 ns) and the JAX package's
`sharded_transweep` (counts equal, q within 1e-9 x 5 V); a default mesh
without a card raises; on the card (`gpu`), two shards on one card
against the unsharded sweep."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu.parallel import mesh as jax_mesh
from cadnip_tpu_torch.analyses.dc import _get_dc_solver
from cadnip_tpu_torch.analyses.sweeps import batch_params
from cadnip_tpu_torch.parallel.mesh import (_pad_batch, sharded_dcsweep,
                                            sharded_transweep, sweep_mesh)

torch.set_num_threads(1)
SPREAD = {"cq.c": 0.1, "mno1.w": 0.1, "mpo1.w": 0.1}


@pytest.mark.parametrize("b, n_dev", [(10, 4), (7, 3), (8, 4), (1, 3)])
def test_pad_batch_matches_jax(b, n_dev):
    rng = np.random.default_rng(b)
    table = {"a.x": rng.standard_normal(b), "b.y": rng.standard_normal(b)}
    got, n = _pad_batch(table, n_dev)
    want, nj = jax_mesh._pad_batch(table, n_dev)
    assert n == nj == b
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert len(got[k]) % n_dev == 0
        assert (got[k][b:] == table[k][-1]).all()


def _diode(ct, **kw):
    cir = ct.Circuit("dio")
    cir.V("v1", "in", "0", dc=1.0)
    cir.R("r1", "in", "a", 1e3)
    cir.D("d1", "a", "0", **{"is": 1e-14})
    cir.D("d2", "a", "b", **{"is": 1e-14})
    cir.R("r2", "b", "0", 2e3)
    return cir.compile(**kw)


def test_sharded_dcsweep_equals_plain_chain_and_jax():
    vals = np.linspace(-1.0, 5.0, 7)
    cc = _diode(tct, device="cpu")
    sol = sharded_dcsweep(cc, tct.Sweep("v1.dc", vals),
                          mesh=sweep_mesh(("cpu",) * 3))
    r = _get_dc_solver(cc)(torch.zeros((7, cc.n), dtype=torch.float64),
                           batch_params(cc, {"v1.dc": vals}),
                           cc.spec.dyn("cpu"))
    assert sol.x.shape == (7, cc.n) and bool(sol.converged.all())
    assert torch.equal(sol.x, r.x)
    assert torch.equal(sol.iters, r.iters)
    assert torch.equal(sol.resnorm, r.resnorm)
    np.testing.assert_array_equal(sol.table["v1.dc"], vals)
    jcc = _diode(jct)
    jsol = jax_mesh.sharded_dcsweep(
        jcc, jct.Sweep("v1.dc", vals),
        mesh=jax_mesh.sweep_mesh(jax.devices()[:3]))
    assert np.asarray(jsol.x).shape == (7, cc.n)
    assert np.abs(sol.x.numpy() - np.asarray(jsol.x)).max() <= 1e-12
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(jsol.converged))


def test_sharded_transweep_equals_transweep_and_jax():
    cc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    tab = tct.montecarlo_table(cc, SPREAD, 10, seed=7)
    span, kw = (0, 2e-8), dict(dt=3.333e-10, max_steps=8000)
    ssol = sharded_transweep(cc, tab, span, mesh=("cpu",) * 4, **kw)
    lsol = tct.transweep(cc, tab, span, **kw)
    assert ssol.xs.shape == lsol.xs.shape == (10,) + lsol.xs.shape[1:]
    assert torch.equal(ssol.xs, lsol.xs)
    for f in ("naccept", "nreject", "nnewton", "fail"):
        assert torch.equal(getattr(ssol.stats, f), getattr(lsol.stats, f))
    assert torch.equal(ssol.op_iters, lsol.op_iters)
    assert torch.equal(ssol.op_converged, lsol.op_converged)
    assert ssol.table["cq.c"].shape == (10,)
    jcc = jct.parse_spice(jax_dff())
    jtab = jct.montecarlo_table(jcc, SPREAD, 10, seed=7)
    for k in tab:
        np.testing.assert_array_equal(tab[k], jtab[k])
    jsol = jax_mesh.sharded_transweep(
        jcc, jtab, span, mesh=jax_mesh.sweep_mesh(jax.devices()[:4]), **kw)
    assert np.asarray(jsol.xs).shape == tuple(ssol.xs.shape)
    # the JAX function gathers only xs; its stats carry the padded lanes
    np.testing.assert_array_equal(
        ssol.stats.nnewton.numpy(), np.asarray(jsol.stats.nnewton)[:10])
    q = ssol["q"].numpy()
    assert np.isfinite(ssol.xs.numpy()).all()
    assert np.abs(q - np.asarray(jsol["q"])).max() <= 1e-9 * 5.0


def test_default_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_mesh(("cuda:0",))


@pytest.mark.gpu
def test_two_shards_on_one_card_equal_the_local_sweep():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    cc = tct.parse_spice(tct.dff_netlist(), device="cuda")
    tab = tct.montecarlo_table(cc, SPREAD, 64, seed=7)
    span, kw = (0, 2e-8), dict(dt=3.333e-10, max_steps=8000)
    ssol = sharded_transweep(cc, tab, span,
                             mesh=sweep_mesh(("cuda:0",) * 2), **kw)
    lsol = tct.transweep(cc, tab, span, **kw)
    assert ssol.xs.device == lsol.xs.device
    assert torch.equal(ssol.stats.nnewton, lsol.stats.nnewton)
    assert (ssol.xs - lsol.xs).abs().max().item() <= 1e-9
