"""`dc(..., rescue=...)` of the port (cadnip_tpu_torch/analyses/dc.py):
where the homotopy chain fails, the pseudo-transient and then the
Levenberg-Marquardt tier, against the JAX package's `dc`, serial and on
batched lanes."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.analyses.sweeps import batch_params
from cadnip_tpu_torch.mna import newton as tnewton

from test_torch_robust import CAPPED, DECKS, _pair, _same

torch.set_num_threads(1)


@pytest.mark.parametrize("rescue", [False, True])
@pytest.mark.parametrize("deck", ["diode5", "bridge"])
def test_dc_with_capped_chain_lands_on_jax_point(deck, rescue):
    # the capped chain fails on diode5 (the tiers run only with rescue)
    # and still converges on the bridge (tests/test_robust.py:121-142)
    jcc, tcc = _pair(deck, **CAPPED)
    ref = jct.dc(jcc, rescue=rescue)
    sol = tct.dc(tcc, rescue=rescue)
    assert bool(sol.converged) == (rescue or deck == "bridge")
    _same(sol, ref)
    if deck == "bridge":
        full = tct.dc(tct.parse_spice(DECKS[deck], device="cpu"))
        np.testing.assert_allclose(sol.x.numpy(), full.x.numpy(), atol=1e-5)


def test_batched_dc_rescues_each_lane_like_jax():
    # one batch of three drives; the tiers run on every lane once one lane
    # fails, and each lane lands where the JAX package's serial dc() does
    jcc, tcc = _pair("diode5", **CAPPED)
    vals = [20.0, 60.0, 100.0]
    p = batch_params(tcc, {"vs.dc": np.array(vals)})
    chain = tct.dc(tcc, p, rescue=False)
    assert chain.converged.tolist() == [True, False, False]
    sol = tct.dc(tcc, p)
    assert sol.converged.tolist() == [True, False, True]
    for k, v in enumerate(vals):
        ref = jct.dc(jcc, jcc.alter(jcc.params0(), **{"vs.dc": v}))
        assert bool(ref.converged) == bool(sol.converged[k])
        # the 60 V lane ends unconverged, on the last LM iterate: the
        # rounding of the two dense solves (K1's Gauss-Jordan, LAPACK's
        # LU) shows there
        np.testing.assert_allclose(sol.x[k].numpy(), np.asarray(ref.x),
                                   rtol=1e-9, atol=1e-9)


HEAVY_CHAIN = """heavy chain
.hdl "{va}"
vs in 0 dc 5
r1 in a 10
n1 a b heavy
n2 b c heavy
n3 c d heavy
n4 d e heavy
n5 e 0 heavy
.end
"""


@pytest.fixture()
def heavy_va(tmp_path):
    from test_torch_va_advanced import setup_heavy_va
    path = tmp_path / "heavy.va"
    path.write_text(setup_heavy_va())
    return str(path)


def test_host_pseudo_transient_rescue_matches_jax(heavy_va):
    # five junctions of a Verilog-A model that hoists its setup pass
    # (va_setup), at 5 V behind 10 ohms: a chain capped at 12 Newton
    # iterations per level fails, and an unbatched dc() takes the
    # host-driven pseudo-transient tier, which converges and confirms with
    # the whole chain; x and the iteration count are JAX's
    from cadnip_tpu_torch.analyses import dc as tdc
    deck = HEAVY_CHAIN.format(va=heavy_va)
    spec = dict(max_newton_iters=12, gmin_steps=1, src_steps=1)
    jcc = jct.parse_spice(deck, spec=jct.SimSpec(**spec))
    tcc = tct.parse_spice(deck, spec=tct.SimSpec(**spec), device="cpu")
    assert all(g.model.va_setup is not None for g in tcc.groups
               if g.model.name == "va:heavy")
    chain = tct.dc(tcc, rescue=False)
    assert not bool(chain.converged)
    ref = jct.dc(jcc)
    sol = tct.dc(tcc)
    assert bool(sol.converged) and bool(ref.converged)
    assert int(sol.iters) == int(ref.iters)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    # the tier is the host one: its count is the stepping's plus the
    # chain's, which the fused tier's (a plain Newton's) is not
    x0 = torch.zeros((1, tcc.n), dtype=torch.float64)
    dyn = tcc.spec.dyn("cpu")
    host = tdc._ptran_rescue_host(tcc, x0, sol.params, dyn)
    assert bool(host.converged[0])
    assert int(sol.iters) == int(chain.iters) + int(host.iters[0])
    fused = tnewton.make_ptran_rescue(tcc)(x0, sol.params, dyn)
    assert int(fused.iters[0]) != int(host.iters[0])


def test_dcsweep_runs_the_host_setup_per_batch(heavy_va):
    # a swept setup parameter re-enters the hoisted setup pass: one
    # [B, n_inst, K] setup matrix, and each lane's point is JAX's
    deck = HEAVY_CHAIN.format(va=heavy_va).replace(
        "n1 a b heavy", "n1 a b heavy gs=1e-2")
    jcc = jct.parse_spice(deck)
    tcc = tct.parse_spice(deck, device="cpu")
    tab = {"n1.gs": np.array([1e-3, 1e-2, 1e-1])}
    p = batch_params(tcc, tab)
    gi = next(i for i, g in enumerate(tcc.groups)
              if g.model.name == "va:heavy")
    assert p[gi]["__setup__"].shape[:2] == (3, 5)
    ref = jct.dcsweep(jcc, tab)
    sol = tct.dcsweep(tcc, tab)
    _same(sol, ref, rtol=1e-9)
    assert len(set(np.round(sol["b"].numpy(), 9))) == 3
