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
