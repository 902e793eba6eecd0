"""The DC rescue tiers of the port (cadnip_tpu_torch/mna/newton.py:
`make_ptran_rescue`, `make_lm_rescue`) against the JAX package
(tests/test_robust.py), serial and on batched lanes. `dc()`'s use of them
is in tests/test_torch_robust_dc.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses.sweeps import batch_params as jax_batch_params
from cadnip_tpu.mna import newton as jnewton
from cadnip_tpu_torch.analyses.sweeps import batch_params
from cadnip_tpu_torch.mna import newton as tnewton

torch.set_num_threads(1)
DECKS = {
    "diode_chain": """diode chain
v1 in 0 dc 5
r1 in a 1k
d1 a b d
d2 b 0 d
.model d d is=1e-14
""",
    "bridge": """bridge
.model dd d is=76.9p n=1.45
v1 a b dc 20
d1 a p dd
d2 n a dd
d3 b p dd
d4 n b dd
rl p n 1k
rg1 b 0 1meg
rg2 n 0 1meg
""",
    # five junctions at 100 V behind 10 ohms: with the capped chain below
    # the homotopy fails and a rescue tier converges
    "diode5": """five diodes
.model dd d is=1e-15 n=1
vs in 0 dc 100
r1 in a 10
d1 a b dd
d2 b c dd
d3 c d dd
d4 d e dd
d5 e 0 dd
.end
""",
}
CAPPED = dict(max_newton_iters=8, gmin_steps=2, src_steps=2)


def _pair(deck, **spec):
    return (jct.parse_spice(DECKS[deck], spec=jct.SimSpec(**spec)),
            tct.parse_spice(DECKS[deck], spec=tct.SimSpec(**spec),
                            device="cpu"))


def _same(r, ref, rtol=1e-12):
    np.testing.assert_array_equal(r.converged.numpy().reshape(-1),
                                  np.asarray(ref.converged).reshape(-1))
    np.testing.assert_array_equal(r.iters.numpy().reshape(-1),
                                  np.asarray(ref.iters).reshape(-1))
    x, xr = r.x.numpy(), np.asarray(ref.x)
    np.testing.assert_allclose(x.reshape(xr.shape), xr, rtol=rtol,
                               atol=rtol * np.abs(xr).max())


@pytest.mark.parametrize("tier", ["make_ptran_rescue", "make_lm_rescue"])
@pytest.mark.parametrize("deck", ["diode_chain", "bridge"])
def test_rescue_tier_from_zeros_matches_jax(tier, deck):
    jcc, tcc = _pair(deck)
    ref = getattr(jnewton, tier)(jcc)(jnp.zeros(jcc.n), jcc.params0(),
                                      jcc.spec.dyn())
    r = getattr(tnewton, tier)(tcc)(
        torch.zeros((1, tcc.n), dtype=torch.float64), tcc.params0(),
        tcc.spec.dyn(tcc.device))
    assert bool(r.converged[0])
    _same(r, ref)


@pytest.mark.parametrize("tier", ["make_ptran_rescue", "make_lm_rescue"])
def test_rescue_tier_on_batched_lanes_matches_jax_vmap(tier):
    jcc, tcc = _pair("bridge")
    vals = np.array([5.0, 20.0, 30.0])
    bp, axes = jax_batch_params(jcc, {"v1.dc": vals})
    ref = jax.vmap(getattr(jnewton, tier)(jcc), in_axes=(None, axes, None))(
        jnp.zeros(jcc.n), bp, jcc.spec.dyn())
    r = getattr(tnewton, tier)(tcc)(
        torch.zeros((3, tcc.n), dtype=torch.float64),
        batch_params(tcc, {"v1.dc": vals}), tcc.spec.dyn(tcc.device))
    assert r.x.shape == (3, tcc.n) and r.converged.any()
    _same(r, ref)
