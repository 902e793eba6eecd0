"""The transient circuits of the once-deferred devices through the port.
The VACASK darlington (two cascaded NPNs, bench.py's DARLINGTON): `tran`
against the JAX package's `tran` over its first pulse period (0-2 us at
dt 2 ns), and K2's twin (`vmem_tran` on a CPU circuit) against the port's
`tran` over 0-1 us. chip_smoke.py's L/K/E/G/F/H deck: `tran` against
JAX's."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.models.vacask import DARLINGTON

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the edge-masked bar)

#: waveforms against JAX: max |dx| <= 1e-9 x 5 V
TOL_V = 1e-9 * 5.0


def _counts(st):
    return tuple(int(v) for v in (st.naccept, st.nreject, st.nnewton))


@pytest.fixture(scope="module")
def port_tran():
    cc = tct.parse_spice(DARLINGTON, device="cpu")
    return cc, tct.tran(cc, (0, 2e-6), dt=2e-9)


def test_darlington_text_is_the_bench_deck():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for f in ("bench.py", os.path.join("tests", "test_vacask_circuits.py")):
        assert DARLINGTON in open(os.path.join(root, f)).read(), f


def test_tran_matches_jax(port_tran):
    """Accepted, rejected and Newton counts exactly, the waveforms to
    1e-9 x 5 V; the ON state within the bench's physics (the composite
    saturation floor between 0.5 and 1 V at 0.5 us)."""
    cc, sol = port_tran
    jcc = jct.parse_spice(DARLINGTON)
    ref = jct.tran(jcc, (0, 2e-6), dt=2e-9)
    assert bool(sol.converged) and bool(ref.converged)
    assert _counts(sol.stats) == _counts(ref.stats)
    assert sol.xs.shape == np.asarray(ref.xs).shape == (1001, cc.n)
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= TOL_V, err
    ts = np.asarray(sol.ts)
    vc = sol["coll"].numpy()
    assert 0.5 < vc[np.argmin(np.abs(ts - 0.5e-6))] < 1.0
    assert vc[np.argmin(np.abs(ts - 1.5e-6))] > 4.5
    # the same parameters carried over give the same operating point
    p = params_from_numpy([jax.tree.map(np.array, d)
                           for d in jcc.params0()], device="cpu")
    np.testing.assert_array_equal(tct.dc(cc, p).x.numpy(),
                                  tct.dc(cc).x.numpy())


def test_k2_twin_matches_tran(port_tran):
    """K2's twin over the ON half-period and its falling edge, against the
    port's `tran` at the edge-masked bar of the bench's PIT test."""
    cc, sol = port_tran
    k2 = tct.vmem_tran(cc, (0, 1e-6), dt=2e-9)
    assert bool(k2.converged) and tct.supported(cc)
    assert k2.xs.shape == (501, cc.n)
    q99, mx = chip_smoke.edge_masked(k2.ts, k2["coll"].numpy(),
                                     sol["coll"].numpy()[:501])
    assert q99 < chip_smoke.EDGE_Q99_TOL and mx < chip_smoke.EDGE_MAX_TOL
    # in fact the two agree to about 1e-4 V (the integrators share their
    # devices and differ in step control)
    assert float(np.abs(k2.xs.numpy() - sol.xs.numpy()[:501]).max()) < 1e-3


def test_lkefgh_tran_matches_jax():
    """The L/K/E/G/F/H deck of chip_smoke.py (an RLC through a VCVS, a
    coupled secondary, a VCCS into a sensing source read by a CCCS and a
    CCVS) through `tran` over 0-1 us against JAX: counts exactly,
    waveforms to 1e-9 x 5 V."""
    net = chip_smoke.LKEFGH
    sol = tct.tran(tct.parse_spice(net, device="cpu"), (0, 1e-6), dt=2e-9)
    ref = jct.tran(jct.parse_spice(net), (0, 1e-6), dt=2e-9)
    assert bool(sol.converged) and bool(ref.converged)
    assert _counts(sol.stats) == _counts(ref.stats)
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= TOL_V, err
    # the coupled secondary and the current-controlled outputs move
    for node in ("s", "fo", "ho"):
        assert float(sol[node].abs().max()) > 1e-3
