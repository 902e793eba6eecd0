"""The port's fixed-step linear transient (`analyses/tran_linear.py`)
against the JAX package's on the CPU: `is_linear`, the VACASK rc over
0-8 ms at 1 us (the waveform and the closed-form gates of bench.py and
tests/test_vacask_circuits.py), a block that does not divide the step
count, and the refusal of a nonlinear circuit."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
from cadnip_tpu.analyses import tran_linear as jtl
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.analyses import tran_linear as ttl
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.models.vacask import GRAETZ, RC_NETLIST

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rc():
    jcc = jct.parse_spice(RC_NETLIST)
    tcc = tct.parse_spice(RC_NETLIST, device="cpu")
    p = params_from_numpy([jax.tree.map(np.array, d)
                           for d in jcc.params0()], device="cpu")
    return tcc, jcc, p


def test_is_linear_matches_jax():
    for net, want in ((RC_NETLIST, True), (GRAETZ, False)):
        assert ttl.is_linear(tct.parse_spice(net, device="cpu")) is want
        assert jtl.is_linear(jct.parse_spice(net)) is want
    assert tct.is_linear is ttl.is_linear


@pytest.mark.parametrize("block", [None, 96])
def test_rc_matches_jax(rc, block):
    """0-8 ms at 1 us with the automatic block (256 for n = 3) and with 96,
    which does not divide the 8000 steps: within 1e-12 V of JAX."""
    tcc, jcc, p = rc
    sol = ttl.tran_linear(tcc, (0, 8e-3), 1e-6, p, block=block)
    ref = jtl.tran_linear(jcc, (0, 8e-3), 1e-6, block=block)
    assert sol.xs.shape == np.asarray(ref.xs).shape == (8001, 3)
    np.testing.assert_array_equal(sol.ts, ref.ts)
    assert float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max()) <= 1e-12
    assert bool(sol.converged) and int(sol.stats.naccept) == 8000


def test_rc_closed_form(rc):
    """bench.py's gate (RMSE < 1e-6 against the exact response to the 1 us
    ramp on [5 us, 0.9 ms]) and tests/test_vacask_circuits.py's pulse-train
    checks."""
    tcc, _, _ = rc
    sol = tct.tran_linear(tcc, (0, 8e-3), 1e-6)
    v, ts = sol["2"].numpy(), sol.ts
    seg = (ts >= 5e-6) & (ts <= 9e-4)
    tau, tr = 1e-3, 1e-6
    v_ramp_end = 1.0 - tau / tr * (1 - np.exp(-tr / tau))
    v_exact = 1.0 + (v_ramp_end - 1.0) * np.exp(-(ts[seg] - 2e-6) / tau)
    assert float(np.sqrt(np.mean((v[seg] - v_exact) ** 2))) < 1e-6

    def at(t):
        return v[np.argmin(np.abs(ts - t))]

    peak = at(1.001e-3)
    assert peak == pytest.approx(1 - np.exp(-1), abs=5e-3)
    assert at(2.001e-3) == pytest.approx(peak * np.exp(-1), abs=5e-3)


def test_nonlinear_circuit_raises():
    for fn, cc in ((ttl.tran_linear, tct.parse_spice(GRAETZ, device="cpu")),
                   (jtl.tran_linear, jct.parse_spice(GRAETZ))):
        with pytest.raises(ValueError, match="all-linear"):
            fn(cc, (0, 1e-3), 1e-6)


@pytest.mark.gpu
def test_rc_on_the_card():
    """On the card: the operating point and K^-1 are one K1 launch each;
    the waveform equals the CPU port's to 1e-12 V."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    cpu = tct.tran_linear(tct.parse_spice(RC_NETLIST, device="cpu"),
                          (0, 8e-3), 1e-6)
    cc = tct.parse_spice(RC_NETLIST, device="cuda")
    gj_solve.launches = 0
    sol = tct.tran_linear(cc, (0, 8e-3), 1e-6)
    assert gj_solve.launches == 2
    assert float((sol.xs.cpu() - cpu.xs).abs().max()) <= 1e-12
