"""Noise analysis of the port (cadnip_tpu_torch/analyses/noise.py): the
closed forms of tests/test_ac_noise.py (thermal, kT/C, shot, the flicker
slope), and the DFF's output noise against JAX `noise`, total, per device
and input-referred to the supply, at <= 1e-9 relative."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses.noise import noise as jax_noise
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu_torch.interop import params_from_numpy

torch.set_num_threads(1)
KB = 1.380649e-23
QE = 1.602176634e-19
T0 = 300.15  # 27 C
TOL = 1e-9


def test_resistor_thermal_noise_psd():
    r1, r2 = 1e3, 3e3
    cir = tct.Circuit("rn")
    cir.V("vs", "in", "0", dc=0.0)
    cir.R("r1", "in", "out", r1)
    cir.R("r2", "out", "0", r2)
    sol = tct.noise(cir.compile(device="cpu"), "out", [1e3], input="vs")
    rpar = r1 * r2 / (r1 + r2)
    assert sol.onoise_psd[0] == pytest.approx(4 * KB * T0 * rpar, rel=1e-6)
    gain = r2 / (r1 + r2)
    assert sol.inoise_psd[0] == pytest.approx(
        4 * KB * T0 * rpar / gain**2, rel=1e-6)
    tot = sum(v[0] for v in sol.contributions.values())
    assert tot == pytest.approx(sol.onoise_psd[0], rel=1e-12)


def test_kt_over_c_total_noise():
    r, c = 1e3, 1e-9
    cir = tct.Circuit("ktc")
    cir.V("vs", "in", "0", dc=0.0)
    cir.R("r1", "in", "out", r)
    cir.C("c1", "out", "0", c)
    fc = 1.0 / (2 * np.pi * r * c)
    sol = tct.noise(cir.compile(device="cpu"), "out",
                    tct.acdec(40, fc * 1e-3, fc * 1e3))
    assert sol.total_noise() == pytest.approx(np.sqrt(KB * T0 / c), rel=2e-2)


def test_diode_shot_noise():
    cir = tct.Circuit("dn")
    cir.V("vs", "in", "0", dc=5.0)
    cir.R("r1", "in", "out", 1e3)
    cir.D("d1", "out", "0", **{"is": 1e-14})
    cc = cir.compile(device="cpu")
    vd = float(tct.dc(cc)["out"])
    vt = KB * T0 / QE
    i_d = 1e-14 * (np.exp(vd / vt) - 1)
    gd = i_d / vt
    sol = tct.noise(cc, "out", [1e3])
    zout = 1.0 / (gd + 1e-3)
    expect = (4 * KB * T0 / 1e3 + 2 * QE * i_d) * zout**2
    assert sol.onoise_psd[0] == pytest.approx(expect, rel=1e-2)


def test_flicker_noise_slope():
    cir = tct.Circuit("fn")
    cir.V("vs", "in", "0", dc=5.0)
    cir.R("r1", "in", "out", 1e3)
    cir.D("d1", "out", "0", **{"is": 1e-14, "kf": 1e-16, "af": 1.0})
    sol = tct.noise(cir.compile(device="cpu"), "out", [1.0, 10.0, 100.0])
    d = sol.contributions["d1"]
    assert d[0] / d[1] == pytest.approx(10.0, rel=0.05)


def _rel(got, want):
    """max |got - want| / max |want|; an off device's exact zeros must be
    zeros."""
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    return float(err / scale) if scale > 0 else float(err)


def test_dff_output_noise_matches_jax():
    """The DFF's noise at q over 1 kHz-100 GHz (41 points), referred to
    the supply vvdd: the total, the input-referred PSD and every device's
    contribution against JAX."""
    jcc = jct.parse_spice(jax_dff())
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    tp = params_from_numpy([jax.tree.map(np.array, d)
                            for d in jcc.params0()], device="cpu")
    freqs = tct.acdec(5, 1e3, 1e11)
    jsol = jax_noise(jcc, "q", freqs, input="vvdd")
    tsol = tct.noise(tcc, "q", freqs, tp, input="vvdd")
    assert bool(jsol.converged) and bool(tsol.converged)
    assert _rel(tsol.onoise_psd, jsol.onoise_psd) <= TOL
    assert _rel(tsol.inoise_psd, jsol.inoise_psd) <= TOL
    assert set(tsol.contributions) == set(jsol.contributions)
    assert len(tsol.contributions) == 26       # the MOSFETs
    for k, want in jsol.contributions.items():
        assert _rel(tsol.contributions[k], want) <= TOL, k
    assert (tsol.onoise_psd > 0).all()
    # the devices that conduct at the operating point carry the noise
    assert sum(v.max() > 0 for v in tsol.contributions.values()) >= 4


def _ce_stage(ct, **kw):
    cir = ct.Circuit("ce")
    cir.V("vcc", "vcc", "0", dc=5.0)
    cir.I("ib", "0", "b", dc=1e-5)
    cir.R("rb", "b", "0", 1e5)
    cir.R("rc", "vcc", "c", 2e3)
    cir.add(ct.devices.BJT, "q1", ("c", "b", "0"), bf=100.0,
            **{"is": 1e-15})
    return cir.compile(**kw)


def test_bjt_noise_matches_jax():
    """A BJT common-emitter stage: output noise at the collector, referred
    to the supply, against JAX (the BJT's collector and base shot
    noise)."""
    freqs = [1e2, 1e4, 1e6]
    jsol = jax_noise(_ce_stage(jct), ("c", "0"), freqs, input="vcc")
    tsol = tct.noise(_ce_stage(tct, device="cpu"), ("c", "0"), freqs,
                     input="vcc")
    assert _rel(tsol.onoise_psd, jsol.onoise_psd) <= TOL
    assert _rel(tsol.inoise_psd, jsol.inoise_psd) <= TOL
    assert _rel(tsol.contributions["q1"], jsol.contributions["q1"]) <= TOL
    assert tsol.contributions["q1"].min() > 0


def test_input_source_to_ground_refers_through_its_gain():
    """Input referral to a current source with one terminal on ground (the
    JAX package indexes the ground slot there and raises IndexError): the
    input-referred PSD is the output PSD over |H|^2, H the source's AC
    transfer to the output from `ac` with acmag = 1."""
    cc = _ce_stage(tct, device="cpu")
    freqs = [1e2, 1e4, 1e6]
    sol = tct.noise(cc, ("c", "0"), freqs, input="ib")
    h = tct.ac(cc, freqs, cc.alter(cc.params0(), **{"ib.acmag": 1.0}))["c"]
    np.testing.assert_allclose(sol.inoise_psd, sol.onoise_psd / abs(h) ** 2,
                               rtol=1e-9)


@pytest.mark.gpu
def test_noise_on_cuda_matches_jax_in_one_k1_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    jcc = jct.parse_spice(jax_dff())
    tcc = tct.parse_spice(tct.dff_netlist(), device="cuda")
    op = tct.dc(tcc)
    freqs = tct.acdec(5, 1e3, 1e11)
    gj_solve.launches = 0
    tsol = tct.noise(tcc, "q", freqs, input="vvdd", op_x=op.x)
    assert gj_solve.launches == 1
    jsol = jax_noise(jcc, "q", freqs, input="vvdd")
    assert _rel(tsol.onoise_psd, jsol.onoise_psd) <= TOL
    assert _rel(tsol.inoise_psd, jsol.inoise_psd) <= TOL
