"""The EKV compact model (models/ekv.py, inline Verilog-A) compiled by the
port against the same model compiled by the JAX package, case for case
with tests/test_ekv.py (the EKV DFF is in tests/test_torch_ekv_dff.py).
DC to 1e-10 relative with equal Newton counts, the transient with equal
counts and waveforms to 1e-9 of the scale, noise and op-vars to 1e-10
relative. Every port call runs on the CPU."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.models.ekv import EKV_VA as JAX_EKV_VA, compile_ekv as jekv
from cadnip_tpu_torch.models.ekv import EKV_VA, compile_ekv as tekv

torch.set_num_threads(1)

DC_RTOL, DC_ATOL = 1e-10, 1e-15
TRAN_TOL = 1e-9


@pytest.fixture(scope="module")
def models():
    return jekv(), tekv()


def _given(**kw):
    out = {}
    for k, v in kw.items():
        out[k] = v
        out[k + "__given"] = 1.0
    return out


def both(models, build):
    jm, tm = models
    return build(jct, jm).compile(), build(tct, tm).compile(device="cpu")


def assert_dc(jcc, tcc):
    js, ts = jct.dc(jcc), tct.dc(tcc)
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
    return js, ts


def counts(st):
    return tuple(int(v) for v in (st.naccept, st.nreject, st.nnewton))


def test_model_source_is_the_jax_packages():
    assert EKV_VA == JAX_EKV_VA


def test_strong_inversion_saturation(models):
    vto, n, kp, w, l, vg = 0.5, 1.3, 200e-6, 10e-6, 1e-6, 1.5

    def build(ct, m):
        cir = ct.Circuit("ekv-sat")
        cir.V("vdd", "d", "0", dc=2.5)
        cir.V("vg", "g", "0", dc=vg)
        cir.add(m, "m1", ("d", "g", "0", "0"),
                **_given(vto=vto, n=n, kp=kp, w=w, l=l))
        return cir
    js, ts = assert_dc(*both(models, build))
    i_d = ts.currents("m1")["d"]
    assert i_d == pytest.approx(float(js.currents("m1")["d"]), rel=DC_RTOL)
    assert i_d == pytest.approx(kp * w / l / (2 * n) * (vg - vto) ** 2,
                                rel=0.05)
    jo, to = js.op_info("m1"), ts.op_info("m1")
    for k in ("id_op", "vdsat_op"):
        assert to[k] == pytest.approx(float(jo[k]), rel=DC_RTOL)
    assert to["id_op"] == pytest.approx(i_d, rel=1e-6)


def test_weak_inversion_slope(models):
    vto, n = 0.5, 1.3
    ids = []
    for vg in (0.25, 0.35):
        def build(ct, m):
            cir = ct.Circuit(f"ekv-wi-{vg}")
            cir.V("vdd", "d", "0", dc=1.0)
            cir.V("vg", "g", "0", dc=vg)
            cir.add(m, "m1", ("d", "g", "0", "0"), **_given(vto=vto, n=n))
            return cir
        js, ts = assert_dc(*both(models, build))
        ids.append(ts.currents("m1")["d"])
    vt = 1.380649e-23 * 300.15 / 1.602176634e-19
    assert np.log(ids[1] / ids[0]) / 0.1 == pytest.approx(1 / (n * vt),
                                                          rel=0.05)


def test_pmos_sign(models):
    def build(ct, m):
        cir = ct.Circuit("ekv-p")
        cir.V("vss", "d", "0", dc=-2.0)
        cir.V("vg", "g", "0", dc=-1.5)
        cir.add(m, "m1", ("d", "g", "0", "0"), **_given(sign=-1))
        return cir
    js, ts = assert_dc(*both(models, build))
    assert ts.currents("m1")["d"] < -1e-6


def test_ekv_inverter_transient(models):
    def build(ct, m):
        cir = ct.Circuit("ekv-inv")
        cir.V("vdd", "vdd", "0", dc=2.5)
        cir.V("vin", "g", "0", wave=ct.Pulse(0.0, 2.5, td=1e-9, tr=50e-12,
                                             tf=50e-12, pw=4e-9, per=1e30))
        cir.R("rd", "vdd", "d", 20e3)
        cir.add(m, "m1", ("d", "g", "0", "0"), **_given(vto=0.6))
        cir.C("cl", "d", "0", 10e-15)
        return cir
    jcc, tcc = both(models, build)
    ref = jct.tran(jcc, (0, 8e-9), dt=2e-11)
    sol = tct.tran(tcc, (0, 8e-9), dt=2e-11)
    assert bool(ref.converged) and bool(sol.converged)
    assert counts(sol.stats) == counts(ref.stats)
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= TRAN_TOL * 2.5, err
    vd = sol["d"].numpy()
    assert vd[sol.ts < 0.9e-9].min() > 2.4
    assert vd[(sol.ts > 2e-9) & (sol.ts < 4.5e-9)].max() < 0.6


def test_ekv_noise(models):
    def build(ct, m):
        cir = ct.Circuit("ekv-n")
        cir.V("vdd", "vdd", "0", dc=2.5)
        cir.V("vg", "g", "0", dc=1.2)
        cir.R("rd", "vdd", "d", 5e3)
        cir.add(m, "m1", ("d", "g", "0", "0"), **_given(kf=1e-24, af=1.0))
        return cir
    jcc, tcc = both(models, build)
    freqs = [1e2, 1e6]
    ref, sol = jct.noise(jcc, "d", freqs), tct.noise(tcc, "d", freqs)
    np.testing.assert_allclose(sol.onoise_psd, np.asarray(ref.onoise_psd),
                               rtol=DC_RTOL, atol=0)
    c = sol.contributions["m1"]
    np.testing.assert_allclose(c, np.asarray(ref.contributions["m1"]),
                               rtol=DC_RTOL, atol=0)
    assert c[0] > c[1] > 0
