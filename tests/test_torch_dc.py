"""DC analysis of the port (cadnip_tpu_torch/analyses/dc.py): the
tests/test_dc.py cases that use only ported devices, each built in both
packages and solved from the same parameters, against JAX `dc` (and the
hand math where the case has it)."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.interop import params_from_numpy, to_numpy

torch.set_num_threads(1)
VT = 1.380649e-23 * (27 + 273.15) / 1.602176634e-19


def jax_params_np(params):
    return [jax.tree.map(np.array, d) for d in params]


def _divider(ct):
    cir = ct.Circuit("div")
    cir.V("v1", "in", "0", dc=5.0)
    cir.R("r1", "in", "out", 1e3)
    cir.R("r2", "out", "0", 1e3)
    return cir, {"out": 2.5}


def _isource(ct):
    cir = ct.Circuit("isrc")
    cir.I("i1", "0", "a", dc=1e-3)   # pushes 1 mA into node a
    cir.R("r1", "a", "0", 1e3)
    cir.R("r2", "a", "0", 1e3)
    return cir, {"a": 0.5}


def _diode(ct):
    is_, r, vsrc = 1e-14, 1e3, 5.0
    v = 0.6
    for _ in range(200):
        f = is_ * (np.exp(v / VT) - 1) - (vsrc - v) / r
        df = is_ / VT * np.exp(v / VT) + 1 / r
        v -= f / df
    cir = ct.Circuit("dr")
    cir.V("v1", "in", "0", dc=vsrc)
    cir.R("r1", "in", "d", r)
    cir.D("d1", "d", "0", **{"is": is_, "n": 1.0})
    return cir, {"d": v}


def _mosfet(ct):
    kp, w, l, vth, vdd, rd, vgs = 110e-6, 10e-6, 1e-6, 0.7, 5.0, 1e3, 1.7
    cir = ct.Circuit("cs")
    cir.V("vdd", "vdd", "0", dc=vdd)
    cir.V("vg", "g", "0", dc=vgs)
    cir.R("rd", "vdd", "d", rd)
    cir.M("m1", "d", "g", "0", "0", kp=kp, w=w, l=l, vth=vth)
    return cir, {"d": vdd - rd * 0.5 * kp * w / l * (vgs - vth) ** 2}


def _capacitor(ct):
    cir = ct.Circuit("c")
    cir.V("v1", "in", "0", dc=3.0)
    cir.R("r1", "in", "mid", 1e3)
    cir.C("c1", "mid", "0", 1e-6)
    cir.R("r2", "mid", "0", 1e3)
    return cir, {"mid": 1.5}


def _diode_stack(ct):
    # back-to-back diode stack from a 0 V start needs the homotopy
    cir = ct.Circuit("stack")
    cir.V("v1", "in", "0", dc=30.0)
    prev = "in"
    for k in range(40):
        cir.D(f"d{k}", prev, f"n{k}", **{"is": 1e-15})
        prev = f"n{k}"
    cir.R("rl", prev, "0", 10.0)
    return cir, {}


CASES = {"divider": _divider, "isource": _isource, "diode": _diode,
         "mosfet": _mosfet, "capacitor": _capacitor,
         "diode_stack": _diode_stack}


@pytest.mark.parametrize("case", list(CASES))
def test_dc_matches_jax(case):
    jcir, expect = CASES[case](jct)
    tcir, _ = CASES[case](tct)
    spec = jct.SimSpec(gmin=0.0) if case == "mosfet" else None
    jcc = jcir.compile(spec)
    tcc = tcir.compile(tct.SimSpec(gmin=0.0) if case == "mosfet" else None,
                       device="cpu")
    jsol = jct.dc(jcc)
    tsol = tct.dc(tcc, params_from_numpy(jax_params_np(jcc.params0()),
                                         device="cpu"))
    assert bool(jsol.converged) and bool(tsol.converged)
    assert int(tsol.iters) == int(jsol.iters)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               rtol=1e-9, atol=1e-12)
    for node, v in expect.items():
        assert float(tsol[node]) == pytest.approx(v, rel=1e-6)
    assert 0.0 <= float(tsol.resnorm) < 1e-3


def test_alter_and_unknown_param():
    cir, _ = _divider(tct)
    cc = cir.compile(device="cpu")
    sol = tct.dc(cc, cc.alter(cc.params0(), **{"r2.r": 3e3}))
    assert float(sol["out"]) == pytest.approx(3.75, rel=1e-9)
    with pytest.raises(KeyError):
        cc.alter(cc.params0(), **{"r1.typo": 1.0})


def test_currents_on_sources_and_nodeset():
    cir, _ = _divider(tct)
    sol = tct.dc(cir.compile(device="cpu"), nodeset={"out": 2.0})
    iv = sol.currents("v1")
    assert iv["p"] == pytest.approx(-2.5e-3, rel=1e-6)
    assert iv["n"] == pytest.approx(+2.5e-3, rel=1e-6)
    assert sol.currents("r1")["p"] == pytest.approx(2.5e-3, rel=1e-6)
    assert float(sol.i("v1")) == pytest.approx(-2.5e-3, rel=1e-6)
    assert "converged" in repr(sol)
    # a model without an op-info channel publishes nothing, as in JAX
    assert sol.op_info("r1") == {}
    np.testing.assert_array_equal(to_numpy(sol.x), sol.x.numpy())


def test_op_info_of_a_mosfet_matches_jax():
    """op_info of the common-source MOSFET (saturated) and of the DFF's
    first NMOS against the JAX package at the same operating point."""
    jcir, _ = _mosfet(jct)
    tcir, _ = _mosfet(tct)
    jcc = jcir.compile(jct.SimSpec(gmin=0.0))
    tcc = tcir.compile(tct.SimSpec(gmin=0.0), device="cpu")
    _, _, jdff, tdff = _dff_ops()
    cases = [(jct.dc(jcc), tct.dc(tcc), "m1"), (jdff, tdff, "mno1")]
    for jsol, tsol, inst in cases:
        got, want = tsol.op_info(inst), jsol.op_info(inst)
        assert set(got) == set(want) == {"ids", "vgs", "vds", "vth", "gm",
                                         "gds", "vdsat"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-18), k
    info = cases[0][1].op_info("m1")
    assert info["gm"] == pytest.approx(110e-6 * 10 * 1.0, rel=1e-9)


_DFF = {}


def _dff_ops():
    """The DFF in both packages and its operating point in each, built
    once per module: (jcc, tcc, jsol, tsol)."""
    if not _DFF:
        from cadnip_tpu.models.dff import dff_netlist
        jcc = jct.parse_spice(dff_netlist())
        tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
        _DFF["v"] = (jcc, tcc, jct.dc(jcc), tct.dc(
            tcc, params_from_numpy(jax_params_np(jcc.params0()),
                                   device="cpu")))
    return _DFF["v"]


@pytest.mark.parametrize("name", ["dff", "darlington"])
def test_operating_points_match_jax(name):
    """The DFF and the darlington (two NPNs) operating points against
    JAX's: the Newton count exactly, x to 1e-9 relative."""
    if name == "dff":
        _, _, jsol, tsol = _dff_ops()
    else:
        from cadnip_tpu_torch.models.vacask import DARLINGTON
        jcc = jct.parse_spice(DARLINGTON)
        tcc = tct.parse_spice(DARLINGTON, device="cpu")
        jsol = jct.dc(jcc)
        tsol = tct.dc(tcc, params_from_numpy(jax_params_np(jcc.params0()),
                                             device="cpu"))
    assert bool(jsol.converged) and bool(tsol.converged)
    assert int(tsol.iters) == int(jsol.iters)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               rtol=1e-9, atol=1e-12)
