"""AC analysis of the port (cadnip_tpu_torch/analyses/ac.py): the closed
forms of tests/test_ac_noise.py, an RLC with coupled inductors and every
controlled source against JAX `ac`, and the DFF's supply rejection against
JAX. Each case builds the circuit in both packages from the same numbers;
the port's parameters come over by params_from_numpy. Bar against JAX:
max |H_port - H_jax| <= 1e-9 max |H_jax|."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses.ac import ac as jax_ac, acdec as jax_acdec
from cadnip_tpu.analyses.ac import subsystem as jax_subsystem
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu_torch.interop import params_from_numpy

torch.set_num_threads(1)
TOL = 1e-9


def _params(jcc):
    p = [jax.tree.map(np.array, d) for d in jcc.params0()]
    return params_from_numpy(p, device="cpu")


def _rc(ct, **kw):
    cir = ct.Circuit("rc")
    cir.V("vs", "in", "0", dc=0.0, acmag=1.0)
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-6)
    return cir.compile(**kw)


def test_rc_lowpass_ac():
    r, c = 1e3, 1e-6
    cc = _rc(tct, device="cpu")
    freqs = tct.acdec(10, 1.0, 1e5)
    np.testing.assert_array_equal(freqs, jax_acdec(10, 1.0, 1e5))
    sol = tct.ac(cc, freqs)
    w = 2 * np.pi * freqs
    assert np.allclose(sol["out"], 1.0 / (1.0 + 1j * w * r * c), rtol=1e-6,
                       atol=1e-9)
    fc = 1.0 / (2 * np.pi * r * c)
    sol3 = tct.ac(cc, [fc])
    assert sol3.magnitude_db("out")[0] == pytest.approx(-3.0103, abs=1e-3)
    assert sol3.phase_deg("out")[0] == pytest.approx(-45.0, abs=1e-3)
    assert bool(sol.converged) and "51 freqs" in repr(sol)


def test_ac_phase_source():
    cir = tct.Circuit("ph")
    cir.V("vs", "in", "0", dc=0.0, acmag=2.0, acphase=90.0)
    cir.R("r1", "in", "0", 1e3)
    sol = tct.ac(cir.compile(device="cpu"), [1e3])
    assert sol["in"][0] == pytest.approx(2j, rel=1e-9)


def test_isource_ac_sign_matches_jax():
    """An AC current source pushes +acmag into its n terminal (ac_rhs
    ((0, -1), (1, 1))), as in JAX."""
    out = []
    for ct, kw in ((jct, {}), (tct, {"device": "cpu"})):
        cir = ct.Circuit("isrc")
        cir.I("i1", "0", "a", dc=0.0, acmag=1e-3, acphase=30.0)
        cir.R("r1", "a", "0", 1e3)
        cir.C("c1", "a", "0", 1e-9)
        out.append((jax_ac if ct is jct else tct.ac)(cir.compile(**kw),
                                                     [1e3, 1e6])["a"])
    np.testing.assert_allclose(out[1], out[0], rtol=TOL)
    w = 2 * np.pi * np.array([1e3, 1e6])
    np.testing.assert_allclose(
        out[1], 1e-3 * np.exp(1j * np.pi / 6) * 1e3 / (1 + 1j * w * 1e-6),
        rtol=1e-9)


def test_common_source_amp_gain():
    kp, w, l, vth = 110e-6, 20e-6, 1e-6, 0.7
    vgs, rd, vdd = 1.0, 10e3, 5.0
    gm = kp * w / l * (vgs - vth)
    cir = tct.Circuit("cs")
    cir.V("vdd", "vdd", "0", dc=vdd)
    cir.V("vg", "g", "0", dc=vgs, acmag=1.0)
    cir.R("rd", "vdd", "d", rd)
    cir.M("m1", "d", "g", "0", "0", kp=kp, w=w, l=l, vth=vth)
    sol = tct.ac(cir.compile(tct.SimSpec(gmin=0.0), device="cpu"), [1e3])
    av = sol["d"][0]
    assert av.real == pytest.approx(-gm * rd, rel=1e-6)
    assert abs(av.imag) < 1e-9


def test_subsystem_siso_export():
    r, c = 1e3, 1e-6
    cc = _rc(tct, device="cpu")
    sys_out = tct.subsystem(cc, "out")
    assert sys_out.A.shape == (cc.n, cc.n)
    freqs = tct.acdec(5, 1.0, 1e4)
    h = sys_out.freqresp(freqs)
    w = 2 * np.pi * freqs
    assert np.allclose(h, 1.0 / (1.0 + 1j * w * r * c), rtol=1e-6,
                       atol=1e-9)
    assert np.allclose(h, tct.ac(cc, freqs)["out"], rtol=1e-6, atol=1e-9)
    sys_i = tct.subsystem(cc, "vs#i")
    assert np.allclose(sys_i.freqresp(freqs),
                       -1j * w * c / (1.0 + 1j * w * r * c), rtol=1e-6,
                       atol=1e-12)
    # the exported matrices are JAX's
    ref = jax_subsystem(_rc(jct), "out")
    for k in "AEBCD":
        np.testing.assert_allclose(getattr(sys_out, k), getattr(ref, k),
                                   rtol=1e-12, atol=0.0)


#: an RLC filter driven through a VCVS, with a coupled secondary, a CCCS
#: and a CCVS sensing the primary's source
RLC = """rlc with every controlled source
vin in 0 dc 0 ac 1
e1 drv 0 in 0 2
r1 drv a 50
l1 a b 10u
c1 b 0 1n
rload b 0 1k
l2 s 0 40u
k12 l1 l2 0.8
rs s 0 200
vsen drv2 0 0
g1 0 drv2 b 0 1m
f1 0 fo vsen 5
rf fo 0 100
h1 ho 0 vsen 1k
rh ho 0 1k
.end
"""


def _compare(jcc, tcc, freqs, nodes, params=None):
    tp = _params(jcc) if params is None else params[1]
    jsol = jax_ac(jcc, freqs, params[0] if params else None)
    tsol = tct.ac(tcc, freqs, tp)
    assert bool(jsol.converged) and bool(tsol.converged)
    for node in nodes:
        want, got = jsol[node], tsol[node]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL, (node, err)
    return tsol


def test_rlc_with_k_e_f_h_matches_jax():
    freqs = tct.acdec(20, 1e3, 1e9)
    sol = _compare(jct.parse_spice(RLC), tct.parse_spice(RLC, device="cpu"),
                   freqs, ["b", "s", "fo", "ho", "vsen#i", "l1#i", "l2#i"])
    # the series resonance of l1 and c1 near 1.6 MHz lifts |v(b)| above
    # the drive
    assert np.abs(sol["b"]).max() > 2.0


@pytest.fixture(scope="module")
def dff_pair():
    jcc = jct.parse_spice(jax_dff())
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    jp = jcc.alter(jcc.params0(), **{"vvdd.acmag": 1.0})
    tp = tcc.alter(_params(jcc), **{"vvdd.acmag": 1.0})
    return jcc, tcc, jp, tp


def test_dff_psrr_matches_jax(dff_pair):
    """The DFF's supply rejection: acmag = 1 on vvdd through the
    parameters, output q, at 41 points from 1 kHz to 100 GHz."""
    jcc, tcc, jp, tp = dff_pair
    freqs = tct.acdec(5, 1e3, 1e11)
    assert len(freqs) == 41
    sol = _compare(jcc, tcc, freqs, ["q", "vvdd#i"], params=(jp, tp))
    assert np.isfinite(sol["q"]).all()


def test_failed_operating_point_is_reported():
    """Two V sources that fight over one node: the operating point fails
    in both packages, and ac reports converged=False instead of
    raising."""
    out = []
    for ct, kw in ((jct, {}), (tct, {"device": "cpu"})):
        cir = ct.Circuit("fight")
        cir.V("v1", "a", "0", dc=1.0, acmag=1.0)
        cir.V("v2", "a", "0", dc=2.0)
        cir.R("r1", "a", "0", 1e3)
        out.append((jax_ac if ct is jct else tct.ac)(cir.compile(**kw),
                                                     [1e3]))
    assert not bool(out[0].converged)
    assert not bool(out[1].converged)


def test_batched_parameters_are_refused():
    cc = _rc(tct, device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        tct.ac(cc, [1e3], cc.alter(cc.params0(), **{"r1.r": [1e3, 2e3]}))


@pytest.mark.gpu
def test_ac_on_cuda_matches_jax_in_one_k1_launch():
    """On the card, the whole sweep of the RLC deck is one K1 launch, and
    it agrees with JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    jcc = jct.parse_spice(RLC)
    tcc = tct.parse_spice(RLC, device="cuda")
    op = tct.dc(tcc)
    freqs = tct.acdec(20, 1e3, 1e9)
    gj_solve.launches = 0
    tsol = tct.ac(tcc, freqs, op_x=op.x)
    assert gj_solve.launches == 1
    jsol = jax_ac(jcc, freqs)
    for node in ("b", "s", "fo", "ho"):
        assert np.abs(tsol[node] - jsol[node]).max() <= \
            TOL * np.abs(jsol[node]).max()


@pytest.mark.gpu
def test_ac_too_large_for_k1_raises_with_the_size():
    """A sweep whose 2n x 2n system outgrows one block's shared memory
    (n = 102) once raised; it now takes K1's grid variant in one launch
    and matches the CPU port."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve, variant
    cir = tct.Circuit("ladder")
    cir.V("v0", "n0", "0", dc=1.0, acmag=1.0)
    for i in range(100):
        cir.R(f"r{i}", f"n{i}", f"n{i + 1}", 10.0)
        cir.C(f"c{i}", f"n{i + 1}", "0", 1e-9)
    got = {}
    for dev in ("cuda", "cpu"):
        cc = cir.compile(device=dev)
        op = tct.dc(cc)
        gj_solve.launches = 0
        got[dev] = (tct.ac(cc, [1e3, 1e6], op_x=op.x)["n100"],
                    gj_solve.launches)
    assert variant(2 * cc.n, 1) == "grid" and got["cuda"][1] == 1
    assert np.abs(got["cuda"][0] - got["cpu"][0]).max() <= \
        TOL * np.abs(got["cpu"][0]).max()
