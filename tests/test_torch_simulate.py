"""The port's netlist runner `simulate()` and its behavioral B-sources
(cadnip_tpu_torch/frontend/elaborate.py, frontend/expressions.py::
eval_expr_traced, analyses/measure.py) against the JAX package: the decks
of tests/test_frontend.py's B-source, `simulate`, `.dc`, `.meas` and
`.data` cases, and decks for `.tran uic` / `.ic` / `method=gear`,
`.ac lin|oct`, `.noise` and B-sources with `time`, a ternary and an i()
sense in a transient, and tests/test_pdk.py's corners of a miniature PDK
(`register_pdk`, `jlpkg://` paths, `.lib` sections), each run through
both packages (the port's on the CPU). Values within 1e-9 relative,
transient counts exact, `.meas` results within 1e-9 relative."""
import numpy as np
import pytest
import torch

from cadnip_tpu.frontend.elaborate import simulate as jax_simulate
from cadnip_tpu_torch import parse_spice, simulate
from cadnip_tpu_torch.frontend.elaborate import ElabError

torch.set_num_threads(1)

RTOL = 1e-9


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _same(kind, sol, ref):
    """One analysis result of the port against the JAX package's."""
    if kind in ("op", "dc"):
        np.testing.assert_array_equal(_np(sol.converged),
                                      _np(ref.converged))
        _close(sol.x, ref.x)
    elif kind == "tran":
        for a, b in zip(sol.stats[:3], ref.stats[:3]):
            np.testing.assert_array_equal(_np(a), _np(b))
        _close(sol.xs, ref.xs)
    elif kind == "ac":
        _close(sol.x_re, ref.x_re)
        _close(sol.x_im, ref.x_im)
    elif kind == "noise":
        _close(sol.onoise_psd, ref.onoise_psd)
        if ref.inoise_psd is not None:
            _close(sol.inoise_psd, ref.inoise_psd)


def _both(deck):
    res = simulate(deck, device="cpu")
    ref = jax_simulate(deck)
    assert [k for k, _ in res["all"]] == [k for k, _ in ref["all"]]
    for (kind, sol), (_, rsol) in zip(res["all"], ref["all"]):
        _same(kind, sol, rsol)
    assert set(res.get("meas", {})) == set(ref.get("meas", {}))
    for k, v in ref.get("meas", {}).items():
        assert res["meas"][k] == pytest.approx(v, rel=RTOL, abs=1e-300)
    return res


def test_behavioral_bsource():
    deck = """bsrc
v1 in 0 2
r1 in 0 1k
bsq out 0 v={v(in)*v(in) + 1}
rl out 0 1k
.op
"""
    res = _both(deck)
    assert float(res["op"]["out"]) == pytest.approx(5.0, rel=1e-8)
    # parse_spice builds the same B-source
    cc = parse_spice(deck, device="cpu")
    assert any(g.model.name == "bsource:bsq" for g in cc.groups)


def test_simulate_runs_cards():
    res = _both("""auto
v1 in 0 dc 5 ac 1
r1 in out 1k
c1 out 0 1u
.op
.ac dec 5 10 10k
.tran 10u 1m
""")
    assert float(res["op"]["out"]) == pytest.approx(5.0, rel=1e-9)
    assert res["ac"]["out"].shape[0] > 10
    assert abs(res["ac"]["out"][0]) > 0.9
    assert res["tran"].xs.shape[1] >= 2
    assert res["circuit"].device.type == "cpu"


def test_dc_sweep_card():
    res = _both("""sweepcard
v1 in 0 1
r1 in out 1k
r2 out 0 1k
.dc v1 0 5 1
""")
    np.testing.assert_allclose(res["dc"]["out"].numpy(),
                               np.arange(0, 6) / 2.0, rtol=1e-9)


def test_meas_cards():
    res = _both("""meas test
vs in 0 dc 0 pulse 0 1 1u 1n 1n 4u 10u
r1 in out 1k
c1 out 0 1n
.tran 0.05u 8u
.meas tran vmax max v(out) from=0 to=8u
.meas tran vend find v(out) at=4u
.meas tran tcross when v(out)=0.5 rise=1
.meas tran tdel trig v(in) val=0.5 rise=1 targ v(out) val=0.5 rise=1
.meas tran vsq param = vmax*vmax
.meas tran iavg avg i(vs) from=1u to=5u
""")
    m = res["meas"]
    assert m["vmax"] == pytest.approx(1.0, abs=2e-2)
    assert m["vend"] == pytest.approx(1.0 - np.exp(-3), abs=2e-2)
    assert m["tcross"] == pytest.approx(1e-6 + 0.693e-6, rel=0.05)
    assert m["tdel"] == pytest.approx(0.693e-6, rel=0.05)
    assert m["vsq"] == pytest.approx(m["vmax"] ** 2)


def test_data_driven_dc_sweep():
    res = _both("""data sweep
v1 in 0 dc 1
r1 in out 1k
r2 out 0 1k
.data tab r1.r v1.dc
+ 1k 1
+ 3k 2
+ 1k 4
.enddata
.dc data=tab
""")
    assert res["dc"]["out"].numpy() == pytest.approx([0.5, 0.5, 2.0])


def test_unknown_data_table_raises():
    deck = "bad\nv1 in 0 1\nr1 in 0 1k\n.dc data=nope\n"
    with pytest.raises(ElabError, match="unknown table"):
        simulate(deck, device="cpu")


def test_bsource_time_ternary_and_current_sense_in_tran():
    # a V-type source of time with a ternary, an I-type source of a
    # sensed current, and a comparison mask
    res = _both("""behavioral tran
vs in 0 dc 0 sin 0 1 100k
rs in a 1k
ba b 0 v={time < 5u ? 2*v(a) : v(a) - 0.5*sin(2e5*time)}
rb b 0 2k
bi c 0 i={1e-3*i(vs) + 1e-4*(v(a) > 0.2)}
rc c 0 1k
cc c 0 1n
.tran 0.1u 20u
""")
    sol = res["tran"]
    assert bool(sol.converged)
    ts = sol.ts
    i = np.argmin(np.abs(ts - 2e-6))
    assert float(sol["b"][i]) == pytest.approx(2 * float(sol["a"][i]),
                                               rel=1e-6)


def test_simulate_tran_options_and_small_signal_cards():
    # .tran with uic and .ic under .options method=gear; .ac lin and oct;
    # .noise referred to a V source
    _both("""cards
v1 in 0 dc 1 ac 1 pulse 0 1 1u 1u 1u 5u 20u
r1 in out 1k
c1 out 0 1n
d1 out 0 dx
.model dx d is=1e-14
.ic v(out)=0.3
.options method=gear
.tran 0.1u 10u uic
.ac lin 7 1k 1meg
.ac oct 3 1k 64k
.noise v(out) v1 dec 5 1k 1meg
""")


PDK_LIB = """* testpdk.spice
.lib typical
.param rsheet=1k
.param kp_n=200u
.model nch nmos vto=0.5 kp={kp_n}
.endl

.lib fast
.param rsheet=800
.param kp_n=260u
.model nch nmos vto=0.42 kp={kp_n}
.endl

.lib slow
.param rsheet=1.25k
.param kp_n=150u
.model nch nmos vto=0.6 kp={kp_n}
.endl
"""

PDK_VA = """
`include "disciplines.vams"
module pdkres(p, n);
  inout p, n;
  electrical p, n;
  parameter real rs = 1k from (0:inf);
  parameter real mult = 1 from (0:inf);
  analog I(p, n) <+ V(p, n) * mult / rs;
endmodule
"""


@pytest.fixture()
def pdk_dir(tmp_path):
    # tests/test_pdk.py's miniature PDK, registered in both packages
    from cadnip_tpu.frontend.elaborate import register_pdk as jax_register
    from cadnip_tpu_torch.frontend.elaborate import register_pdk
    (tmp_path / "testpdk.spice").write_text(PDK_LIB)
    (tmp_path / "pdkres.va").write_text(PDK_VA)
    jax_register("testpdk", str(tmp_path))
    register_pdk("testpdk", str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("section, rs", [("typical", 1000.0),
                                         ("fast", 800.0), ("slow", 1250.0)])
def test_pdk_corner_selects_the_lib_section(pdk_dir, section, rs):
    # tests/test_pdk.py's divider of PDK Verilog-A resistors and its MOS
    # through a jlpkg:// .lib section: one corner per case
    res = _both(f"""pdk divider ({section})
.lib "jlpkg://testpdk/testpdk.spice" {section}
.hdl "jlpkg://testpdk/pdkres.va"
v1 in 0 dc 2
x1 in mid pdkres rs={{rsheet}}
x2 mid 0 pdkres rs={{rsheet}}
.op
""")
    sol = res["op"]
    assert float(sol["mid"]) == pytest.approx(1.0, rel=1e-9)
    assert float(sol.i("v1")) == pytest.approx(-2.0 / (2 * rs), rel=1e-9)
    deck = f"""pdk mos
.lib "jlpkg://testpdk/testpdk.spice" {section}
vd d 0 dc 2
vg g 0 dc 1.5
m1 d g 0 0 nch w=10u l=1u
.op
"""
    sol, ref = simulate(deck, device="cpu")["op"], jax_simulate(deck)["op"]
    _same("op", sol, ref)
    assert sol.op_info("m1")["ids"] == pytest.approx(
        ref.op_info("m1")["ids"], rel=RTOL)


def test_unknown_pdk_package_errors():
    deck = """bad
.lib "jlpkg://nosuchpdk/x.spice" typical
r1 a 0 1k
.op
"""
    with pytest.raises(ValueError, match="unknown PDK package"):
        simulate(deck, device="cpu")


@pytest.mark.gpu
def test_simulate_on_cuda_matches_jax():
    """On the card: simulate() of the .meas deck and of a B-source deck,
    every solve a K1 launch, against JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    deck = """meas bsource
vs in 0 dc 0 pulse 0 1 1u 1n 1n 4u 10u
r1 in out 1k
c1 out 0 1n
bq sq 0 v={v(out)*v(out) + 1}
rq sq 0 1k
.tran 0.05u 8u
.meas tran tdel trig v(in) val=0.5 rise=1 targ v(out) val=0.5 rise=1
.meas tran sqmax max v(sq)
"""
    gj_solve.launches = 0
    res = simulate(deck, device="cuda")
    ref = jax_simulate(deck)
    assert gj_solve.launches >= int(res["tran"].stats.nnewton)
    _same("tran", res["tran"], ref["tran"])
    for k, v in ref["meas"].items():
        assert res["meas"][k] == pytest.approx(v, rel=RTOL)
