"""Verilog-A through the port's netlist front end against the JAX
package's, case for case with tests/test_va_netlist.py: `.hdl` loading,
X and N instantiation, and a `.model` card whose type names a VA module
(tier 2). Also the tier-1 registry (`models/registry.py`: its cases need
the VA model files and skip without them, as tests/test_vadistiller.py
does; without them a level-2 card or a J element fails as in JAX), and
the front end's error paths with the JAX package's messages: the wrong
port count, an unknown parameter warned once, a structural-parameter
override warned. Every port call runs on the CPU."""
import warnings

import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.models import registry as jreg
from cadnip_tpu_torch.models import registry as treg
from cadnip_tpu_torch.interop import params_from_numpy

torch.set_num_threads(1)

DC_RTOL, DC_ATOL = 1e-10, 1e-15

VA_FILE = """
`include "disciplines.vams"
module vares(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = 1k from (0:inf);
  analog I(p, n) <+ V(p, n) / r;
endmodule

module vadiode(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14;
  parameter real n = 1.0;
  analog I(a, c) <+ is_ * (limexp(V(a, c) / (n * $vt)) - 1.0);
endmodule

module lpf(p, n, ctl);
  inout p, n, ctl; electrical p, n, ctl;
  parameter real tau = 1u;
  analog V(p, n) <+ laplace_nd(V(ctl), {1.0}, {1.0, tau});
endmodule
"""


@pytest.fixture()
def va_path(tmp_path):
    p = tmp_path / "models.va"
    p.write_text(VA_FILE)
    return str(p)


def both_dc(net, **kw):
    jcc = jct.parse_spice(net, **kw)
    tcc = tct.parse_spice(net, device="cpu", **kw)
    js, ts = jct.dc(jcc), tct.dc(tcc)
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
    return jcc, tcc, ts


def test_hdl_and_x_instantiation(va_path):
    jcc, tcc, ts = both_dc(f"""va test
.hdl "{va_path}"
v1 in 0 5
x1 in out vares r=2k
x2 out 0 vares
""")
    assert float(ts["out"]) == pytest.approx(5.0 / 3.0, rel=1e-9)
    # the parameters carry over, __given masks included
    p = params_from_numpy([jax.tree.map(np.array, d)
                           for d in jcc.params0()], device="cpu")
    gi = next(i for i, g in enumerate(tcc.groups)
              if g.model.name == "va:vares")
    assert p[gi]["r__given"].tolist() == [1.0, 0.0]
    np.testing.assert_array_equal(tct.dc(tcc, p).x.numpy(), ts.x.numpy())


def test_model_card_resolves_to_va(va_path):
    _, _, ts = both_dc(f"""va tier2
.hdl "{va_path}"
.model myd vadiode (is_=1e-15)
v1 in 0 5
r1 in d 1k
d1 d 0 myd
""")
    assert 0.5 < float(ts["d"]) < 0.9


def test_n_element(va_path):
    _, _, ts = both_dc(f"""va n-element
.hdl "{va_path}"
v1 in 0 1
n1 in 0 vares r=500
""")
    assert float(ts.i("v1")) == pytest.approx(-2e-3, rel=1e-9)


def test_hdl_argument_preloads(va_path):
    _, _, ts = both_dc("""va preloaded
v1 in 0 2
n9 in 0 vares r=4k
""", hdl=va_path)
    assert float(ts.i("v1")) == pytest.approx(-5e-4, rel=1e-9)


def _messages(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn()
    return [str(x.message) for x in w]


def test_error_paths_match_jax(va_path):
    bad = f"""wrong ports
.hdl "{va_path}"
v1 in 0 1
x1 in vares
"""
    msgs = []
    for pkg, kw in ((jct, {}), (tct, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            pkg.parse_spice(bad, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "has 2 ports, got 1 nodes" in msgs[0]

    unknown = f"""unknown parameter
.hdl "{va_path}"
v1 in 0 1
n1 in a vares r=500 foo=1
n2 a 0 vares foo=2
"""
    got = [_messages(lambda: jct.parse_spice(unknown)),
           _messages(lambda: tct.parse_spice(unknown, device="cpu"))]
    assert got[0] == got[1] == ["va:vares: parameter 'foo' ignored"]

    structural = f"""structural parameter
.hdl "{va_path}"
vs in 0 dc 0 ac 1
n1 out 0 in lpf tau=2u
rl out 0 1meg
"""
    got = [_messages(lambda: jct.parse_spice(structural)),
           _messages(lambda: tct.parse_spice(structural, device="cpu"))]
    assert got[0] == got[1] and len(got[0]) == 1
    assert "is structural" in got[0][0]


def test_registry_without_model_files(monkeypatch):
    """Without the VA model package the registry resolves nothing, as the
    JAX package's: level-1 cards stay built-in, and a level-2 card or a J
    element fails with JAX's message."""
    for reg in (jreg, treg):
        monkeypatch.setattr(reg, "_SEARCH_DIRS", ("",))
    assert treg.getmodel("nmos", 2) is None
    assert treg.getmodel("nmos", 1, prefer_va=False) is None
    assert treg.VA_LEVELS == jreg.VA_LEVELS
    net = """jfet without models
.model jn njf (vto=-2)
vd d 0 5
vg g 0 0
j1 d g 0 jn
"""
    msgs = []
    for pkg, kw in ((jct, {}), (tct, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            pkg.parse_spice(net, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "CADNIP_VA_MODELS" in msgs[0]
    lvl2 = """level 2 card without models
.model n2 nmos (level=2 vto=0.7 kp=50u)
vd d 0 5
vg g 0 2
m1 d g 0 0 n2 w=10u l=1u
"""
    _, _, ts = both_dc(lvl2)     # both fall back to the built-in level 1
    assert float(ts.i("vd")) < 0


def _need_models():
    if treg.model_dir() is None:
        pytest.skip("VA model package not present (CADNIP_VA_MODELS)")


def test_registry_level_resolution():
    _need_models()
    _, _, ts = both_dc("""level 2 card
.model n2 nmos (level=2 vto=0.7 kp=50u)
vdd vdd 0 5
vg g 0 2
rd vdd d 10k
m1 d g 0 0 n2 w=10u l=1u
""")
    assert 0.0 < float(ts["d"]) < 5.0


def test_registry_jfet_element():
    _need_models()
    _, _, ts = both_dc("""jfet through the registry
.model jn njf (vto=-2 beta=1e-4)
vdd vdd 0 5
vg g 0 -1
rd vdd d 1k
j1 d g 0 jn
""")
    assert 0.0 < float(ts["d"]) < 5.0
