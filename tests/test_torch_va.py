"""The port's Verilog-A compiler against the JAX package's, case for case
with tests/test_va.py (and the VA case of tests/test_opinfo.py): the same
VA source compiled by both packages, the same circuit solved by both, and
the results compared. DC: node voltages and branch currents to 1e-10
relative, Newton counts equal; transient: accepted, rejected and Newton
counts equal, waveforms to 1e-9 of the scale; noise and op-vars to 1e-10
relative. Every port call runs on the CPU.

test_va.py's `test_barrier_fencing_preserves_values` has no counterpart:
it tests `CADNIP_VA_BARRIER`, the JAX package's fence for its TPU
backend, which the port does not have.

Also here: `_safe_pow` (the JAX package's custom JVP, an
`autograd.Function` in the port) against JAX at its edge points, and the
error paths of the compiler and the assembler."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.va import codegen as jcg
from cadnip_tpu.va import parser as jparser
from cadnip_tpu_torch.va import codegen as tcg
from cadnip_tpu_torch.va import parser as tparser

torch.set_num_threads(1)

DC_RTOL, DC_ATOL = 1e-10, 1e-15
TRAN_TOL = 1e-9

VA_RESISTOR = """
`include "disciplines.vams"
module my_res(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = 1k from (0:inf);
  analog begin
    I(p, n) <+ V(p, n) / r;
  end
endmodule
"""

VA_RC = """
`include "disciplines.vams"
module my_rc(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = 1k;
  parameter real c = 1n;
  analog begin
    I(p, n) <+ V(p, n) / r + ddt(c * V(p, n));
  end
endmodule
"""

VA_DIODE = """
`include "disciplines.vams"
module my_diode(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14 from (0:1];
  parameter real n = 1.0;
  parameter real cj = 0.0;
  real id, vd;
  analog begin
    vd = V(a, c);
    id = is_ * (limexp(vd / (n * $vt)) - 1.0);
    I(a, c) <+ id;
    I(a, c) <+ ddt(cj * vd);
    I(a, c) <+ white_noise(2.0 * 1.602176634e-19 * abs(id), "shot");
  end
endmodule
"""

VA_VSRC = """
module my_vsrc(p, n);
  inout p, n;
  electrical p, n;
  parameter real level = 2.5;
  analog begin
    V(p, n) <+ level;
  end
endmodule
"""

VA_DEFAULTS = """
module defdep(p, n);
  inout p, n;
  electrical p, n;
  parameter real w = 2u;
  parameter real l = 1u;
  parameter real rsh = 100;
  parameter real r = rsh * l / w;   // depends on other params
  analog
    I(p, n) <+ V(p, n) / r;
endmodule
"""

VA_INTERNAL = """
module rdiv(p, n);
  inout p, n;
  electrical p, n, mid;
  parameter real r1 = 1k;
  parameter real r2 = 1k;
  analog begin
    I(p, mid) <+ V(p, mid) / r1;
    I(mid, n) <+ V(mid, n) / r2;
  end
endmodule
"""

VA_CONDLOOP = """
module condloop(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = 1k;
  parameter integer segs = 4;
  real g;
  integer k;
  analog begin
    g = 0.0;
    for (k = 0; k < segs; k = k + 1)
      g = g + 1.0 / (r * segs);
    if (V(p, n) > 0)
      I(p, n) <+ g * V(p, n);
    else
      I(p, n) <+ g * V(p, n) * 2.0;
  end
endmodule
"""

VA_MACROS = """
`define TWO_R(x) ((x)*2)
`define EXTRA 100
`ifdef EXTRA
module m(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = 1k;
  analog I(p, n) <+ V(p, n) / (`TWO_R(r) + `EXTRA);
endmodule
`endif
"""

VA_OPV = """
module opv(p, n);
  inout p, n;
  electrical p, n;
  parameter real r = 2k;
  (* desc="branch current", units="A" *) real ibr;
  analog begin
    ibr = V(p, n) / r;
    I(p, n) <+ ibr;
  end
endmodule
"""


def both(src, name, build):
    """Compile `src` with both packages and build the same circuit:
    build(ct, model) -> Circuit. Returns (JAX cc, port cc on the CPU)."""
    jcc = build(jct, jcg.compile_va(src)[name]).compile()
    tcc = build(tct, tcg.compile_va(src)[name]).compile(device="cpu")
    return jcc, tcc


def assert_dc(jcc, tcc):
    js, ts = jct.dc(jcc), tct.dc(tcc)
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
    return js, ts


def assert_tran(jcc, tcc, tspan, scale, **kw):
    ref, sol = jct.tran(jcc, tspan, **kw), tct.tran(tcc, tspan, **kw)
    assert bool(ref.converged) and bool(sol.converged)
    st, rs = sol.stats, ref.stats
    assert tuple(int(v) for v in (st.naccept, st.nreject, st.nnewton)) == \
        tuple(int(v) for v in (rs.naccept, rs.nreject, rs.nnewton))
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= TRAN_TOL * scale, err
    return ref, sol


def test_va_number_suffixes():
    for s in ("1K", "2.5u", "1M", "3m", "10f", "4.7e-3", "12", "1T", "5a"):
        assert tparser.parse_va_number(s) == jparser.parse_va_number(s)
    assert tparser.parse_va_number("1M") == 1e6    # VA: M is mega


def test_parse_module_structure():
    (jm,), (tm,) = jparser.parse_va(VA_DIODE), tparser.parse_va(VA_DIODE)
    assert tm.name == jm.name == "my_diode"
    assert tm.ports == jm.ports
    assert set(tm.parameters) == set(jm.parameters) == {"is_", "n", "cj"}
    for k, p in jm.parameters.items():
        assert tm.parameters[k].default == p.default
        assert tm.parameters[k].ranges == p.ranges
    assert tm.analog == jm.analog


def test_va_resistor_dc():
    def build(ct, m):
        cir = ct.Circuit("va-r")
        cir.V("v1", "in", "0", dc=5.0)
        cir.add(m, "x1", ("in", "out"), **{"r": 1e3, "r__given": 1.0})
        cir.add(m, "x2", ("out", "0"))
        return cir
    js, ts = assert_dc(*both(VA_RESISTOR, "my_res", build))
    assert float(ts["out"]) == pytest.approx(2.5, rel=1e-9)


def test_va_rc_transient():
    def build(ct, m):
        cir = ct.Circuit("va-rc")
        cir.V("v1", "in", "0", wave=ct.Pulse(0.0, 1.0, tr=1e-9))
        cir.R("rs", "in", "a", 1e3)
        cir.add(m, "x1", ("a", "0"), **{"r": 1e9, "r__given": 1.0,
                                        "c": 1e-6, "c__given": 1.0})
        return cir
    jcc, tcc = both(VA_RC, "my_rc", build)
    _, sol = assert_tran(jcc, tcc, (0, 5e-3), 1.0, dt=5e-6)
    v = sol["a"].numpy()
    assert np.max(np.abs(v - (1.0 - np.exp(-sol.ts / 1e-3)))) < 5e-3


def test_va_diode_matches_builtin():
    def build(ct, m):
        cir = ct.Circuit("va-d")
        cir.V("v1", "in", "0", dc=5.0)
        cir.R("r1", "in", "d", 1e3)
        cir.add(m, "d1", ("d", "0"))
        return cir
    js, ts = assert_dc(*both(VA_DIODE, "my_diode", build))
    b = tct.Circuit("builtin-d")
    b.V("v1", "in", "0", dc=5.0)
    b.R("r1", "in", "d", 1e3)
    b.D("d1", "d", "0", **{"is": 1e-14})
    assert float(ts["d"]) == pytest.approx(
        float(tct.dc(b.compile(device="cpu"))["d"]), rel=1e-6)


def test_va_diode_noise():
    def build(ct, m):
        cir = ct.Circuit("va-dn")
        cir.V("v1", "in", "0", dc=5.0)
        cir.R("r1", "in", "d", 1e3)
        cir.add(m, "d1", ("d", "0"))
        return cir
    jcc, tcc = both(VA_DIODE, "my_diode", build)
    freqs = [1e3, 1e6]
    ref, sol = jct.noise(jcc, "d", freqs), tct.noise(tcc, "d", freqs)
    np.testing.assert_allclose(sol.onoise_psd, np.asarray(ref.onoise_psd),
                               rtol=DC_RTOL, atol=0)
    for name in ("d1", "r1"):
        np.testing.assert_allclose(sol.contributions[name],
                                   np.asarray(ref.contributions[name]),
                                   rtol=DC_RTOL, atol=0)
    assert sol.contributions["d1"][0] > 0


def test_va_voltage_contribution():
    def build(ct, m):
        cir = ct.Circuit("va-v")
        cir.add(m, "vs", ("a", "0"))
        cir.R("r1", "a", "0", 1e3)
        return cir
    js, ts = assert_dc(*both(VA_VSRC, "my_vsrc", build))
    assert float(ts["a"]) == pytest.approx(2.5, rel=1e-9)


def test_va_param_default_dependencies():
    def build(ct, m):
        cir = ct.Circuit("va-dep")
        cir.V("v1", "in", "0", dc=1.0)
        cir.add(m, "x1", ("in", "0"), **{"w": 4e-6, "w__given": 1.0})
        return cir
    js, ts = assert_dc(*both(VA_DEFAULTS, "defdep", build))
    assert float(ts.i("v1")) == pytest.approx(-1.0 / 25.0, rel=1e-9)


def test_va_internal_node():
    def build(ct, m):
        cir = ct.Circuit("va-int")
        cir.V("v1", "in", "0", dc=4.0)
        cir.add(m, "x1", ("in", "0"))
        return cir
    jcc, tcc = both(VA_INTERNAL, "rdiv", build)
    assert tcc.names == jcc.names
    js, ts = assert_dc(jcc, tcc)
    assert float(ts["x1#mid"]) == pytest.approx(2.0, rel=1e-9)


@pytest.mark.parametrize("sign, want", [(1.0, 1.0), (-1.0, -0.5)])
def test_va_conditionals_and_loops(sign, want):
    def build(ct, m):
        cir = ct.Circuit("cl")
        if sign > 0:
            cir.I("i1", "0", "a", dc=1e-3)
        else:
            cir.I("i1", "a", "0", dc=1e-3)
        cir.add(m, "x1", ("a", "0"))
        return cir
    js, ts = assert_dc(*both(VA_CONDLOOP, "condloop", build))
    assert float(ts["a"]) == pytest.approx(want, rel=1e-6)


def test_va_preprocessor_macros():
    def build(ct, m):
        cir = ct.Circuit("pp")
        cir.V("v1", "a", "0", dc=2.1)
        cir.add(m, "x1", ("a", "0"))
        return cir
    js, ts = assert_dc(*both(VA_MACROS, "m", build))
    assert float(ts.i("v1")) == pytest.approx(-2.1 / 2100.0, rel=1e-9)


def test_va_opvars():
    """The VA case of tests/test_opinfo.py."""
    def build(ct, m):
        cir = ct.Circuit("vaop")
        cir.V("v1", "a", "0", dc=4.0)
        cir.add(m, "x1", ("a", "0"))
        return cir
    js, ts = assert_dc(*both(VA_OPV, "opv", build))
    jo, to = js.op_info("x1"), ts.op_info("x1")
    assert set(to) == set(jo) == {"ibr"}
    assert to["ibr"] == pytest.approx(float(jo["ibr"]), rel=DC_RTOL)
    assert to["ibr"] == pytest.approx(2e-3, rel=1e-9)
    jc, tc = js.currents("x1"), ts.currents("x1")
    for k in jc:
        assert tc[k] == pytest.approx(float(jc[k]), rel=DC_RTOL)


# a = 0 with b < 1, b = 1 and b > 1; a < 0 with an integer and a
# fractional b; and an ordinary point
POW_CASES = [(0.0, 0.5), (0.0, 1.0), (0.0, 2.5), (-2.0, 3.0), (-2.0, 0.5),
             (1.5, 2.0)]


@pytest.mark.parametrize("a, b", POW_CASES)
def test_safe_pow_matches_jax(a, b):
    """Value, the jvp in each argument and the reverse derivative of that
    tangent (the nesting the assembler runs: jacrev over the ddt jvp)."""
    def t(x):
        return torch.tensor(x, dtype=torch.float64)

    one = t(1.0)

    def same(got, want):
        got, want = float(got), float(want)
        assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(
            want, rel=1e-14, abs=1e-300), (got, want)

    same(tcg._safe_pow(t(a), t(b)), jcg._safe_pow(a, b))
    for arg in (0, 1):
        def jf(x, arg=arg):
            return jcg._safe_pow(x, b) if arg == 0 else jcg._safe_pow(a, x)

        def tf(x, arg=arg):
            return tcg._safe_pow(x, t(b)) if arg == 0 \
                else tcg._safe_pow(t(a), x)

        x0 = (a, b)[arg]
        _, jt = jax.jvp(jf, (x0,), (1.0,))
        _, tt = torch.func.jvp(tf, (t(x0),), (one,))
        same(tt, jt)
        jg = jax.grad(lambda x: jax.jvp(jf, (x,), (1.0,))[1])(x0)
        tg = torch.func.grad(
            lambda x: torch.func.jvp(tf, (x,), (one,))[1])(t(x0))
        same(tg, jg)


def test_compile_errors_match_jax():
    """A circular parameter default fails at compile time, and an unknown
    function at the first evaluation, with the JAX package's message."""
    circ = """
module circ(p, n);
  inout p, n; electrical p, n;
  parameter real a = b;
  parameter real b = a;
  analog I(p, n) <+ V(p, n) / a;
endmodule
"""
    msgs = []
    for cg in (jcg, tcg):
        with pytest.raises(cg.VACompileError) as e:
            cg.compile_va(circ)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "circular" in msgs[0]
    unknown = """
module unk(p, n);
  inout p, n; electrical p, n;
  analog I(p, n) <+ frobnicate(V(p, n));
endmodule
"""
    msgs = []
    for ct, cg, kw in ((jct, jcg, {}), (tct, tcg, {"device": "cpu"})):
        cir = ct.Circuit("unk")
        cir.V("v1", "a", "0", dc=1.0)
        cir.add(cg.compile_va(unknown)["unk"], "x1", ("a", "0"))
        with pytest.raises(cg.VACompileError) as e:
            ct.dc(cir.compile(**kw))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "frobnicate" in msgs[0]


def test_absdelay_is_refused_at_assembly():
    """absdelay is no longer refused: the compiler sets the delay probe,
    the assembler takes the model, and at DC the delay is the identity,
    as in the JAX package (the transient and AC cases are in
    tests/test_torch_delay.py)."""
    src = """
module dly(p, n, c);
  inout p, n, c; electrical p, n, c;
  analog V(p, n) <+ absdelay(V(c), 1n);
endmodule
"""
    sols = []
    for ct, cg, kw in ((jct, jcg, {}), (tct, tcg, {"device": "cpu"})):
        m = cg.compile_va(src)["dly"]
        assert m.n_delay_sites == 1 and m.delay_probe is not None
        cir = ct.Circuit("dly")
        cir.V("v1", "c", "0", dc=1.0)
        cir.add(m, "x1", ("o", "0", "c"))
        cir.R("r1", "o", "0", 1e3)
        sols.append(ct.dc(cir.compile(**kw)))
    js, ts = sols
    assert bool(ts.converged) and int(ts.iters) == int(js.iters)
    assert float(ts["o"]) == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
