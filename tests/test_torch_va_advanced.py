"""The port's advanced Verilog-A operators against the JAX package's, case
for case with tests/test_va_advanced.py: `$table_model` (1-D and 2-D),
laplace_nd filters in AC and in the transient, module hierarchy, and
`$limit` on a stiff diode chain. Also the host-setup route: a module whose
setup pass has at least 150 statements hoists it (`va_setup`), so both
packages compute `__setup__` at the solver entry (`ensure_setup`) and
take central-difference Jacobians; its DC and a short transient are held
against JAX. Tolerances as in tests/test_torch_va.py; every port call
runs on the CPU."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.va import codegen as jcg
from cadnip_tpu_torch.va import codegen as tcg

torch.set_num_threads(1)

DC_RTOL, DC_ATOL = 1e-10, 1e-15
TRAN_TOL = 1e-9


def both(src, name, build):
    jm, tm = jcg.compile_va(src)[name], tcg.compile_va(src)[name]
    return (build(jct, jm).compile(),
            build(tct, tm).compile(device="cpu"))


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


def test_table_model_1d(tmp_path):
    tbl = tmp_path / "r.tbl"
    vs = np.linspace(-2, 2, 41)
    tbl.write_text("\n".join(f"{v} {v**3}" for v in vs))
    src = f"""
module tabres(p, n);
  inout p, n; electrical p, n;
  analog I(p, n) <+ $table_model(V(p, n), "{tbl}");
endmodule
"""

    def build(ct, m):
        cir = ct.Circuit("tab")
        cir.V("v1", "a", "0", dc=1.2)
        cir.add(m, "x1", ("a", "0"))
        return cir
    js, ts = assert_dc(*both(src, "tabres", build))
    assert float(ts.i("v1")) == pytest.approx(-(1.2 ** 3), rel=1e-2)


def test_table_model_2d(tmp_path):
    tbl = tmp_path / "g.tbl"
    rows = [f"{x} {y} {2*x + 3*y}" for x in np.linspace(0, 2, 11)
            for y in np.linspace(0, 1, 6)]
    tbl.write_text("\n".join(rows))
    src = f"""
module tab2(p, n, c);
  inout p, n, c; electrical p, n, c;
  analog I(p, n) <+ $table_model(V(p, n), V(c), "{tbl}") * 1e-3;
endmodule
"""

    def build(ct, m):
        cir = ct.Circuit("tab2")
        cir.V("v1", "a", "0", dc=1.5)
        cir.V("vc", "c", "0", dc=0.5)
        cir.add(m, "x1", ("a", "0", "c"))
        return cir
    js, ts = assert_dc(*both(src, "tab2", build))
    assert float(ts.i("v1")) == pytest.approx(-(2 * 1.5 + 3 * 0.5) * 1e-3,
                                              rel=1e-6)


def _lowpass(w0, name):
    return f"""
module {name}(p, n, ctl);
  inout p, n, ctl; electrical p, n, ctl;
  analog V(p, n) <+ laplace_nd(V(ctl), {{1.0}}, {{1.0, {1.0/w0}}});
endmodule
"""


def test_laplace_nd_lowpass():
    w0 = 2 * np.pi * 1e3

    def build(ct, m):
        cir = ct.Circuit("lp")
        cir.V("vs", "in", "0", dc=0.0, acmag=1.0)
        cir.add(m, "f1", ("out", "0", "in"))
        cir.R("rl", "out", "0", 1e6)
        return cir
    jcc, tcc = both(_lowpass(w0, "lp1"), "lp1", build)
    freqs = np.array([1e2, 1e3, 1e4])
    h, hj = tct.ac(tcc, freqs)["out"], np.asarray(jct.ac(jcc, freqs)["out"])
    np.testing.assert_allclose(h, hj, rtol=DC_RTOL, atol=0)
    np.testing.assert_allclose(h, 1.0 / (1.0 + 1j * 2 * np.pi * freqs / w0),
                               rtol=1e-6)


def test_laplace_transient_step():
    w0 = 1e6

    def build(ct, m):
        cir = ct.Circuit("lps")
        cir.V("vs", "in", "0", wave=ct.Pulse(0.0, 1.0, tr=1e-9))
        cir.add(m, "f1", ("out", "0", "in"))
        cir.R("rl", "out", "0", 1e6)
        return cir
    jcc, tcc = both(_lowpass(w0, "lp2"), "lp2", build)
    _, sol = assert_tran(jcc, tcc, (0, 5e-6), 1.0, dt=5e-9)
    v = sol["out"].numpy()
    assert np.max(np.abs(v - (1.0 - np.exp(-w0 * sol.ts)))) < 5e-3


def test_va_module_hierarchy():
    src = """
module res(p, n);
  inout p, n; electrical p, n;
  parameter real r = 1k;
  analog I(p, n) <+ V(p, n) / r;
endmodule

module divider(hi, lo, mid);
  inout hi, lo, mid; electrical hi, lo, mid;
  parameter real rtop = 1k;
  res #(.r(rtop)) rt(hi, mid);
  res #(.r(3k)) rb(mid, lo);
endmodule
"""

    def build(ct, m):
        cir = ct.Circuit("vah")
        cir.V("v1", "in", "0", dc=4.0)
        cir.add(m, "x1", ("in", "0", "m"))
        return cir
    js, ts = assert_dc(*both(src, "divider", build))
    assert float(ts["m"]) == pytest.approx(3.0, rel=1e-9)


def test_va_hierarchy_internal_nodes():
    src = """
module halfpi(a, b);
  inout a, b; electrical a, b, mid;
  analog begin
    I(a, mid) <+ V(a, mid) / 100;
    I(mid, b) <+ V(mid, b) / 300;
  end
endmodule

module two(x, y);
  inout x, y; electrical x, y, j;
  halfpi u1(x, j);
  halfpi u2(j, y);
endmodule
"""

    def build(ct, m):
        cir = ct.Circuit("vah2")
        cir.V("v1", "in", "0", dc=8.0)
        cir.add(m, "x1", ("in", "0"))
        return cir
    jcc, tcc = both(src, "two", build)
    assert tcc.names == jcc.names
    js, ts = assert_dc(jcc, tcc)
    assert float(ts["x1#j"]) == pytest.approx(4.0, rel=1e-9)
    assert float(ts["x1#u1_mid"]) == pytest.approx(8 - 8 * 100 / 800,
                                                   rel=1e-9)


def test_va_dollar_limit_accelerates_convergence():
    src = """
module vadiode_lim(a, c);
  inout a, c; electrical a, c;
  parameter real is_ = 1e-15;
  analog I(a, c) <+ is_ * (limexp($limit(V(a, c), "pnjlim", $vt, 0.7)
                                  / $vt) - 1.0);
endmodule
"""
    tm = tcg.compile_va(src)["vadiode_lim"]
    assert tm.residual_lim is not None and tm.n_lim_sites == 1
    assert tm.lim_branches == jcg.compile_va(src)["vadiode_lim"].lim_branches

    def build(ct, m):
        cir = ct.Circuit("valim")
        cir.V("v1", "in", "0", dc=30.0)
        prev = "in"
        for k in range(10):
            cir.add(m, f"d{k}", (prev, f"n{k}"))
            prev = f"n{k}"
        cir.R("rl", prev, "0", 10.0)
        return cir
    jcc, tcc = both(src, "vadiode_lim", build)
    js, ts = assert_dc(jcc, tcc)
    assert 0.0 < float(ts["n4"]) < 30.0
    # the limiter state is seeded per branch, one per instance
    from cadnip_tpu_torch.mna.assemble import make_assembler, pad_state
    asm = make_assembler(tcc)
    assert asm.n_lim == 10
    xp = pad_state(ts.x[None])
    np.testing.assert_array_equal(
        asm.init_lim(xp)[0].numpy(),
        [float(ts.v(a, b)) for a, b in
         zip(["in"] + [f"n{k}" for k in range(9)],
             [f"n{k}" for k in range(10)])])


def setup_heavy_va(n_stmts=160):
    """A junction with a series conductance and a charge whose conductance
    comes out of a chain of `n_stmts` parameter-only statements: enough
    for the compiler to hoist its setup pass (150 or more)."""
    chain = ["    t0 = gs;"] + [
        f"    t{k} = t{k - 1} * (1.0 + 1e-4 * {k % 7}) / (1.0 + 1e-4 * "
        f"{k % 5});" for k in range(1, n_stmts)]
    decl = ", ".join(f"t{k}" for k in range(n_stmts))
    return f"""
module heavy(a, c);
  inout a, c; electrical a, c, m;
  parameter real gs = 1e-2;
  parameter real is_ = 1e-14;
  parameter real cj = 1e-12;
  real {decl};
  analog begin
{chr(10).join(chain)}
    I(a, m) <+ t{n_stmts - 1} * V(a, m);
    I(m, c) <+ is_ * (limexp(V(m, c) / $vt) - 1.0) + ddt(cj * V(m, c));
  end
endmodule
"""


def test_host_setup_route_matches_jax(tmp_path):
    src = setup_heavy_va()
    tm = tcg.compile_va(src)["heavy"]
    assert tm.va_setup is not None and tm.va_specialize is not None
    path = tmp_path / "heavy.va"
    path.write_text(src)
    net = """heavy junction
vs in 0 dc 0 pulse 0 2 1n 1n 1n 20n 50n
rs in a 100
n1 a 0 heavy gs=2e-2
n2 a 0 heavy
.end
"""
    jcc = jct.parse_spice(net, hdl=str(path))
    tcc = tct.parse_spice(net, hdl=str(path), device="cpu")
    p = tct.mna.assemble.ensure_setup(tcc, tcc.params0())
    gi = next(i for i, g in enumerate(tcc.groups)
              if g.model.name == "va:heavy")
    assert p[gi]["__setup__"].shape[0] == 2
    np.testing.assert_allclose(
        p[gi]["__setup__"].numpy(),
        np.asarray(jct.mna.assemble.ensure_setup(jcc, jcc.params0())
                   [gi]["__setup__"]), rtol=1e-12, atol=0)
    p2 = tcc.alter(tcc.params0(), **{"vs.dc": 1.0})
    js = jct.dc(jcc, jcc.alter(jcc.params0(), **{"vs.dc": 1.0}))
    ts = tct.dc(tcc, p2)
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
    assert "__setup__" in ts.params[gi]
    assert_tran(jcc, tcc, (0, 1e-7), 2.0, dt=5e-10)
