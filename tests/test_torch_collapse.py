"""Verilog-A node collapse in the port against the JAX package, case for
case with tests/test_collapse.py: a `V(a,b) <+ 0` branch whose guard holds
for an instance's parameters merges its internal node into the target (a
terminal, another internal, or ground) at elaboration, instead of a
constraint row and a branch current. Both packages elaborate the same
deck; the unknown counts, the group structure and the DC solution (node
voltages to 1e-10 relative, Newton counts equal) must agree.

Also `va_specialize`: two instances of one module whose overrides give
different collapse signatures fall into two groups, as in JAX. Every port
call runs on the CPU."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.va.codegen import compile_va as jcompile_va

torch.set_num_threads(1)

DC_RTOL, DC_ATOL = 1e-10, 1e-15

VA = """
`include "disciplines.vams"
module res2(a, b);
  inout a, b;
  electrical a, b, m;
  parameter real r1 = 1k;
  parameter real r2 = 0;
  analog begin
    I(a, m) <+ V(a, m) / r1;
    if (r2 == 0)
      V(m, b) <+ 0;
    else
      I(m, b) <+ V(m, b) / r2;
  end
endmodule

module shnt(a);
  inout a;
  electrical a, x;
  parameter real r = 1k;
  parameter real en = 0;
  analog begin
    I(a, x) <+ V(a, x) / r;
    if (en == 0)
      V(x) <+ 0;
    else
      I(x) <+ V(x) * 1e-3;
  end
endmodule
"""


@pytest.fixture()
def va_path(tmp_path):
    p = tmp_path / "col.va"
    p.write_text(VA)
    return str(p)


def groups(cc):
    return [(g.model.name, g.n_inst, np.asarray(g.conn).tolist())
            for g in cc.groups]


def both_dc(net):
    """The deck through both packages: equal structure, equal DC."""
    jcc = jct.parse_spice(net)
    tcc = tct.parse_spice(net, device="cpu")
    assert tcc.n == jcc.n
    assert groups(tcc) == groups(jcc)
    js, ts = jct.dc(jcc), tct.dc(tcc)
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
    return tcc, ts


def test_pair_collapse_merges_nodes(va_path):
    cc, sol = both_dc(f"""collapse pair
.hdl "{va_path}"
v1 in 0 dc 3
x1 in out res2 r1=1k
r1 out 0 2k
""")
    # collapsed: in, out and v1's branch current only
    assert cc.n == 3
    assert float(sol["out"]) == pytest.approx(2.0, rel=1e-9)
    # the merged internal is still addressable, aliased to its target
    assert float(sol["x1#m"]) == float(sol["out"])


def test_no_collapse_when_param_disables(va_path):
    cc, sol = both_dc(f"""no collapse
.hdl "{va_path}"
v1 in 0 dc 3
x1 in out res2 r1=1k r2=2k
r1 out 0 3k
""")
    # m survives, with the open switch-branch current of the untaken arm
    assert cc.n == 5
    assert float(sol["out"]) == pytest.approx(1.5, rel=1e-9)


def test_mixed_instances_split_groups(va_path):
    cc, sol = both_dc(f"""mixed
.hdl "{va_path}"
v1 in 0 dc 3
x1 in a res2 r1=1k
ra a 0 2k
x2 in b res2 r1=1k r2=2k
rb b 0 3k
""")
    assert float(sol["a"]) == pytest.approx(2.0, rel=1e-9)
    assert float(sol["b"]) == pytest.approx(1.5, rel=1e-9)


def test_ground_collapse(va_path):
    cc, sol = both_dc(f"""collapse to ground
.hdl "{va_path}"
i1 0 in dc 1m
x1 in shnt r=1k
""")
    assert cc.n == 1
    assert float(sol["in"]) == pytest.approx(1.0, rel=1e-9)


def test_ground_collapse_disabled(va_path):
    _, sol = both_dc(f"""shunt kept
.hdl "{va_path}"
i1 0 in dc 1m
x1 in shnt r=1k en=1
""")
    # 1 mA through r, then the 1e-3 S shunt: V(x) = 1 V, V(in) = 2 V
    assert float(sol["in"]) == pytest.approx(2.0, rel=1e-9)


def test_va_specialize_groups_by_collapse_signature():
    """Instances added through the Circuit API with overrides that give
    different collapse signatures: each signature is its own model and
    group, with its own internals, in both packages."""
    jm = jcompile_va(VA)["res2"]
    tm = tct.compile_va(VA)["res2"]
    assert jm.va_specialize is not None and tm.va_specialize is not None
    built = []
    for pkg, model in ((jct, jm), (tct, tm)):
        cir = pkg.Circuit("specialize")
        cir.V("v1", "in", "0", dc=3.0)
        for k, r2 in enumerate((0.0, 2e3, 0.0, 5e3)):
            # the overrides as the front end passes them, masks included
            kw = {"r2": r2, "r2__given": 1.0}
            cir.add(model.va_specialize(kw), f"x{k}", ("in", f"o{k}"), **kw)
            cir.R(f"r{k}", f"o{k}", "0", 1e3 * (k + 1))
        built.append(cir)
    jcc = built[0].compile()
    tcc = built[1].compile(device="cpu")
    va = [(n, i) for n, i, _ in groups(tcc) if n.startswith("va:")]
    assert len(va) == 2 and sorted(i for _, i in va) == [2, 2]
    assert groups(tcc) == groups(jcc) and tcc.n == jcc.n
    # one signature merges m into b, the other keeps it
    assert sorted(len(g.model.collapses) for g in tcc.groups
                  if g.model.name.startswith("va:")) == [0, 1]
    js, ts = jct.dc(jcc), tct.dc(tcc)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
