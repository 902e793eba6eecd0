"""DC sensitivities of the port (cadnip_tpu_torch/analyses/sensitivity.py)
against the JAX package's `dc_sensitivity`, on the same parameters: the
divider (with its hand math), a diode and the DFF operating point."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses.sensitivity import \
    dc_sensitivity as jax_dc_sensitivity
from cadnip_tpu.mna.spec import MODE_TRANOP
from cadnip_tpu.models.dff import dff_netlist as jax_dff_netlist

torch.set_num_threads(1)


def _on_cpu(ct):
    """The keyword that puts a circuit of the port on the host; the JAX
    package takes none."""
    return {"device": "cpu"} if ct is tct else {}


def _divider(ct):
    cir = ct.Circuit("div")
    cir.V("v1", "in", "0", dc=5.0)
    cir.R("r1", "in", "out", 1e3)
    cir.R("r2", "out", "0", 1e3)
    return cir.compile(**_on_cpu(ct))


def _diode(ct):
    cir = ct.Circuit("dsens")
    cir.V("v1", "in", "0", dc=5.0)
    cir.R("r1", "in", "d", 1e3)
    cir.D("d1", "d", "0", **{"is": 1e-14})
    return cir.compile(**_on_cpu(ct))


def _dff(ct):
    return ct.parse_spice(jax_dff_netlist() if ct is jct
                          else tct.dff_netlist(), **_on_cpu(ct))


CASES = {"divider": (_divider, ["r2.r", "r1.r"], {}),
         "diode": (_diode, ["r1.r", "d1.is", "d1.n"], {}),
         "dff": (_dff, ["mno1.w", "cq.c"], dict(mode=MODE_TRANOP))}


@pytest.mark.parametrize("case", list(CASES))
def test_dc_sensitivity_matches_jax(case):
    build, names, kw = CASES[case]
    ref = jax_dc_sensitivity(build(jct), names, **kw)
    got = tct.dc_sensitivity(build(tct), names, **kw)
    assert list(got) == names
    for nm in names:
        r = np.asarray(ref[nm])
        g = got[nm].numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=1e-10,
                                   atol=1e-10 * np.abs(r).max() + 1e-300)
    if case == "divider":
        cc = build(tct)
        i_out = cc.index_of("out")
        # vout = 5 r2/(r1+r2): dv/dr2 = 5 r1/(r1+r2)^2 = -dv/dr1; a source
        # value ('v1.dc', which the JAX function does not address) gives
        # dv/dv1 = r2/(r1+r2)
        assert float(got["r2.r"][i_out]) == pytest.approx(5e3 / 4e6,
                                                          rel=1e-12)
        assert float(got["r1.r"][i_out]) == pytest.approx(-5e3 / 4e6,
                                                          rel=1e-12)
        dv = tct.dc_sensitivity(cc, "v1.dc")["v1.dc"]
        assert float(dv[i_out]) == pytest.approx(0.5, rel=1e-12)
