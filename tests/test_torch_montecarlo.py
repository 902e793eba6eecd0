"""Netlist-level Monte Carlo of the port (`montecarlo_elaborate`, the
statistical functions of frontend/elaborate.py) and forward-mode
derivatives through its transient, against the JAX package
(tests/test_montecarlo.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.frontend.elaborate import \
    montecarlo_elaborate as jax_montecarlo_elaborate
from cadnip_tpu.mna.newton import make_dc_solver as jax_dc_solver
from cadnip_tpu_torch.frontend.elaborate import (elaborate_netlist,
                                                 montecarlo_elaborate)

torch.set_num_threads(1)
NETLIST = """mc divider
.param rnom=1k
.param r1v={agauss(rnom, 100)}
.param r2v={gauss(rnom, 0.1)}
.param vv={aunif(5, 0.5)}
.param r3v={unif(rnom, 0.2)}
v1 in 0 {vv}
r1 in out {r1v}
r2 out 0 {r2v}
r3 out 0 {r3v}
"""


def test_statistical_functions_are_nominal_without_rng():
    cc = tct.parse_spice(NETLIST, device="cpu")
    sol = tct.dc(cc)
    assert float(sol["out"]) == pytest.approx(5.0 / 3.0, rel=1e-12)
    cir, _ = elaborate_netlist(NETLIST, rng=np.random.default_rng(0))
    r = {i.name: i.params.get("r") for i in cir.instances}
    assert r["r1"] != 1e3 and r["r2"] != 1e3 and r["r3"] != 1e3


def test_montecarlo_elaborate_matches_jax():
    jcc, jparams, axes = jax_montecarlo_elaborate(NETLIST, 16, seed=3)
    cc, params = montecarlo_elaborate(NETLIST, 16, seed=3, device="cpu")
    jp = [jax.tree.map(np.asarray, d) for d in jparams]
    assert len(params) == len(jp)
    for d, jd in zip(params, jp):
        assert sorted(d) == sorted(jd)
        for k in d:
            if isinstance(d[k], dict):
                for kk in d[k]:
                    np.testing.assert_array_equal(d[k][kk].numpy(),
                                                  jd[k][kk])
            else:
                np.testing.assert_array_equal(d[k].numpy(), jd[k])
    ref = jax.vmap(jax_dc_solver(jcc), in_axes=(None, axes, None))(
        jnp.zeros(jcc.n), jparams, jcc.spec.dyn())
    sol = tct.dc(cc, params)
    assert sol.x.shape == (16, cc.n) and sol.converged.all()
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=1e-12)
    vout = sol["out"].numpy()
    assert np.ptp(vout) > 0.05       # the samples differ


def _on_cpu(ct):
    """The keyword that puts a circuit of the port on the host; the JAX
    package takes none."""
    return {"device": "cpu"} if ct is tct else {}


def _rc(ct):
    cir = ct.Circuit("sens")
    cir.V("vs", "in", "0", wave=ct.Pulse(0.0, 1.0, tr=1e-9))
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-6)
    return cir.compile(**_on_cpu(ct))


def test_jacfwd_through_transient_matches_jax():
    # d v_out(1 ms) / d R through the whole adaptive transient
    # (tests/test_montecarlo.py::test_jacfwd_through_transient)
    jcc, cc = _rc(jct), _rc(tct)
    gi, pn, slot = jcc.param_slots["r1.r"]
    jp0 = jcc.params0()

    def jax_vout(rval):
        p = [dict(d) for d in jp0]
        p[gi] = dict(p[gi])
        p[gi][pn] = p[gi][pn].at[slot].set(rval)
        sol = jct.tran(jcc, (0, 1e-3), params=p, dt=1e-5, n_save=11)
        return sol.xs[-1, jcc.index_of("out")]

    def vout(rval):
        p = cc.alter(cc.params0(), **{"r1.r": rval})
        sol = tct.tran(cc, (0, 1e-3), params=p, dt=1e-5, n_save=11)
        return sol.xs[-1, cc.index_of("out")]

    r0 = 1e3
    ref = float(jax.jacfwd(jax_vout)(jnp.asarray(r0)))
    got = float(torch.func.jacfwd(vout)(torch.tensor(r0,
                                                     dtype=torch.float64)))
    T, C = 1e-3, 1e-6
    exact = -T / (r0 ** 2 * C) * np.exp(-T / (r0 * C))
    assert got == pytest.approx(exact, rel=5e-2)
    assert got == pytest.approx(ref, rel=1e-9)
