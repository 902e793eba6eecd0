"""Newton of the port (cadnip_tpu_torch/mna/newton.py) against the JAX
package: the transient Newton step of `__graft_entry__.entry()`, the DC
homotopy chain on the DFF, and a batched (B = 2) DC solve against two
JAX runs."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cadnip_tpu as jct
from cadnip_tpu.mna.newton import make_dc_solver as jax_dc_solver
from cadnip_tpu.mna.spec import MODE_TRANOP
from cadnip_tpu.models.dff import dff_netlist
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.mna.assemble import make_assembler
from cadnip_tpu_torch.mna.newton import make_dc_solver, make_tran_newton
from cadnip_tpu_torch.mna.spec import MODE_TRAN

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
torch.set_num_threads(1)


def _np_params(jcc):
    return [jax.tree.map(np.asarray, d) for d in jcc.params0()]


def test_graft_entry_step_matches_jax():
    import __graft_entry__ as g
    fn, args = g.entry()
    jx, jconv = jax.jit(fn)(*args)
    x0, lim0, params, dyn, c0, rhs_q = args

    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    asm = make_assembler(tcc)
    newton_t = make_tran_newton(tcc, assemble=asm)
    x = torch.as_tensor(np.array(x0))[None]
    lim = torch.as_tensor(np.array(lim0))[None]
    r = newton_t(x, lim, params_from_numpy(
        [jax.tree.map(np.asarray, d) for d in params], device="cpu"),
        tcc.spec.dyn(tcc.device, mode=MODE_TRAN, time=1e-9), float(c0),
        torch.as_tensor(np.array(rhs_q))[None])
    assert bool(r.converged[0]) == bool(jconv)
    np.testing.assert_allclose(r.x[0].numpy(), np.asarray(jx), rtol=0,
                               atol=1e-10)


def test_dff_dc_homotopy_matches_jax():
    jcc = jct.parse_spice(dff_netlist())
    jr = jax.jit(jax_dc_solver(jcc))(
        jnp.zeros(jcc.n), jcc.params0(),
        jcc.spec.dyn(mode=MODE_TRANOP, time=0.0))
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    tr = make_dc_solver(tcc)(
        torch.zeros((1, tcc.n), dtype=torch.float64),
        params_from_numpy(_np_params(jcc), device="cpu"),
        tcc.spec.dyn(tcc.device, mode=MODE_TRANOP, time=0.0))
    print(f"DFF DC Newton iterations: port {int(tr.iters[0])}, "
          f"JAX {int(jr.iters)}")
    assert bool(jr.converged) and bool(tr.converged[0])
    np.testing.assert_allclose(tr.x[0].numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-9)


def test_batched_dc_lanes_match_two_jax_runs():
    cir = jct.Circuit("vrd")
    cir.V("v1", "in", "0", dc=5.0)
    cir.R("r1", "in", "d", 1e3)
    cir.D("d1", "d", "0", **{"is": 1e-14, "cjo": 1e-12})
    jcc = cir.compile()
    rs = [1e3, 47.0]
    refs = [jct.dc(jcc, jcc.alter(jcc.params0(), **{"r1.r": r}))
            for r in rs]

    tcir = tct.Circuit("vrd")
    tcir.V("v1", "in", "0", dc=5.0)
    tcir.R("r1", "in", "d", 1e3)
    tcir.D("d1", "d", "0", **{"is": 1e-14, "cjo": 1e-12})
    tcc = tcir.compile(device="cpu")
    params = tcc.alter(params_from_numpy(_np_params(jcc), device="cpu"),
                       **{"r1.r": rs})
    sol = tct.dc(tcc, params)
    assert sol.x.shape == (2, tcc.n)
    assert sol.converged.tolist() == [True, True]
    for k, ref in enumerate(refs):
        np.testing.assert_allclose(sol.x[k].numpy(), np.asarray(ref.x),
                                   rtol=1e-10, atol=1e-15)
        assert int(sol.iters[k]) == int(ref.iters)
