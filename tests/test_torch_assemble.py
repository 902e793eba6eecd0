"""Assembly of the port (cadnip_tpu_torch/mna/assemble.py) against the JAX
package's `make_assembler` on the DFF: F, Q, G, C and the new limiter state
at random states near the operating point, with the parameters carried
across by `params_from_numpy`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
from cadnip_tpu.mna.assemble import make_assembler as jax_assembler
from cadnip_tpu.mna.assemble import make_rhs_assembler as jax_rhs
from cadnip_tpu.mna.assemble import pad_state as jax_pad
from cadnip_tpu.mna.spec import make_dynspec as jax_dynspec
from cadnip_tpu.models.dff import dff_netlist
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.mna.assemble import (make_assembler,
                                           make_rhs_assembler, pad_state)
from cadnip_tpu_torch.mna.spec import MODE_TRAN, make_dynspec

torch.set_num_threads(1)
NSTATES = 8


@pytest.fixture(scope="module")
def dff():
    jcc = jct.parse_spice(dff_netlist())
    tcc = tct.parse_spice(dff_netlist(), device="cpu")
    pnp = [jax.tree.map(np.asarray, d) for d in jcc.params0()]
    x_op = np.array(jct.op_tran(jcc).x)
    return jcc, tcc, pnp, x_op


def _states(x_op, n_lim, conn_cat, seed):
    rng = np.random.default_rng(seed)
    xs = x_op + rng.normal(0.0, 0.3, (NSTATES, x_op.size))
    lims = []
    for x in xs:
        xp = np.append(x, 0.0)
        lims.append(xp[conn_cat] + rng.normal(0.0, 0.2, n_lim))
    times = rng.uniform(0.0, 6e-7, NSTATES)
    return xs, np.stack(lims), times


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-18)


def test_dff_assembly_matches_jax(dff):
    jcc, tcc, pnp, x_op = dff
    jasm = jax_assembler(jcc)
    tasm = make_assembler(tcc)
    conn_cat = np.concatenate([g.conn.reshape(-1) for g in jcc.groups
                               if g.model.limit is not None])
    assert tasm.n_lim == jasm.n_lim == conn_cat.size
    xs, lims, times = _states(x_op, tasm.n_lim, conn_cat, 0)
    jp = jax.tree.map(jnp.asarray, pnp)
    jrun = jax.jit(lambda x, l, t: jasm(jax_pad(x), l, jp, jax_dynspec(
        time=t, mode=MODE_TRAN)))
    tp = params_from_numpy(pnp, device="cpu")
    # all states at once as lanes of one batched assembly
    got = tasm(pad_state(torch.as_tensor(xs)), torch.as_tensor(lims), tp,
               make_dynspec(mode=MODE_TRAN, device="cpu")._replace(
                   time=torch.as_tensor(times)))
    for k in range(NSTATES):
        ref = jrun(jnp.asarray(xs[k]), jnp.asarray(lims[k]), times[k])
        for a, b in zip(got, ref):
            _close(a[k].numpy(), np.asarray(b))


def test_dff_rhs_and_init_lim_match_jax(dff):
    jcc, tcc, pnp, x_op = dff
    xs = x_op + np.random.default_rng(1).normal(0.0, 0.3, (NSTATES,
                                                         x_op.size))
    jrhs, trhs = jax_rhs(jcc), make_rhs_assembler(tcc)
    jp = jax.tree.map(jnp.asarray, pnp)
    F, Q = trhs(pad_state(torch.as_tensor(xs)),
                params_from_numpy(pnp, device="cpu"),
                make_dynspec(mode=MODE_TRAN, time=1e-7, device="cpu"))
    lim = make_assembler(tcc).init_lim(pad_state(torch.as_tensor(xs)))
    jinit = jax_assembler(jcc).init_lim
    for k in range(NSTATES):
        jF, jQ = jrhs(jax_pad(jnp.asarray(xs[k])), jp,
                      jax_dynspec(mode=MODE_TRAN, time=1e-7))
        _close(F[k].numpy(), np.asarray(jF))
        _close(Q[k].numpy(), np.asarray(jQ))
        np.testing.assert_array_equal(
            lim[k].numpy(), np.asarray(jinit(jax_pad(jnp.asarray(xs[k])))))


def test_gshunt_lands_on_node_diagonals(dff):
    _, tcc, _, x_op = dff
    asm = make_assembler(tcc)
    xp = pad_state(torch.as_tensor(x_op)[None])
    lim = asm.init_lim(xp)
    p = tcc.params0()
    d0 = make_dynspec(mode=MODE_TRAN, device="cpu")
    F0, _, G0, _, _ = asm(xp, lim, p, d0)
    F1, _, G1, _, _ = asm(xp, lim, p, d0._replace(
        gshunt=torch.tensor(1e-3, dtype=torch.float64)))
    vnode = torch.as_tensor(tcc.classes == 0)
    dG = torch.diagonal(G1 - G0, dim1=1, dim2=2)[0]
    # (G + gshunt) - G: exact up to the rounding of the addition
    assert torch.allclose(dG[vnode], torch.full_like(dG[vnode], 1e-3),
                          rtol=1e-12, atol=0)
    assert torch.equal(dG[~vnode], torch.zeros_like(dG[~vnode]))
    assert torch.allclose((F1 - F0)[0, vnode], 1e-3 * xp[0, :-1][vnode])
