"""The DFF of models/dff.py on ekv26 instances (chip_smoke.py's
`ekv_dff_netlist`, the EKV model of models/ekv.py loaded by `.hdl`)
through the port against the JAX package over the first two clock edges,
0-120 ns: accepted, rejected and Newton counts exactly, q within
1e-9 x 5 V. The port's dense solve is Gauss-Jordan (`gauss`), so the
operating point, whose homotopy is long enough for the last bits to move
a count, is held against the JAX package's `gauss` solve (its CPU default
is `lu64`). Runs on the CPU."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.mna.newton import make_dc_solver as jax_dc_solver
from cadnip_tpu_torch.models.ekv import EKV_VA

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (ekv_dff_netlist)

DC_RTOL, DC_ATOL = 1e-10, 1e-15
TRAN_TOL = 1e-9
SPAN = (0, 1.2e-7)     # the first two clock edges (clkn at 50 and 100 ns)


def counts(st):
    return tuple(int(v) for v in (st.naccept, st.nreject, st.nnewton))


def test_ekv_dff_first_two_edges(tmp_path):
    path = tmp_path / "ekv26.va"
    path.write_text(EKV_VA)
    net = chip_smoke.ekv_dff_netlist(str(path))
    jcc = jct.parse_spice(net)
    tcc = tct.parse_spice(net, device="cpu")
    assert [(g.model.name, g.n_inst) for g in tcc.groups] == \
        [(g.model.name, g.n_inst) for g in jcc.groups] == \
        [("vsource", 4), ("va:ekv26", 26), ("capacitor", 35)]
    sol = tct.tran(tcc, SPAN, dt=3.333e-10)
    ref = jct.tran(jcc, SPAN, dt=3.333e-10)
    assert bool(sol.converged) and bool(ref.converged)
    assert counts(sol.stats) == counts(ref.stats)
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= TRAN_TOL * 5.0, err
    # the operating point, against the JAX package's Gauss-Jordan chain
    jdc = jax.jit(jax_dc_solver(jcc, method="gauss"))(
        jnp.zeros(jcc.n), jcc.params0(),
        jcc.spec.dyn(mode=jct.mna.spec.MODE_TRANOP))
    assert bool(jdc.converged) and int(sol.op_iters) == int(jdc.iters)
    np.testing.assert_allclose(sol.xs[0].numpy(), np.asarray(jdc.x),
                               rtol=DC_RTOL, atol=DC_ATOL)
    # both clock edges have passed, the data is still low: q holds 0
    q = sol["q"].numpy()
    assert np.isfinite(q).all() and q.max() < 1.0


def test_jax_holds_the_chip_gate_over_300ns(tmp_path):
    """The gate of chip_smoke.py's phase 12 on the reference: the JAX
    package on the CPU, over the card's span (0-300 ns), converges with
    the step counts the card run reproduces and holds q below 1 V at
    290 ns (the data rose at 200 ns; no clock edge latches it before
    400 ns)."""
    path = tmp_path / "ekv26.va"
    path.write_text(EKV_VA)
    jcc = jct.parse_spice(chip_smoke.ekv_dff_netlist(str(path)))
    ref = jct.tran(jcc, (0, chip_smoke.EKV_SPAN), dt=chip_smoke.EKV_DT)
    assert bool(ref.converged)
    assert counts(ref.stats) == (437, 63, 912)
    ts, q = np.asarray(ref.ts), np.asarray(ref["q"])
    assert np.isfinite(q).all()
    assert q[np.argmin(np.abs(ts - chip_smoke.EKV_LOW_AT))] < 1.0


def test_jax_latches_over_the_full_span(tmp_path):
    """The EKV DFF latches on the reference as the level-1 DFF does
    (chip_smoke.py phase 9's gate): over 0-600 ns q is below 1 V at 350
    ns (d rose at 200 ns, no clock edge has latched it) and above 4 V at
    550 ns (latched by the edge at 400 ns)."""
    path = tmp_path / "ekv26.va"
    path.write_text(EKV_VA)
    jcc = jct.parse_spice(chip_smoke.ekv_dff_netlist(str(path)))
    ref = jct.tran(jcc, (0, 6e-7), dt=chip_smoke.EKV_DT)
    assert bool(ref.converged)
    assert counts(ref.stats) == (1016, 156, 2203)
    ts, q = np.asarray(ref.ts), np.asarray(ref["q"])
    assert np.isfinite(q).all()
    assert q[np.argmin(np.abs(ts - 350e-9))] < 1.0
    assert q[np.argmin(np.abs(ts - 550e-9))] > 4.0
