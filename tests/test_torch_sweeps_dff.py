"""bench.py's DFF Monte Carlo (`bench_dff_sweep`: the 4096-way table of
`montecarlo_table` over cq.c, mno1.w and mpo1.w, seed 42) on four of its
lanes through the port's `transweep`, against the JAX package's."""
import numpy as np
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.models.dff import dff_netlist as jax_dff_netlist
from cadnip_tpu_torch.analyses import sweeps as tsw

torch.set_num_threads(1)
DFF_SPREADS = {"cq.c": 0.1, "mno1.w": 0.1, "mpo1.w": 0.1}   # bench.py:381


def test_dff_montecarlo_lanes_match_jax():
    # bench.py's 4096-way table, four of its lanes over 0-30 ns
    jcc = jct.parse_spice(jax_dff_netlist())
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    lanes = [0, 1, 2047, 4095]
    tab = {k: v[lanes] for k, v in tct.montecarlo_table(
        tcc, DFF_SPREADS, 4096, seed=42).items()}
    # only the swept leaves gain the lane axis; waveform tables stay shared
    bp = tsw.batch_params(tcc, tab)
    for gi, (d, d0) in enumerate(zip(bp, tcc.params0())):
        for k, v in d.items():
            if isinstance(v, dict):
                assert all(v[kk].shape == d0[k][kk].shape for kk in v)
            elif k in ("w", "c"):
                assert v.shape == (4,) + d0[k].shape
            else:
                assert v.shape == d0[k].shape
    kw = dict(dt=3.333e-10, max_steps=20000, n_save=61)
    ref = jct.transweep(jcc, tab, (0, 3e-8), **kw)
    sol = tct.transweep(tcc, tab, (0, 3e-8), **kw)
    assert sol.converged.all()
    for field in ("naccept", "nreject", "nnewton", "fail"):
        np.testing.assert_array_equal(getattr(sol.stats, field).numpy(),
                                      np.asarray(getattr(ref.stats, field)))
    np.testing.assert_array_equal(sol.op_converged.numpy(),
                                  np.asarray(ref.op_converged))
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(ref.xs), rtol=0,
                               atol=1e-9 * 5.0)
