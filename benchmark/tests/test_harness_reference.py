"""The plain reference against the program on short CPU cases of each
configuration: the test's own comparison. (The reference itself imports
nothing of the program; this test imports both.)"""
import numpy as np

import cadnip_tpu_torch as ct
from benchmark.core import check as chk
from benchmark.core import traffic as tf
from benchmark.reference import mna, netlist

SEED = 2 ** 31 + 4242


def _ref_x(cir, cc, x):
    return chk.to_reference(cir, cc.names, x.numpy())


def test_dff_operating_point_equals_the_programs():
    cfg = tf.load_json("configs", "dff_gf180")
    text = tf.job_netlist(cfg, SEED, 0)
    cc = ct.parse_spice(text, device="cpu")
    op = ct.dc(cc, mode=1, time=0.0)
    cir = mna.Circuit(netlist.parse(text))
    x, conv = mna.operating_point(cir)
    assert conv.all()
    got = _ref_x(cir, cc, op.x[None])[0]
    nodes = list(cir.node_index.values())
    assert np.abs(got[nodes] - x[0, nodes]).max() < 1e-9
    cir.set_time(0.0)
    # the residual of a Newton iterate that met reltol 1e-4, abstol 1e-12 A
    assert np.abs(cir.evaluate(got[None])[0]).max() < 1e-12


def test_dff_sweep_transient_agrees():
    """A 4-lane Monte Carlo through the program's transweep over 0-80 ns
    against the reference's transient from the same operating points."""
    cfg = tf.load_json("configs", "dff_gf180")
    tab = tf.sweep_table(cfg, SEED, 0, 4)
    text = tf.render(cfg)
    cc = ct.parse_spice(text, device="cpu")
    sol = ct.transweep(cc, tab, (0.0, 8e-8), dt=cfg["dt"], n_save=9)
    unit = {"text": text, "overrides": tab, "names": cc.names,
            "x0": sol.xs[:, 0].numpy(), "sampled": np.arange(4),
            "xs": sol.xs.numpy(), "ts": np.asarray(sol.ts), "tstop": 8e-8}
    r = chk.combine([chk.judge(unit, cfg, {"reltol": 1e-5})])
    assert r["op_kcl_A"] < 1e-12
    assert r["wave_max"] < 1e-2


def test_graetz_fused_transient_agrees():
    """One seeded graetz job through vmem_tran (K2's plain twin on the
    CPU) over 0-10 ms against the reference; at 10 ms, as at the cell's
    1 s, the source crosses zero, every diode is off and the last step's
    equation holds to rounding."""
    cfg = tf.load_json("configs", "vacask_graetz")
    text = tf.job_netlist(cfg, SEED, 0)
    cc = ct.parse_spice(text, device="cpu")
    sol = ct.vmem_tran(cc, (0.0, 1e-2), dt=1e-6)
    unit = {"text": text, "names": cc.names, "x0": sol.xs[:1].numpy(),
            "final": sol.final.numpy()[None], "sampled": np.array([0]),
            "xs": sol.xs.numpy()[None], "ts": np.asarray(sol.ts),
            "tstop": 1e-2}
    r = chk.combine([chk.judge(unit, cfg, {"reltol": 1e-4})])
    assert r["final_kcl_A"] < 1e-12
    assert r["wave_max"] < 1e-2
