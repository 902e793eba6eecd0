"""Kernel K2's twin on the DFF, 0-150 ns, against the f64 golden
tests/goldens/dff.npz and the reference K2 (archive/pallas_tran.py in
interpret mode, loaded by test_torch_vmem_tran.load_reference).

The reference runs in f32. Its f32 Newton iterations need more passes to
meet the reltol test than f64 ones do, so its Newton count is not the
port's: the same reference kernel traced in f64 takes exactly the port's
steps, and that is the count the port is held to."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.models.dff import dff_netlist as jax_dff_netlist
from test_torch_vmem_tran import ROOT, counts, load_reference

torch.set_num_threads(1)
SPAN, DT = (0, 1.5e-7), 3.333e-10


@pytest.fixture(scope="module")
def runs():
    jcc = jct.parse_spice(jax_dff_netlist())
    out = {"port": tct.vmem_tran(tct.parse_spice(tct.dff_netlist(),
                                                 device="cpu"), SPAN,
                                 dt=DT)}
    for key, x64 in (("ref", False), ("ref64", True)):
        # a circuit each: the reference caches its kernel on the circuit
        out[key] = load_reference(x64).vmem_tran(
            jct.parse_spice(jax_dff_netlist()), SPAN, dt=DT, interpret=True)
    iq = jcc.index_of("q")
    q = {k: np.asarray(v.xs)[:, iq] for k, v in out.items()}
    return out, q


def test_dff_twin_matches_golden(runs):
    sol, q = runs[0]["port"], runs[1]["port"]
    g = np.load(f"{ROOT}/tests/goldens/dff.npz")
    assert bool(sol.converged) and q.shape == (451,)
    # the golden's bar (BASELINE.json): 1e-6 of 5 V
    assert np.sqrt(np.mean((q - g["q"][:451]) ** 2)) / 5.0 <= 1e-6


def test_dff_twin_matches_reference_k2(runs):
    q = runs[1]
    # f32 reference against the f64 port: 1e-6 of 5 V is 5 uV RMS, about
    # 30 f32 ulps of a 5 V node (the reference itself sits 1.65e-8 from
    # the golden)
    assert np.sqrt(np.mean((q["port"] - q["ref"]) ** 2)) / 5.0 <= 1e-6
    # the same algorithm in f64 on both sides: rounding only
    assert np.sqrt(np.mean((q["port"] - q["ref64"]) ** 2)) / 5.0 <= 1e-8


def test_dff_step_counts(runs):
    sol, ref, ref64 = (runs[0][k] for k in ("port", "ref", "ref64"))
    port = counts(sol.stats)
    # accepted and rejected steps within 5 % of the f32 reference
    for a, b in zip(port[:2], counts(ref.stats)[:2]):
        assert abs(a - b) <= 0.05 * b, (port, counts(ref.stats))
    # f32 Newton needs more iterations (685 against 601): the port takes
    # no more than the f32 reference, and within 5 % of the f64 trace of
    # the same kernel (equal here)
    assert port[2] <= counts(ref.stats)[2]
    for a, b in zip(port, counts(ref64.stats)):
        assert abs(a - b) <= 0.05 * b, (port, counts(ref64.stats))
