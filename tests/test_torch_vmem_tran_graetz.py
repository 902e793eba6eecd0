"""Kernel K2's twin on the graetz rectifier (four diodes with series rs),
0-60 ms at 100 us, against the f64 golden tests/goldens/graetz.npz and the
reference K2 (archive/pallas_tran.py in interpret mode, loaded by
test_torch_vmem_tran.load_reference).

The reference runs in f32, the port in f64; in f32 the diode switching
needs many more Newton iterations, so the Newton count is held against
the same reference kernel traced in f64 (see test_torch_vmem_tran_dff)."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.models.vacask import GRAETZ
from test_torch_vmem_tran import ROOT, counts, load_reference

torch.set_num_threads(1)
SPAN, DT = (0, 0.06), 1e-4


def _v(sol):
    return np.asarray(sol.xs)[:, 2] - np.asarray(sol.xs)[:, 3]


@pytest.fixture(scope="module")
def runs():
    tcc = tct.parse_spice(GRAETZ, device="cpu")
    assert [tcc.index_of(k) for k in ("outp", "outn")] == [2, 3]
    out = {"port": tct.vmem_tran(tcc, SPAN, dt=DT)}
    for key, x64 in (("ref", False), ("ref64", True)):
        # a circuit each: the reference caches its kernel on the circuit
        out[key] = load_reference(x64).vmem_tran(
            jct.parse_spice(GRAETZ), SPAN, dt=DT, interpret=True)
    return out


def _golden_rmse(sol):
    """bench.py's golden_rmse of v(outp, outn), scale 20 V."""
    g = np.load(f"{ROOT}/tests/goldens/graetz.npz")
    m = g["ts"] <= SPAN[1] + 1e-12
    vi = np.interp(g["ts"][m], np.asarray(sol.ts), _v(sol))
    return np.sqrt(np.mean((vi - (g["outp"] - g["outn"])[m]) ** 2)) / 20.0


def test_graetz_twin_matches_golden(runs):
    sol = runs["port"]
    assert bool(sol.converged) and sol.xs.shape == (601, 9)
    # bench.py's gate; the f32 reference lands at 1.7e-4. The port's
    # last row, never crossed by a step (the integrator stops within
    # 0.01 save intervals of the chunk's end), keeps the chunk's entry
    # state as the reference's rule has it: most of the port's 1.0e-3
    assert _golden_rmse(sol) <= 2e-3
    assert _golden_rmse(runs["ref"]) <= 2e-3


def test_graetz_twin_matches_reference_k2(runs):
    v, v32, v64 = (_v(runs[k]) for k in ("port", "ref", "ref64"))
    # within the golden gate of both references, over every save row
    assert np.sqrt(np.mean((v - v32) ** 2)) / 20.0 <= 2e-3
    assert np.sqrt(np.mean((v - v64) ** 2)) / 20.0 <= 2e-3
    late = np.asarray(runs["port"].ts) > 0.04
    assert 16.5 < v[late].min() < v[late].max() < 19.0


def test_graetz_step_counts(runs):
    port = counts(runs["port"].stats)
    ref, ref64 = counts(runs["ref"].stats), counts(runs["ref64"].stats)
    # accepted and rejected within 5 % of the f32 reference; Newton no
    # more than its count (f32 takes about 60 % more here); all three
    # within 5 % of the f64 trace (rounding moves a few decisions in 600
    # steps of diode switching: 1.7-2 % measured)
    for a, b in zip(port[:2], ref[:2]):
        assert abs(a - b) <= 0.05 * b, (port, ref)
    assert port[2] <= ref[2]
    for a, b in zip(port, ref64):
        assert abs(a - b) <= 0.05 * b, (port, ref64)
