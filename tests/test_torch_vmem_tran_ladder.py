"""Kernel K2's twin above the warp solve: a 40-section RC ladder (n = 42
unknowns) driven by a pulse, 0-5 us, against the reference K2
(archive/pallas_tran.py in interpret mode, loaded by
test_torch_vmem_tran.load_reference) traced in f32 and in f64.

Above WARP_SOLVE_MAX unknowns K2 solves its Newton system with K1's
blocked form, and its twin with `gj_solve_blocked_plain`: the same pivots
as the reference's unblocked Gauss-Jordan, the same solution to rounding
(a blocked product sums in another order). On this linear circuit the
f64 trace takes the port's steps exactly."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.ops import gj_solve as K1
from cadnip_tpu_torch.ops import vmem_tran as vt
from test_torch_vmem_tran import chip_smoke, counts, load_reference

torch.set_num_threads(1)
SECTIONS, SPAN, DT = 40, (0, 5e-6), 1e-7
NET = chip_smoke.rc_ladder(SECTIONS)


@pytest.fixture(scope="module")
def runs():
    out = {"port": tct.vmem_tran(tct.parse_spice(NET, device="cpu"), SPAN,
                                 dt=DT)}
    for key, x64 in (("ref", False), ("ref64", True)):
        # a circuit each: the reference caches its kernel on the circuit
        out[key] = load_reference(x64).vmem_tran(jct.parse_spice(NET), SPAN,
                                                 dt=DT, interpret=True)
    return out


def test_ladder_twin_takes_the_blocked_solve(monkeypatch):
    calls = []
    twin = vt.gj_solve_blocked_plain

    def counted(A, B, **kw):
        calls.append(tuple(A.shape))
        return twin(A, B, **kw)

    monkeypatch.setattr(vt, "gj_solve_blocked_plain", counted)
    cc = tct.parse_spice(NET, device="cpu")
    assert cc.n == SECTIONS + 2 > vt.WARP_SOLVE_MAX
    assert K1.variant(cc.n, 1) == "block"
    sol = tct.vmem_tran(cc, (0, 4e-7), dt=DT)
    assert bool(sol.converged)
    assert calls and set(calls) == {(1, cc.n, cc.n)}
    assert len(calls) == counts(sol.stats)[2]


def test_ladder_twin_matches_reference_k2(runs):
    sol = runs["port"]
    assert bool(sol.converged) and sol.xs.shape == (51, SECTIONS + 2)
    x, x32, x64 = (np.asarray(runs[k].xs) for k in ("port", "ref", "ref64"))
    # the f64 trace of the same algorithm: rounding only
    assert np.abs(x - x64).max() <= 1e-9
    # the f32 reference (eps 6e-8) on a ladder whose system grows stiffer
    # with its length: 1.7e-4 V at most and 1.3e-5 V RMS over the nodes
    # at equal counts, observed on the CPU
    nodes = slice(0, SECTIONS + 1)
    assert np.abs(x - x32)[:, nodes].max() <= 1e-3
    assert np.sqrt(np.mean((x - x32)[:, nodes] ** 2)) <= 1e-4


def test_ladder_step_counts(runs):
    port = counts(runs["port"].stats)
    assert port == counts(runs["ref64"].stats)
    # accepted and rejected within 5 % of the f32 reference
    for a, b in zip(port[:2], counts(runs["ref"].stats)[:2]):
        assert abs(a - b) <= max(1, 0.05 * b), (port,
                                                counts(runs["ref"].stats))
