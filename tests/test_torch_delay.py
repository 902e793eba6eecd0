"""Verilog-A `absdelay` in the port (the history ring of
cadnip_tpu_torch/analyses/tran.py, the delay slots and probe of
mna/assemble.py, the phase term of analyses/ac.py) against the JAX
package, case for case with tests/test_delay.py: the same decks through
both packages, every port call on the CPU. Transients: accepted, rejected
and Newton counts equal, node voltages within 1e-9 V; AC within 1e-9 of
max |H|. Also a history ring shorter than the delay, a 3-lane
`transweep` over the delay, the solver trace, and a delay line inside a
circuit compiled to the block-bordered-diagonal backend."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.analyses.sweeps import transweep as jax_transweep
from cadnip_tpu_torch.analyses.sweeps import transweep
from cadnip_tpu_torch.analyses.tran import TRACE_LEN
from cadnip_tpu_torch.mna.assemble import make_delay_meta, pad_state

torch.set_num_threads(1)

V_TOL = 1e-9

DLINE_VA = """
`include "disciplines.vams"
module dline(a, y);
  inout a, y;
  electrical a, y;
  parameter real td = 5u from (0:inf);
  analog V(y) <+ absdelay(V(a), td);
endmodule

module dmix(a, y);
  inout a, y;
  electrical a, y;
  parameter real td = 4u;
  parameter real k = 0.5;
  analog V(y) <+ V(a) + k * absdelay(V(a), td);
endmodule
"""

DLINE = """delay line
.hdl "{va}"
v1 in 0 dc 0 pulse 0 1 2u 1u 1u 10u 40u
x1 in out dline td=5u
r1 out 0 1k
"""

DMIX = """delay mix
.hdl "{va}"
v1 in 0 dc 0 pulse 0 1 1u 0.5u 0.5u 20u 50u
x1 in out dmix td=4u k=0.5
r1 out 0 1k
"""


@pytest.fixture()
def va_path(tmp_path):
    p = tmp_path / "dline.va"
    p.write_text(DLINE_VA)
    return str(p)


def _pair(deck, va_path, **kw):
    text = deck.format(va=va_path)
    return (jct.parse_spice(text, **kw),
            tct.parse_spice(text, device="cpu", **kw))


def _same_tran(ts, js):
    for a, b in zip(ts.stats[:3], js.stats[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.converged.numpy(),
                                  np.asarray(js.converged))
    np.testing.assert_allclose(ts.xs.numpy(), np.asarray(js.xs), rtol=0,
                               atol=V_TOL)


def test_absdelay_dc_is_identity(va_path):
    deck = """delay dc
.hdl "{va}"
v1 in 0 dc 2.5
x1 in out dline td=1u
r1 out 0 1k
"""
    jcc, tcc = _pair(deck, va_path)
    g = next(g for g in tcc.groups if g.model.name == "va:dline")
    assert g.model.n_delay_sites == 1 and g.model.delay_probe is not None
    js, ts = jct.dc(jcc), tct.dc(tcc)
    assert float(ts["out"]) == pytest.approx(2.5, abs=1e-9)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=V_TOL)
    # the probe gives the instantaneous value and the delay
    meta = make_delay_meta(tcc)
    vals, taus = meta.probe(pad_state(ts.x[None]), tcc.params0(),
                            tcc.spec.dyn("cpu"))
    assert meta.size == 1
    assert float(vals[0, 0]) == pytest.approx(2.5, abs=1e-9)
    assert float(taus[0, 0]) == pytest.approx(1e-6, rel=1e-15)


def test_absdelay_shifts_waveform(va_path):
    td = 5e-6
    jcc, tcc = _pair(DLINE, va_path)
    js = jct.tran(jcc, (0, 30e-6), dt=0.1e-6)
    sol = tct.tran(tcc, (0, 30e-6), dt=0.1e-6)
    _same_tran(sol, js)
    assert bool(sol.converged)
    ts = sol.ts
    vin, vout = sol["in"].numpy(), sol["out"].numpy()
    shift = int(round(td / (ts[1] - ts[0])))
    assert np.max(np.abs(vout[shift:] - vin[:-shift])) < 0.03
    for t, want in ((12e-6, 1.0), (25e-6, 0.0), (5e-6, 0.0)):
        i = np.argmin(np.abs(ts - t))
        assert vout[i] == pytest.approx(want, abs=1e-6)


def test_absdelay_in_expression(va_path):
    jcc, tcc = _pair(DMIX, va_path)
    js = jct.tran(jcc, (0, 12e-6), dt=0.1e-6)
    sol = tct.tran(tcc, (0, 12e-6), dt=0.1e-6)
    _same_tran(sol, js)
    ts, vout = sol.ts, sol["out"].numpy()
    assert vout[np.argmin(np.abs(ts - 3e-6))] == pytest.approx(1.0,
                                                                abs=1e-3)
    assert vout[np.argmin(np.abs(ts - 9e-6))] == pytest.approx(1.5,
                                                                abs=1e-3)


def test_absdelay_ac_phase(va_path):
    deck = """delay ac
.hdl "{va}"
v1 in 0 dc 1 ac 1
x1 in out dline td=5u
r1 out 0 1k
"""
    jcc, tcc = _pair(deck, va_path)
    freqs = np.array([1e3, 1e4, 5e4])
    h = tct.ac(tcc, freqs)["out"]
    hj = jct.ac(jcc, freqs)["out"]
    expect = np.exp(-1j * 2 * np.pi * freqs * 5e-6)
    assert np.abs(h).max() == pytest.approx(1.0, rel=1e-6)
    assert np.allclose(np.angle(h), np.angle(expect), atol=1e-6)
    np.testing.assert_allclose(h, hj, rtol=0, atol=1e-9 * np.abs(hj).max())
    # noise stays quasi-static on the delay (no phase term), as in JAX
    nz = tct.noise(tcc, "out", freqs, input="v1")
    nj = jct.noise(jcc, "out", freqs, input="v1")
    np.testing.assert_allclose(nz.onoise_psd, np.asarray(nj.onoise_psd),
                               rtol=1e-9)


def test_short_history_ring_clamps_like_jax(va_path):
    # a ring of 8 points holds less than one delay's worth of accepted
    # steps: queries before its oldest entry clamp to it, as in JAX
    jcc, tcc = _pair(DLINE, va_path)
    js = jct.tran(jcc, (0, 30e-6), dt=0.1e-6, delay_hist=8)
    sol = tct.tran(tcc, (0, 30e-6), dt=0.1e-6, delay_hist=8)
    _same_tran(sol, js)
    full = tct.tran(tcc, (0, 30e-6), dt=0.1e-6)
    assert np.abs(sol.xs.numpy() - full.xs.numpy()).max() > 1e-3


def test_absdelay_transweep_matches_jax(va_path):
    # three delays in one batch: each lane caps its step at its own delay
    # and takes no breakpoint echoes, as JAX's vmapped transient
    jcc, tcc = _pair(DMIX, va_path)
    tab = {"x1.td": np.array([2e-6, 4e-6, 7e-6])}
    js = jax_transweep(jcc, tab, (0, 12e-6), dt=0.1e-6)
    sol = transweep(tcc, tab, (0, 12e-6), dt=0.1e-6)
    assert sol.xs.shape[0] == 3
    _same_tran(sol, js)
    # a batched run adds no echoes: lane 1 is not the serial run
    serial = tct.tran(tcc, (0, 12e-6), dt=0.1e-6)
    assert int(sol.stats.naccept[1]) != int(serial.stats.naccept)


def test_absdelay_trace_matches_jax(va_path):
    jcc, tcc = _pair(DMIX, va_path)
    js = jct.tran(jcc, (0, 12e-6), dt=0.1e-6, trace=True)
    sol = tct.tran(tcc, (0, 12e-6), dt=0.1e-6, trace=True)
    ring, ti = sol.trace
    jring, jti = (np.asarray(a) for a in js.trace)
    assert ring.shape == (TRACE_LEN, 6)
    assert int(ti) == int(jti) == int(sol.stats.nnewton)
    k = int(ti)
    np.testing.assert_allclose(ring[:k].numpy(), jring[:k], rtol=1e-12,
                               atol=0)
    assert float(ring[:k, 5].sum()) == int(sol.stats.naccept)
    assert tct.tran(tcc, (0, 12e-6), dt=0.1e-6).trace is None


def _ladder_with_dline(va_path, sections=10):
    text = ("ladder dline\n" f'.hdl "{va_path}"\n'
            "v1 n0 0 dc 0 pulse 0 1 1u 0.5u 0.5u 20u 50u\n")
    for k in range(sections):
        text += f"r{k} n{k} n{k + 1} 100\nc{k} n{k + 1} 0 1n\n"
    text += (f"x1 n{sections} out dline td=2u\nrl out 0 1k\n"
             f"x2 n3 mix dmix td=1u\nrm mix 0 1k\n")
    return tct.parse_spice(text, device="cpu", compile=False)


def test_absdelay_on_bbd_matches_dense(va_path):
    cir = _ladder_with_dline(va_path)
    bbd = cir.compile(solver="bbd", block_size=4, device="cpu")
    dense = cir.compile(solver="dense", device="cpu")
    assert bbd.bbd is not None and bbd.bbd.K >= 2
    sb = tct.tran(bbd, (0, 8e-6), dt=0.1e-6)
    sd = tct.tran(dense, (0, 8e-6), dt=0.1e-6)
    for a, b in zip(sb.stats[:3], sd.stats[:3]):
        assert int(a) == int(b)
    np.testing.assert_allclose(sb.xs.numpy(), sd.xs.numpy(), rtol=0,
                               atol=V_TOL)
    assert float(sb["out"][-1]) > 0.5


@pytest.mark.gpu
def test_absdelay_on_cuda_matches_jax(va_path):
    """On the card: the delay line's transient (every Newton pass a K1
    launch) and its delayed AC sweep (one K1 launch) against JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    text = DLINE.format(va=va_path)
    jcc, tcc = jct.parse_spice(text), tct.parse_spice(text, device="cuda")
    js = jct.tran(jcc, (0, 30e-6), dt=0.1e-6)
    gj_solve.launches = 0
    sol = tct.tran(tcc, (0, 30e-6), dt=0.1e-6)
    assert gj_solve.launches >= int(sol.stats.nnewton)
    for a, b in zip(sol.stats[:3], js.stats[:3]):
        assert int(a) == int(b)
    np.testing.assert_allclose(sol.xs.cpu().numpy(), np.asarray(js.xs),
                               rtol=0, atol=V_TOL)
    freqs = tct.acdec(100, 1e3, 1e5)
    op = tct.dc(tcc)
    gj_solve.launches = 0
    h = tct.ac(tcc, freqs, op_x=op.x)["out"]
    assert gj_solve.launches == 1
    hj = jct.ac(jcc, freqs)["out"]
    np.testing.assert_allclose(h, hj, rtol=0, atol=1e-9 * np.abs(hj).max())
