"""The port's introspection (cadnip_tpu_torch/frontend/introspect.py),
`TranSolution.save` / `load` and the explorer (frontend/explore.py)
against the JAX package: query, find (with its ambiguity and miss errors),
summary and op_table text equal to JAX's on the DFF and on
tests/test_frontend.py's introspection deck; waveforms saved by one
package loaded by the other; explore's sliders and re-runs headless
(Agg) against JAX's explore on tests/test_explore.py's RC within 1e-9;
and, on the card, summary and op_table of a CUDA circuit."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.frontend.elaborate import parse_spice as jax_parse
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu_torch.frontend.elaborate import parse_spice
from test_torch_spectre import _np

torch.set_num_threads(1)

QUERY_DECK = """q
v1 in 0 dc 5
r1 in out 1k
rload out 0 1k
"""
#: a node and an instance of the same name, for find's ambiguity error
AMBIGUOUS_DECK = """ambiguous
v1 r1 0 dc 1
r1 r1 0 1k
"""
RC = """rc lowpass
v1 in 0 dc 0 pulse 0 1 0 1n 1n 1 2
r1 in out 1k
c1 out 0 1u
.end
"""


def _circuits(name):
    deck = {"query": QUERY_DECK, "dff": jax_dff(),
            "ambiguous": AMBIGUOUS_DECK}[name]
    return parse_spice(deck, device="cpu"), jax_parse(deck)


@pytest.mark.parametrize("name", ["query", "dff"])
def test_summary_and_op_table_like_jax(name):
    tcc, jcc = _circuits(name)
    assert tct.summary(tcc) == jct.summary(jcc)
    sol = tct.dc(tcc)
    assert tct.op_table(sol) == jct.op_table(jct.dc(jcc))
    assert tct.op_table(sol, max_rows=5) == \
        jct.op_table(jct.dc(jcc), max_rows=5)
    if name == "query":
        s = tct.summary(tcc)
        assert "3 devices" in s and "unknowns" in s
        assert "V(out)" in tct.op_table(sol)


@pytest.mark.parametrize("pattern", ["r*", "*", "out", "v1*", "m?o*",
                                     "nosuch"])
def test_query_like_jax(pattern):
    for name in ("query", "dff"):
        tcc, jcc = _circuits(name)
        got = [(r.kind, r.name, r.index) for r in tct.query(tcc, pattern)]
        assert got == [(r.kind, r.name, r.index)
                       for r in jct.query(jcc, pattern)]
    if pattern == "r*":
        tcc, _ = _circuits("query")
        assert {r.name for r in tct.query(tcc, "r*")
                if r.kind == "instance"} == {"r1", "rload"}


def test_find_resolves_like_jax():
    """find's Ref resolves a node to its voltage and an instance to its
    terminal currents and op-vars, as JAX's does."""
    tcc, jcc = _circuits("query")
    sol, ref = tct.dc(tcc), jct.dc(jcc)
    assert float(tct.find(tcc, "out")(sol)) == pytest.approx(2.5)
    assert float(tct.find(tcc, "out")(sol)) == \
        pytest.approx(float(jct.find(jcc, "out")(ref)), rel=1e-12)
    got, want = tct.find(tcc, "rload")(sol), jct.find(jcc, "rload")(ref)
    assert got["currents"]["p"] == pytest.approx(2.5e-3, rel=1e-9)
    assert got["currents"] == pytest.approx(want["currents"], rel=1e-12)
    assert got["op"] == want["op"] == {}
    tcc, jcc = _circuits("dff")
    sol, ref = tct.dc(tcc), jct.dc(jcc)
    got, want = tct.find(tcc, "mno1")(sol), jct.find(jcc, "mno1")(ref)
    assert list(got["op"]) == list(want["op"])
    for k, v in want["op"].items():
        assert got["op"][k] == pytest.approx(float(v), rel=1e-9, abs=1e-20)


@pytest.mark.parametrize("name, what", [("nonexistent", "no node"),
                                        ("r1", "ambiguous"),
                                        ("*", "ambiguous")])
def test_find_errors_like_jax(name, what):
    """A miss lists the close matches, an ambiguous name its candidates:
    JAX's KeyError, word for word."""
    tcc, jcc = _circuits("ambiguous")
    with pytest.raises(KeyError) as want:
        jct.find(jcc, name)
    with pytest.raises(KeyError) as got:
        tct.find(tcc, name)
    assert str(got.value) == str(want.value)
    assert what in str(got.value)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tran_save_load_across_packages(writer, tmp_path):
    """A .npz saved by either package loads in the other: the same
    arrays, and names in the circuit's unknown order."""
    tcc, jcc = _circuits("query")
    path = str(tmp_path / "w.npz")
    tsol = tct.tran(tcc, (0, 1e-6), dt=1e-8)
    jsol = jct.tran(jcc, (0, 1e-6), dt=1e-8)
    saved = tsol if writer == "port" else jsol
    saved.save(path)
    loader = jct.TranSolution.load if writer == "port" \
        else tct.TranSolution.load
    ts, waves = loader(path)
    assert isinstance(ts, np.ndarray)
    np.testing.assert_array_equal(ts, _np(saved.ts))
    assert list(waves) == sorted(tcc.names, key=tcc.names.get)
    for nm, v in waves.items():
        np.testing.assert_array_equal(v, _np(saved[nm]))
    ts2, waves2 = tct.TranSolution.load(path)
    np.testing.assert_array_equal(ts2, ts)
    assert list(waves2) == list(waves)


def test_explore_headless_like_jax():
    """The same default sliders as JAX's explore; the plotted samples
    within 1e-9 of JAX's after set("r1.r", 5e3) and back."""
    import matplotlib     # optional: imported by the one case that plots
    matplotlib.use("Agg")
    tcc, jcc = parse_spice(RC, device="cpu"), jax_parse(RC)
    kw = dict(dt=5e-6, outputs=["out"], show=False)
    ex = tct.explore(tcc, (0.0, 5e-3), **kw)
    jex = jct.explore(jcc, (0.0, 5e-3), **kw)
    assert list(ex.sliders) == list(jex.sliders)
    assert "r1.r" in ex.sliders and "c1.c" in ex.sliders
    assert ex.base == jex.base
    np.testing.assert_allclose(ex.ts, jex.ts, rtol=0, atol=1e-18)
    v0 = ex.values("out").copy()
    np.testing.assert_allclose(v0, jex.values("out"), rtol=0, atol=1e-9)
    i_tau = int(np.argmin(np.abs(ex.ts - 1e-3)))
    assert abs(v0[i_tau] - (1 - np.exp(-1.0))) < 5e-3
    for value in (5e3, 1e3):
        ex.set("r1.r", value)
        jex.set("r1.r", value)
        assert ex.sliders["r1.r"].valtext.get_text() == \
            jex.sliders["r1.r"].valtext.get_text()
        np.testing.assert_allclose(ex.values("out"), jex.values("out"),
                                   rtol=0, atol=1e-9)
    np.testing.assert_allclose(ex.values("out"), v0, rtol=0, atol=1e-9)
    with pytest.raises(KeyError, match="bogus.param"):
        ex.set("bogus.param", 1.0)
    with pytest.raises(ValueError, match="log-scale"):
        tct.explore(tcc, (0.0, 5e-3), sliders=["v1.dc"], **kw)


@pytest.mark.gpu
def test_summary_and_op_table_of_a_cuda_circuit():
    """On the card, summary and op_table read the device tensors through
    host copies and give the CPU circuit's text."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    cards = {dev: parse_spice(tct.dff_netlist(), device=dev)
             for dev in ("cuda", "cpu")}
    assert tct.summary(cards["cuda"]) == tct.summary(cards["cpu"])
    sol = tct.dc(cards["cuda"])
    assert sol.x.device.type == "cuda"
    assert tct.op_table(sol) == tct.op_table(tct.dc(cards["cpu"]))
    assert float(tct.find(cards["cuda"], "q")(sol)) == \
        pytest.approx(float(sol["q"]))
