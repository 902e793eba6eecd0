"""The port's netlist writers and converter (cadnip_tpu_torch/frontend/
writer.py, cadnip_tpu_torch/convert.py) against the JAX package: to_spice,
to_spectre and to_veriloga text equal to JAX's for the decks of
tests/test_writer.py and the DFF; what each text parses back to equal
between the packages (circuits under assert_same_circuit, DC within 1e-12
relative, transients at equal step counts within 1e-12 of the waveform's
scale); `convert.main` output equal to JAX's for every target, and the
to_veriloga round trip through the port's VA compiler within 1e-12 of
JAX's."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu import convert as jax_convert
from cadnip_tpu.frontend import writer as jw
from cadnip_tpu.frontend.elaborate import parse_spice as jax_parse
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu_torch import convert
from cadnip_tpu_torch.frontend import writer as tw
from cadnip_tpu_torch.frontend.elaborate import parse_spice
from test_torch_spectre import _np, _pair, _same

torch.set_num_threads(1)

DECKS = {
    "roundtrip": ("""roundtrip
.model dx d (is=2e-14 n=1.1)
v1 in 0 dc 5 ac 1 0
r1 in mid 1k
c1 mid 0 1u
l1 mid out 1m
d1 out 0 dx
e1 e1p 0 mid 0 2.0
rl e1p 0 1k
""", ("in", "mid", "out", "e1p")),
    "spectre_target": ("""spectre target
.model dx d (is=2e-14 n=1.1)
.model nch nmos (level=1 vto=0.7 kp=110u)
v1 in 0 dc 5
vg g 0 dc 2
r1 in mid 1k
c1 mid 0 1u
d1 mid 0 dx
m1 in g sn 0 nch w=10u l=1u
rs sn 0 2k
g1 gp 0 mid 0 1m
rg gp 0 1k
""", ("in", "mid", "sn", "gp")),
    "controlled": ("""controlled
v1 in 0 dc 1
r1 in a 1k
l1 a 0 1m
l2 b 0 4m
k1 l1 l2 0.5
rb b 0 1k
f1 0 fo v1 2
rf fo 0 1k
h1 ho 0 v1 500
rh ho 0 1k
""", ("a", "fo", "ho")),
    "waves": ("""waves
v1 a 0 dc 0 pulse 0 5 1u 1n 1n 1m 2m
v2 b 0 dc 0 sin 0 2 1k
vs in 0 dc 0 pulse 0 1 1u 1u 1u 1m 2m
r1 a 0 1k
r2 b 0 1k
r3 in out 1k
c1 out 0 1u
""", ("a", "b", "out")),
}
WRITERS = ("to_spice", "to_spectre")


def _texts(writer, name):
    deck = jax_dff() if name == "dff" else DECKS[name][0]
    got = getattr(tw, writer)(parse_spice(deck, compile=False))
    want = getattr(jw, writer)(jax_parse(deck, compile=False))
    return got, want


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", list(DECKS) + ["dff"])
def test_writer_text_like_jax(writer, name):
    """The same text from both packages; parsed back, the same circuit and
    operating point in both, and (for the decks of tests/test_writer.py)
    the original's node voltages within 1e-9."""
    got, want = _texts(writer, name)
    assert got == want
    if writer == "to_spectre":
        assert got.startswith("// ") and "simulator lang=spectre" in got
    if name == "controlled" and writer == "to_spectre":
        # the written `k1 mutual_inductor ind1=l1 ...` line has no node
        # list, which the Spectre parser of both packages refuses alike
        with pytest.raises(ValueError) as want_err:
            jax_parse(got)
        with pytest.raises(ValueError) as got_err:
            parse_spice(got, device="cpu")
        assert str(got_err.value) == str(want_err.value)
        assert "mutual_inductor" in str(got_err.value)
        return
    _, sol, _ = _pair(got)
    if name == "dff":
        return
    orig = tct.dc(parse_spice(DECKS[name][0], device="cpu"))
    for node in DECKS[name][1]:
        assert float(sol[node]) == pytest.approx(float(orig[node]),
                                                 rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("writer", WRITERS)
def test_written_waveforms_run_like_jax(writer):
    """The pulse and sine sources written out run the same transient in
    both packages, and track the original deck's."""
    text, _ = _texts(writer, "waves")
    tcc = parse_spice(text, device="cpu")
    sol = tct.tran(tcc, (0, 2e-3), dt=2e-6)
    _same("tran", sol, jct.tran(jax_parse(text), (0, 2e-3), dt=2e-6))
    orig = tct.tran(parse_spice(DECKS["waves"][0], device="cpu"),
                    (0, 2e-3), dt=2e-6)
    ts, ots = _np(sol.ts), _np(orig.ts)
    for node in ("a", "b"):
        assert np.allclose(_np(sol[node]),
                           np.interp(ts, ots, _np(orig[node])), atol=1e-6)
    v = _np(sol["out"])
    assert 0.5 < v[np.argmin(np.abs(ts - 1e-3))] < 0.7


def test_spectre_to_spice_conversion_like_jax():
    spectre = """
simulator lang=spectre
v1 (in 0) vsource dc=5
r1 (in out) resistor r=1K
r2 (out 0) resistor r=3K
"""
    spice = tw.convert(spectre, to="spice")
    assert spice == jw.convert(spectre, to="spice")
    assert "resistor" not in spice
    _, sol, _ = _pair(spice)
    assert float(sol["out"]) == pytest.approx(3.75, rel=1e-9)
    with pytest.raises(ValueError) as want:
        jw.convert(spectre, to="verilog")
    with pytest.raises(ValueError) as got:
        tw.convert(spectre, to="verilog")
    assert str(got.value) == str(want.value)


CLI_DECK = """cli test
v1 in 0 dc 5
r1 in out 1k
r2 out 0 1k
"""


@pytest.mark.parametrize("target", ["spice", "spectre", "veriloga"])
def test_convert_cli_like_jax(target, tmp_path, capsys):
    """`convert.main` writes JAX's text for every target, to a file and to
    stdout."""
    src = tmp_path / "in.ckt"
    src.write_text(CLI_DECK)
    outs = []
    for main in (convert.main, jax_convert.main):
        out = tmp_path / f"out{len(outs)}"
        assert main([str(src), "--to", target, "-o", str(out)]) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert convert.main([str(src), "--to", target, "--module", "divi"]) == 0
    text = capsys.readouterr().out
    if target == "veriloga":
        assert "module divi" in text
    else:
        assert text == outs[0]
        sol = tct.dc(parse_spice(text, device="cpu"))
        assert float(sol["out"]) == pytest.approx(2.5)


def test_convert_runs_as_a_module(tmp_path):
    """`python -m cadnip_tpu_torch.convert deck --to spectre` prints the
    Spectre text."""
    src = tmp_path / "in.ckt"
    src.write_text(CLI_DECK)
    out = subprocess.run([sys.executable, "-m", "cadnip_tpu_torch.convert",
                          str(src), "--to", "spectre"], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == jw.convert(CLI_DECK, to="spectre")


def _divider(mod):
    cir = mod.Circuit("divider")
    cir.V("vs", "in", "0", dc=6.0)
    cir.R("r1", "in", "mid", 1e3)
    cir.R("r2", "mid", "0", 2e3)
    cir.C("c1", "mid", "0", 1e-9)
    cir.add(mod.VCCS, "g1", ("gp", "0", "mid", "0"), gm=1e-3)
    cir.R("rg", "gp", "0", 1e3)
    cir.add(mod.VCVS, "e1", ("ep", "0", "mid", "0"), gain=2.0)
    cir.R("re", "ep", "0", 1e3)
    return cir


def test_to_veriloga_round_trip_like_jax(tmp_path):
    """A Circuit of R, C, V, E and G exported to Verilog-A, compiled by
    each package's VA compiler and instantiated by `.hdl`: the same text,
    and the same operating point within 1e-12."""
    va = tw.to_veriloga(_divider(tct), module_name="divider", ports=[])
    assert va == jw.to_veriloga(_divider(jct), module_name="divider",
                                ports=[])
    p = tmp_path / "divider.va"
    p.write_text(va)
    deck = f"""va round trip
.hdl "{p}"
x1 divider
rbig probe 0 1k
"""
    tcc, jcc = parse_spice(deck, device="cpu"), jax_parse(deck)
    assert tcc.names == jcc.names
    sol = tct.dc(tcc)
    _same("dc", sol, jct.dc(jcc))
    assert float(sol["x1#mid"]) == pytest.approx(4.0, rel=1e-9)
    assert float(sol["x1#gp"]) == pytest.approx(-4.0, rel=1e-9)
    assert float(sol["x1#ep"]) == pytest.approx(8.0, rel=1e-9)
    with pytest.raises(ValueError, match="unsupported device"):
        cir = _divider(tct)
        cir.D("d1", "mid", "0")
        tw.to_veriloga(cir)
