"""The port's Spectre dialect (cadnip_tpu_torch/frontend/spectre.py and the
Spectre branches of frontend/elaborate.py) against the JAX package: every
runnable case of tests/test_spectre.py through both packages (the port's
on the CPU), the parsed card lists, the sweep and Monte Carlo containers
point by point, an inline mixed-language deck, and the DFF written as
Spectre text. Circuits equal under assert_same_circuit (parameters bit for
bit), DC values within 1e-12 relative, transients at equal step counts
within 1e-12 relative of the waveform's scale, plus the JAX test's own
expectations."""
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.frontend import spectre as jsp
from cadnip_tpu.frontend.elaborate import parse_spice as jax_parse
from cadnip_tpu.frontend.elaborate import simulate as jax_simulate
from cadnip_tpu.frontend.writer import to_spectre as jax_to_spectre
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu_torch.frontend import spectre as tsp
from cadnip_tpu_torch.frontend.elaborate import parse_spice, simulate
from cadnip_tpu_torch.frontend.writer import to_spectre
from test_torch_frontend import assert_same_circuit

torch.set_num_threads(1)

RTOL = 1e-12


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _same(kind, sol, ref):
    """One analysis result of the port against the JAX package's."""
    if kind in ("op", "dc"):
        np.testing.assert_array_equal(_np(sol.converged),
                                      _np(ref.converged))
        _close(sol.x, ref.x)
    elif kind == "tran":
        for a, b in zip(sol.stats[:3], ref.stats[:3]):
            np.testing.assert_array_equal(_np(a), _np(b))
        _close(sol.ts, ref.ts)
        _close(sol.xs, ref.xs)
    else:
        raise AssertionError(kind)


def _pair(deck):
    """The deck compiled by both packages, held equal; the port's circuit
    and the two operating points."""
    tcc, jcc = parse_spice(deck, device="cpu"), jax_parse(deck)
    assert_same_circuit(tcc, jcc)
    sol, ref = tct.dc(tcc), jct.dc(jcc)
    _same("dc", sol, ref)
    return tcc, sol, ref


def _both(deck):
    """simulate() of the deck through both packages, result by result;
    the containers' runs point by point."""
    res, ref = simulate(deck, device="cpu"), jax_simulate(deck)
    assert [k for k, _ in res["all"]] == [k for k, _ in ref["all"]]
    for (kind, sol), (_, rsol) in zip(res["all"], ref["all"]):
        if kind in ("sweep", "montecarlo"):
            assert {k: v for k, v in sol.items() if k != "runs"} == \
                {k: v for k, v in rsol.items() if k != "runs"}
            assert len(sol["runs"]) == len(rsol["runs"])
            for run, rrun in zip(sol["runs"], rsol["runs"]):
                assert list(run) == list(rrun)
                for k in run:
                    _same(k, run[k], rrun[k])
        else:
            _same(kind, sol, rsol)
    return res


NUMBERS = {
    "case_sensitive": {"1M": 1e6, "1m": 1e-3, "2K": 2e3, "2k": 2e3,
                       "10u": 10e-6},
    "unit_suffix": {"1.8_V": 1.8, "10k_Ohm": 10e3, "60ps": 60e-12,
                    "30ns": 30e-9, "5e-15": 5e-15, "rload": None},
}


@pytest.mark.parametrize("which", list(NUMBERS))
def test_spectre_numbers_like_jax(which):
    for text, want in NUMBERS[which].items():
        got = tsp.parse_spectre_number(text)
        assert got == jsp.parse_spectre_number(text)
        assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("text, want", [
    ("simulator lang=spectre\nr1 (a b) resistor", True),
    ("r1 (a b) resistor r=1k\n", True),
    ("title\nr1 a b 1k\n", False),
])
def test_detect_dialect_like_jax(text, want):
    assert tsp.looks_like_spectre(text) == jsp.looks_like_spectre(text) \
        == want


DC_DECKS = {
    "divider": ("""
simulator lang=spectre
v1 (in 0) vsource dc=5
r1 (in out) resistor r=1K
r2 (out 0) resistor r=1K
""", "out", 2.5),
    "parameters_and_subckt": ("""
simulator lang=spectre
parameters rr=2K vv=6
subckt halver (a b)
  parameters r0=1K
  rt (a mid) resistor r=r0
  rb (mid b) resistor r=r0
ends halver
v1 (in 0) vsource dc=vv
x1 (in 0) halver r0=rr
""", "x1.mid", 3.0),
    "model_card": ("""
simulator lang=spectre
model dmod d is=1e-14
v1 (in 0) vsource dc=5
r1 (in a) resistor r=1K
d1 (a 0) dmod
""", "a", None),
    "controlled_sources": ("""
simulator lang=spectre
v1 (in 0) vsource dc=0.5
e1 (out 0 in 0) vcvs gain=4
rl (out 0) resistor r=1K
""", "out", 2.0),
    "expression_constants": ("""consts
.param f0={1/(2*pi*1k*1u)}
v1 in 0 dc {pi}
r1 in 0 1k
""", "in", 3.141592653589793),
    "if_else": ("""
simulator lang=spectre
parameters mode=2
v1 (in 0) vsource dc=6
if (mode == 1) {
  r1 (in out) resistor r=1K
  r2 (out 0) resistor r=1K
} else if (mode == 2) {
  r1 (in out) resistor r=2K
  r2 (out 0) resistor r=1K
} else {
  r1 (in out) resistor r=5K
  r2 (out 0) resistor r=1K
}
""", "out", 2.0),
    "user_function": ("""
simulator lang=spectre
real rpar(real a, real b) {
    return a*b/(a+b);
}
parameters rload=rpar(2K, 2K)
v1 (in 0) vsource dc=3
r1 (in out) resistor r=1K
r2 (out 0) resistor r=rload
""", "out", 1.5),
    "string_params_and_noop_stmts": ("""
simulator lang=spectre
myopts options reltol=1e-4 rawfmt="psfbin"
c1 check windows=yes
s1 set dc=1
sh shell cmd="ls"
v1 (in 0) vsource dc=2
r1 (in 0) resistor r=1K
""", "in", 2.0),
    "inline_subckt": ("""
simulator lang=spectre
inline subckt pair (a b)
  ra (a m) resistor r=1K
  rb (m b) resistor r=1K
ends pair
v1 (in 0) vsource dc=2
x1 (in 0) pair
""", "x1.m", 1.0),
    "mixed_language": ("""// a mixed-language deck: four 1k resistors across one source
simulator lang=spice
v1 1 0 dc 1
r1 1 0 1k
r2 1 0 1k
simulator lang=spectre
r3 (1 0) resistor r=1k
r4 (1 0) resistor r=1k
""", "1", 1.0),
}


@pytest.mark.parametrize("name", list(DC_DECKS))
def test_spectre_deck_dc_like_jax(name):
    """The DC cases of tests/test_spectre.py (its SPICE constants deck
    among them, and an inline mixed-language deck in place of the
    reference corpus's mixed_langs.cir): the same circuit, the same
    operating point, and the JAX test's value."""
    deck, node, want = DC_DECKS[name]
    _, sol, _ = _pair(deck)
    assert bool(sol.converged)
    if want is not None:
        assert float(sol[node]) == pytest.approx(want, rel=1e-9)
    else:
        assert 0.5 < float(sol[node]) < 0.8
    if name == "mixed_language":
        # all four resistors landed: 4 mS across 1 V
        assert float(sol["v1#i"]) == pytest.approx(-4e-3, rel=1e-9)


def test_forced_spectre_dialect_like_jax():
    """A deck with no Spectre marker parses as Spectre where the caller
    says so: `1M` is mega, and the instances take `name n1 n2 master`."""
    from cadnip_tpu.frontend.elaborate import elaborate_netlist
    deck = "model dmod d is=1e-14\nv1 in 0 vsource dc=2\n" \
        "r1 in a resistor r=1M\nd1 a 0 dmod\n"
    assert not tsp.looks_like_spectre(deck)
    tcc = parse_spice(deck, device="cpu", dialect="spectre")
    jcc = elaborate_netlist(deck, dialect="spectre")[0].compile()
    assert_same_circuit(tcc, jcc)
    assert float(tcc.params0()[1]["r"][0]) == 1e6
    _same("dc", tct.dc(tcc), jct.dc(jcc))


def test_spectre_library_sections_like_jax(tmp_path):
    """`include "lib.scs" section=ss` selects the section's parameters in
    both packages (the included file is sniffed as Spectre)."""
    lib = tmp_path / "corners.scs"
    lib.write_text("""
library mylib
section tt
parameters rv=1K
endsection
section ss
parameters rv=3K
endsection
endlibrary
""")
    _, sol, _ = _pair(f"""
simulator lang=spectre
include "{lib}" section=ss
v1 (in 0) vsource dc=4
r1 (in out) resistor r=rv
r2 (out 0) resistor r=1K
""")
    assert float(sol["out"]) == pytest.approx(1.0, rel=1e-9)


def test_circuit_from_file_like_jax(tmp_path):
    """circuit_from_file resolves a relative include against the deck's
    directory, as JAX's does; compile=False gives the Circuit."""
    (tmp_path / "corners.scs").write_text(
        "library l\nsection ss\nparameters rv=3K\nendsection\n"
        "endlibrary\n")
    path = tmp_path / "deck.scs"
    path.write_text("simulator lang=spectre\ninclude \"corners.scs\" "
                    "section=ss\nv1 (in 0) vsource dc=4\n"
                    "r1 (in out) resistor r=rv\nr2 (out 0) resistor r=1K\n")
    tcc = tct.circuit_from_file(str(path), device="cpu")
    assert_same_circuit(tcc, jct.circuit_from_file(str(path)))
    assert float(tct.dc(tcc)["out"]) == pytest.approx(1.0, rel=1e-12)
    cir = tct.circuit_from_file(str(path), compile=False)
    assert isinstance(cir, tct.Circuit) and len(cir.instances) == 3


def test_spectre_bsource_asap7_idiom_like_jax():
    """`bsource v=expr` with $time, pi and **: the same operating point
    and the same transient."""
    deck = """simulator lang=spectre
VScc (VDD 0) vsource type=dc dc=1.8_V
R1 (VDD mid) resistor r=10k
R2 (mid 0) resistor r=10k
VSgate (Vgate 0) bsource v=1.8*(1-sin(10.0**7*2*pi*$time))
Rg (Vgate 0) resistor r=1k
"""
    tcc, sol, _ = _pair(deck)
    assert float(sol["mid"]) == pytest.approx(0.9)
    assert float(sol["Vgate"]) == pytest.approx(1.8)
    t = tct.tran(tcc, (0, 2e-7), dt=1e-9)
    _same("tran", t, jct.tran(jax_parse(deck), (0, 2e-7), dt=1e-9))
    exact = 1.8 * (1 - np.sin(1e7 * 2 * np.pi * _np(t.ts)))
    assert np.abs(_np(t["Vgate"]) - exact).max() < 0.05


def test_spectre_sources_and_tran_like_jax():
    res = _both("""
simulator lang=spectre
v1 (in 0) vsource type=pulse val0=0 val1=1 delay=0 rise=1n fall=1n
r1 (in out) resistor r=1K
c1 (out 0) capacitor c=1u
tr tran stop=5m step=5u
""")
    sol = res["tran"]
    assert bool(sol.converged)
    expect = 1.0 - np.exp(-_np(sol.ts) / 1e-3)
    assert np.max(np.abs(_np(sol["out"]) - expect)) < 5e-3


def test_spectre_vector_pwl_wave_like_jax():
    res = _both("""
simulator lang=spectre
v1 (in 0) vsource type=pwl wave=[0 0 1m 1 2m 1]
r1 (in out) resistor r=1
tr tran stop=2m step=10u
""")
    ts, v = _np(res["tran"].ts), _np(res["tran"]["out"])
    assert v[int(np.argmin(np.abs(ts - 0.5e-3)))] == \
        pytest.approx(0.5, abs=0.02)
    assert v[-1] == pytest.approx(1.0, abs=1e-6)


def test_spectre_sweep_device_param_like_jax():
    """A device-parameter sweep runs its points through `alter`."""
    res = _both("""
simulator lang=spectre
v1 (in 0) vsource dc=6
r1 (in out) resistor r=2K
r2 (out 0) resistor r=1K
sw sweep dev=r1 param=r values=[1K 2K 5K] {
  o1 dc
}
""")
    outs = [float(r["dc"]["out"]) for r in res["sweep"]["runs"]]
    assert outs == pytest.approx([3.0, 2.0, 1.0], rel=1e-9)


def test_spectre_sweep_netlist_param_like_jax():
    """A netlist-parameter sweep re-elaborates each point on the deck's
    device."""
    res = _both("""
simulator lang=spectre
parameters rtop=1K
v1 (in 0) vsource dc=4
r1 (in out) resistor r=rtop
r2 (out 0) resistor r=1K
sw sweep param=rtop start=1K stop=3K step=1K {
  o1 dc
}
""")
    runs = res["sweep"]["runs"]
    outs = [float(r["dc"]["out"]) for r in runs]
    assert outs == pytest.approx([2.0, 4.0 / 3.0, 1.0], rel=1e-9)
    assert {r["dc"].cc.device.type for r in runs} == {"cpu"}


def test_spectre_montecarlo_like_jax():
    """`montecarlo numruns=8 seed=7`: run i draws from default_rng([7, i])
    in both packages, so every run's operating point is JAX's."""
    res = _both("""
simulator lang=spectre
parameters rv=agauss(1K, 100, 1)
v1 (in 0) vsource dc=2
r1 (in out) resistor r=rv
r2 (out 0) resistor r=1K
mc montecarlo numruns=8 seed=7 {
  o1 dc
}
""")
    outs = np.array([float(r["dc"]["out"])
                     for r in res["montecarlo"]["runs"]])
    assert len(outs) == 8
    assert outs.std() > 1e-3
    assert abs(outs.mean() - 1.0) < 0.2


def test_spectre_sweep_of_an_unknown_name_errors_like_jax():
    deck = """
simulator lang=spectre
v1 (in 0) vsource dc=4
r1 (in out) resistor r=1K
r2 (out 0) resistor r=1K
sw sweep param=nosuch values=[1 2] {
  o1 dc
}
"""
    with pytest.raises(ValueError) as want:
        jax_simulate(deck)
    with pytest.raises(ValueError) as got:
        simulate(deck, device="cpu")
    assert str(got.value) == str(want.value)


PARSE_DECKS = {
    "ic_card": """simulator lang=spectre
v1 (in 0) vsource type=dc dc=1
r1 (in out) resistor r=1k
c1 (out 0) capacitor c=1u
ic out=0.25
""",
    "containers": """
simulator lang=spectre
parameters rv=agauss(1K, 100, 1)
statistics {
  process { vary rv dist=gauss std=10 }
}
v1 (in 0) vsource dc=2 mag=1
r1 (in out) resistor r=rv
sw sweep dev=r1 param=r start=1K stop=1M dec=3 {
  o1 dc
  a1 ac start=1 stop=1M dec=5
}
mc montecarlo numruns=2 seed=3 {
  t1 tran stop=1u step=10n
}
""",
    **{k: v[0] for k, v in DC_DECKS.items()},
}


@pytest.mark.parametrize("name", list(PARSE_DECKS))
def test_parse_spectre_cards_like_jax(name):
    """parse_spectre gives JAX's card list: kinds, fields, keywords and
    container bodies (compared by repr, which spells every field)."""
    text = PARSE_DECKS[name]
    got, want = tsp.parse_spectre(text), jsp.parse_spectre(text)
    assert got.title == want.title
    assert repr(got.cards) == repr(want.cards)
    if name == "ic_card":
        assert [c.kind for c in got.cards].count("ic") == 1


def test_dff_from_spectre_text_like_jax():
    """The DFF written by to_spectre: the same text from both packages;
    parsed back, the same 19 unknowns, groups and names as the SPICE DFF,
    parameters bit for bit between the packages, and the same operating
    point."""
    text = to_spectre(tct.parse_spice(tct.dff_netlist(), compile=False))
    assert text == jax_to_spectre(jax_parse(jax_dff(), compile=False))
    tcc, sol, _ = _pair(text)
    spice = tct.parse_spice(tct.dff_netlist(), device="cpu")
    assert tcc.n == spice.n == 19 and tcc.names == spice.names
    assert [(g.model.name, g.n_inst, g.names) for g in tcc.groups] == [
        (g.model.name, g.n_inst, g.names) for g in spice.groups]
    assert bool(sol.converged)
