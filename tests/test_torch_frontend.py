"""SPICE front end of the port (cadnip_tpu_torch/frontend) against the JAX
package: the compiled circuit field by field for the DFF benchmark, for
the tests/test_frontend.py decks, for a deck of every once-deferred element
(L, K, E, G, F, H, Q) and the darlington, and the features that are not
ported yet raising NotImplementedError."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.frontend.elaborate import parse_spice as jax_parse
from cadnip_tpu.models.dff import dff_netlist as jax_dff
from cadnip_tpu_torch.frontend.expressions import parse_number
from cadnip_tpu_torch.frontend.elaborate import parse_spice
from cadnip_tpu_torch.interop import params_from_numpy, to_numpy

torch.set_num_threads(1)

DECKS = {
    "divider": ("""divider test
v1 in 0 5
r1 in out 1k
r2 out 0 1k
.end
""", "out"),
    "params": ("""params
.param rbase=1k rtop={rbase*3} vin={2+3}
v1 in 0 {vin}
r1 in out {rtop}
r2 out 0 {rbase}
""", "out"),
    "toposort": ("""toposort
.param a={b*2}
.param b=1k
v1 in 0 1
r1 in out {a}
r2 out 0 {b}
""", "out"),
    "subckt": ("""sub test
.subckt divider hi lo mid ratio=0.5
rtop hi mid {1k*(1-ratio)}
rbot mid lo {1k*ratio}
.ends
v1 in 0 4
x1 in 0 a divider
x2 in 0 b divider ratio=0.25
""", "b"),
    "nested": ("""nested
.subckt inner a b
r1 a mid 1k
r2 mid b 1k
.ends
.subckt outer x y
xi x y inner
.ends
v1 in 0 2
xo in 0 outer
""", "xo.xi.mid"),
    "mos_inverter": ("""inv
.model mynmos nmos (level=1 vto=1.0 kp=200u lambda=0.01)
vdd vdd 0 5
vin g 0 0
rd vdd d 10k
m1 d g 0 0 mynmos w=10u l=1u
""", "d"),
    "diode_card": ("""rectifier
.model dx d is=76.9p bv=1.00k ibv=5.00u cjo=26.5p m=0.333 n=1.45
v1 in 0 5
r1 in a 1k
d1 a 0 dx
""", "a"),
    "waves": ("""waves
vs in 0 dc 0 pulse 0 1 1u 1u 1u 1m 2m
r1 in out 1k
c1 out 0 1u
""", "out"),
    "if_blocks": ("""cond
.param fast=1
.if (fast > 0)
r1 in out 1k
.else
r1 in out 2k
.endif
v1 in 0 3
r2 out 0 1k
""", "out"),
    "title_comments": ("""* the title is this comment line
v1 in 0 1 ; trailing comment
r1 in 0 1k $ another
""", "in"),
    "binned": ("""binned
vd d 0 dc 1.8
vg g 0 dc 1.8
m1 d g 0 0 nch w=2u l=0.5u
m2 d g 0 0 nch w=2u l=2u
.model nch.1 nmos lmin=0.1u lmax=1u wmin=0.1u wmax=10u vto=0.4 kp=200u
.model nch.2 nmos lmin=1u lmax=100u wmin=0.1u wmax=10u vto=0.7 kp=100u
""", "vd#i"),
}


def _jax_params_np(jcc):
    return [jax.tree.map(np.asarray, d) for d in jcc.params0()]


def assert_same_circuit(tcc, jcc):
    assert tcc.n == jcc.n and tcc.title == jcc.title
    assert tcc.node_names == jcc.node_names
    assert tcc.names == jcc.names
    np.testing.assert_array_equal(tcc.classes, jcc.classes)
    assert tcc.param_slots == jcc.param_slots
    assert tcc.inst_group == jcc.inst_group
    assert len(tcc.groups) == len(jcc.groups)
    for tg, jg in zip(tcc.groups, jcc.groups):
        assert tg.model.name == jg.model.name and tg.names == jg.names
        np.testing.assert_array_equal(tg.conn, jg.conn)
    tp = to_numpy(tcc.params0())
    for td, jd in zip(tp, _jax_params_np(jcc)):
        assert set(td) == set(jd)
        for k, v in jd.items():
            if isinstance(v, dict):       # the packed waveforms
                for kk, vv in v.items():
                    np.testing.assert_array_equal(td[k][kk], vv)
            else:
                np.testing.assert_array_equal(td[k], v)


def test_dff_compiles_identically():
    tcc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    jcc = jax_parse(jax_dff())
    assert tct.dff_netlist() == jax_dff()
    assert_same_circuit(tcc, jcc)
    assert tcc.n == 19
    assert [(g.model.name, g.n_inst) for g in tcc.groups] == [
        ("vsource", 4), ("mos1", 26), ("capacitor", 1)]


@pytest.mark.parametrize("deck", list(DECKS))
def test_deck_compiles_identically_and_solves(deck):
    text, node = DECKS[deck]
    tcc, jcc = parse_spice(text, device="cpu"), jax_parse(text)
    assert_same_circuit(tcc, jcc)
    # the same operating point from the same parameters
    params = params_from_numpy(_jax_params_np(jcc), device="cpu")
    tsol, jsol = tct.dc(tcc, params), jct.dc(jcc)
    assert bool(tsol.converged) and bool(jsol.converged)
    np.testing.assert_allclose(float(tsol[node]), float(jsol[node]),
                               rtol=1e-9, atol=1e-15)


def test_number_magnitudes():
    assert parse_number("1k") == 1e3
    assert parse_number("1MEG") == 1e6
    assert parse_number("10pF") == pytest.approx(10e-12, rel=1e-12)
    assert parse_number("1mil") == pytest.approx(25.4e-6, rel=1e-12)
    assert parse_number("abc") is None


#: every once-deferred element: a K before its second inductor, an F
#: whose sensed source comes later in the deck and one whose source came
#: before, an H inside a subcircuit sensing that subcircuit's source (its
#: prefix) before the source's line, npn and pnp cards
ELEMENTS = """every once-deferred element
.model qn npn bf=80 is=1e-15 vaf=50 cje=1p cjc=0.5p tf=0.1n
.model qp pnp bf=50 is=2e-15
.subckt sense in out
h1 out 0 vs 100
vs in mid 0
r1 mid 0 1k
.ends
v1 in 0 dc 1 ac 1
e1 a 0 in 0 2
r1 a b 100
l1 b c 1u
c1 c 0 1n
k1 l1 l2 0.5
l2 d 0 4u
r2 d 0 50
g1 0 e in 0 1m
re e 0 1k
f1 0 f vlate 3
rf f 0 1k
f2 0 f2n v1 0.5
rf2 f2n 0 1k
rl in g 2k
vlate g 0 0
x1 in hout sense
rh hout 0 10k
vcc vcc 0 5
rc vcc col 1k
q1 col bb 0 qn
rbb in bb 10k
q2 0 pb pe qp
rpe vcc pe 2k
rpb pb 0 10k
.end
"""


@pytest.mark.parametrize("name", ["elements", "darlington"])
def test_once_deferred_elements_compile_identically_and_solve(name):
    """L, K, E, G, F, H and Q from SPICE, compiled field by field against
    cadnip_tpu.parse_spice (names, conn with the sense columns, the
    parameters with the mutual's m = k sqrt(L1 L2)), and the same
    operating point from the same parameters."""
    from cadnip_tpu_torch.models.vacask import DARLINGTON
    text = ELEMENTS if name == "elements" else DARLINGTON
    tcc, jcc = parse_spice(text, device="cpu"), jax_parse(text)
    assert_same_circuit(tcc, jcc)
    models = {g.model.name for g in tcc.groups}
    if name == "elements":
        assert models >= {"inductor", "mutual", "vcvs", "vccs", "cccs",
                          "ccvs", "bjt"}
        gi, slot = tcc.inst_group["k1"]
        g = tcc.groups[gi]
        assert g.params["m"][slot] == pytest.approx(0.5 * np.sqrt(4e-12),
                                                    rel=1e-15)
        # the sense columns hold the sensed branch unknowns
        assert list(g.conn[slot]) == [tcc.names["l1#i"], tcc.names["l2#i"]]
        gi, slot = tcc.inst_group["x1.h1"]
        assert tcc.groups[gi].conn[slot][2] == tcc.names["x1.vs#i"]
        gi, slot = tcc.inst_group["f1"]
        assert tcc.groups[gi].conn[slot][2] == tcc.names["vlate#i"]
        gi, slot = tcc.inst_group["q2"]
        assert tcc.groups[gi].params["type"][slot] == -1.0
    else:
        assert models == {"vsource", "resistor", "bjt", "capacitor"}
        assert tcc.n == 7
    params = params_from_numpy(_jax_params_np(jcc), device="cpu")
    tsol, jsol = tct.dc(tcc, params), jct.dc(jcc)
    assert bool(tsol.converged) and bool(jsol.converged)
    assert int(tsol.iters) == int(jsol.iters)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("line, what", [
    ("f1 0 b r1 2", "has no branch current"),
    ("l1 a b 1u\nk1 l1 l9 0.5", "couples unknown inductors"),
])
def test_bad_sense_targets_error_like_jax(line, what):
    """A CCCS sensing a resistor, a K coupling an inductor that does not
    exist: the JAX package's error, word for word."""
    deck = f"bad sense\nv1 a 0 1\nr1 a 0 1k\nr2 b 0 1k\n{line}\n"
    with pytest.raises(ValueError) as want:
        jax_parse(deck)
    with pytest.raises(ValueError) as got:
        parse_spice(deck, device="cpu")
    assert str(got.value) == str(want.value)
    assert what in str(got.value)


@pytest.mark.parametrize("line, what", [
    ("l1 a 0 1n", "inductor"),
    ("e1 a 0 b 0 2", "vcvs"),
    ("q1 a b 0 qn", "bjt"),
])
def test_once_deferred_lines_build_like_jax(line, what):
    """The element lines that raised before this slice's devices existed
    now compile to the JAX package's circuit."""
    deck = f"deferred\nv1 b 0 1\nr1 a 0 1k\n.model qn npn\n{line}\n"
    tcc = parse_spice(deck, device="cpu")
    assert_same_circuit(tcc, jax_parse(deck))
    assert tcc.groups[-1].model.name == what


@pytest.mark.parametrize("line, what", [
    ("simulator lang=spectre", "the Spectre dialect"),
    (".hdl \"diode.va\"", "Verilog-A"),
    ("ma a b 0 0 m2 w=1u l=1u\n.model m2 nmos level=49", "tier-1"),
    ("qv a b 0 q4\n.model q4 npn level=4", "tier-1"),
])
def test_not_ported_features_raise(line, what):
    """The features that once raised NotImplementedError in the port now
    behave as in the JAX package: a deck that turns Spectre mid-way, a
    missing `.hdl` file and a level card without the VA model files give
    the JAX package's circuit, or its error word for word."""
    deck = f"deferred\nv1 b 0 1\nr1 a 0 1k\n.model qn npn\n{line}\n"
    try:
        want = jax_parse(deck)
    except (OSError, ValueError) as e:
        # each package raises its own ElabError, a ValueError
        with pytest.raises(OSError if isinstance(e, OSError)
                           else ValueError) as got:
            parse_spice(deck, device="cpu")
        assert str(got.value) == str(e)
        return
    assert_same_circuit(parse_spice(deck, device="cpu"), want)


def test_unknown_bin_still_errors():
    deck = """binned miss
vd d 0 dc 1.8
m1 d d 0 0 nch w=2u l=50u
.model nch.1 nmos lmin=0.1u lmax=1u vto=0.4
"""
    with pytest.raises(ValueError, match="no bin"):
        parse_spice(deck, device="cpu")


@pytest.mark.parametrize("entry", ["parse_spice", "montecarlo_elaborate",
                                   "compile", "params_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without `device` the entry points build on the card; where there is
    none they raise instead of quietly building a CPU circuit. Whether a
    card is present is decided here, at run time."""
    from cadnip_tpu_torch.frontend.elaborate import montecarlo_elaborate
    deck = "divider\nv1 in 0 5\nr1 in out 1k\nr2 out 0 1k\n"
    calls = {
        "parse_spice": lambda: parse_spice(deck).device,
        "montecarlo_elaborate": lambda: montecarlo_elaborate(
            deck, 2, seed=1)[0].device,
        "compile": lambda: parse_spice(deck, compile=False).compile().device,
        "params_from_numpy": lambda: params_from_numpy(
            [{"r": np.ones(2)}])[0]["r"].device}
    if torch.cuda.is_available():
        assert calls[entry]().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            calls[entry]()
