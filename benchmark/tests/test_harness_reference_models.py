"""The reference's registry of device and source models (`reference/
registry.py`, `reference/models/`): the EKV MOSFET behind `.hdl`, PULSE and
current sources, each against the program on the CPU and judged by
`core/check.judge` as a unit; the hand-written Jacobians against central
differences; an unknown model refused; and a `dff_k2` unit judged as the
harness judged it before the registry. (The reference imports nothing of
the program; these tests import both.)"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import cadnip_tpu_torch as ct
import chip_smoke
from benchmark import control
from benchmark.core import check as chk
from benchmark.reference import devices, mna, netlist, registry
from benchmark.reference.models import ekv26
from cadnip_tpu_torch.models.ekv import EKV_VA
from cadnip_tpu_torch.models.vacask import RC_NETLIST

HERE = Path(__file__).resolve().parent
REFERENCE = HERE.parent / "reference"
VT = devices.thermal_voltage(27.0)

# dff_k2's limits (workloads/dff_k2.json): the EKV DFF has the level-1
# DFF's topology, drives and scale, so the EKV cell that follows is held
# to the same numbers
OP_KCL_A, WAVE_MAX = 3e-11, 8e-3

I_DECK = """a pulse of current into a resistor and a capacitor
i1 0 1 pulse 0 1m 10u 1u 1u 200u 500u
r1 1 0 1k
c1 1 0 100n
.end
"""


def _unit(text, cc, sol, tstop, final=None):
    return {"text": text, "names": dict(cc.names),
            "x0": sol.xs[:1].numpy(), "final": final,
            "sampled": np.array([0]), "xs": sol.xs.numpy()[None],
            "ts": np.asarray(sol.ts), "tstop": tstop}


def _judge(unit, scale_v, reltol=1e-5):
    return chk.combine([chk.judge(unit, {"scale_v": scale_v},
                                  {"reltol": reltol})])


# ---------------------------------------------------------------------------
# ekv26's equations

def _ekv_points(seed, sign):
    """Seeded bias points from weak to strong inversion, forward and
    reverse, for one polarity: u [1, I, 4] (d, g, s, b) and the cards'
    parameters."""
    gen = np.random.default_rng([seed, int(sign > 0)])
    I = 64
    vgb = gen.uniform(-0.5, 5.0, I)             # vp from far below to above
    vsb = gen.uniform(0.0, 2.0, I)
    vds = gen.uniform(0.05, 3.0, I) * np.where(np.arange(I) % 2, 1.0, -1.0)
    vb = gen.uniform(-1.0, 1.0, I)
    u = np.stack([vb + sign * (vsb + vds), vb + sign * vgb,
                  vb + sign * vsb, vb], -1)[None]
    p = {k: np.full((1, I), v) for k, v in ekv26.PARAMS.items()}
    p.update(sign=np.full((1, I), float(sign)),
             vto=gen.uniform(0.4, 1.0, (1, I)),
             kp=gen.uniform(50e-6, 200e-6, (1, I)),
             w=gen.uniform(0.2e-6, 2e-6, (1, I)),
             l=gen.uniform(0.5e-6, 1e-6, (1, I)),
             cgso=np.full((1, I), 5e-9), cgdo=np.full((1, I), 6e-9))
    p["lambda"] = np.full((1, I), 0.05)
    return u, p


@pytest.mark.parametrize("sign", [1, -1], ids=["nmos", "pmos"])
def test_ekv26_jacobians_are_the_derivatives(sign):
    """G and C against central differences of f and q in float64, at 64
    seeded points from weak to strong inversion, forward and reverse, to
    1e-6 of each row's largest entry; the currents and charges sum to 0."""
    u, p = _ekv_points(2 ** 31 + 26, sign)
    f, q, G, C = ekv26.evaluate(u, p, VT, 1e-12)
    h = 1e-6
    for j in range(4):
        du = np.zeros_like(u)
        du[..., j] = h
        fp, qp, _, _ = ekv26.evaluate(u + du, p, VT, 1e-12)
        fm, qm, _, _ = ekv26.evaluate(u - du, p, VT, 1e-12)
        for J, num in ((G, (fp - fm) / (2 * h)), (C, (qp - qm) / (2 * h))):
            row = np.abs(J).max(-1)
            assert (np.abs(J[..., j] - num) <= 1e-6 * row).all()
    # weak inversion reached, and strong: the drain currents span decades
    ids = np.abs(f[..., 0])
    assert ids.min() < 1e-9 < 1e-5 < ids.max()
    assert np.abs(f.sum(-1)).max() <= 1e-15 * np.abs(f).max()
    assert np.abs(q.sum(-1)).max() <= 1e-14 * np.abs(q).max()


def test_ekv26_reverses_under_a_drain_source_swap():
    """Swapping drain and source negates the drain current and keeps the
    charges' partition: the channel is symmetric."""
    u, p = _ekv_points(2 ** 31 + 27, 1)
    f, q, _, _ = ekv26.evaluate(u, p, VT, 1e-12)
    us = u[..., [2, 1, 0, 3]]
    fs, qs, _, _ = ekv26.evaluate(us, p, VT, 1e-12)
    assert np.allclose(fs[..., 0], -f[..., 0], rtol=1e-12, atol=0)
    p0 = dict(p, cgso=np.zeros_like(p["cgso"]),
              cgdo=np.zeros_like(p["cgdo"]))
    _, q0, _, _ = ekv26.evaluate(u, p0, VT, 1e-12)
    _, q0s, _, _ = ekv26.evaluate(us, p0, VT, 1e-12)
    assert np.allclose(q0s[..., [2, 1, 0, 3]], q0, rtol=1e-12, atol=1e-30)


# ---------------------------------------------------------------------------
# the program against the reference, as units of the check

def test_ekv_dff_is_judged_as_a_unit(tmp_path):
    """The EKV DFF of chip_smoke.py (`.hdl` of models/ekv.py's EKV_VA, 26
    ekv26 instances, 35 capacitors) through the program's `tran` on the
    CPU over the first two clock edges, 0-120 ns at tests/
    test_torch_ekv_dff.py's step, judged by the check at dff_k2's
    limits."""
    path = tmp_path / "ekv26.va"
    path.write_text(EKV_VA)
    text = chip_smoke.ekv_dff_netlist(str(path))
    net = netlist.parse(text)
    assert net.hdl == [str(path)]
    assert {e.kind for e in net.elements} == {"v", "ekv26", "c"}
    torch.set_num_threads(1)
    cc = ct.parse_spice(text, device="cpu")
    sol = ct.tran(cc, (0.0, 1.2e-7), dt=3.333e-10)
    assert bool(sol.converged)
    r = _judge(_unit(text, cc, sol, 1.2e-7), 5.0)
    print(json.dumps(r))         # read: 4.3e-19 A and 7.3e-4
    assert r["op_kcl_A"] < OP_KCL_A
    assert r["wave_max"] < WAVE_MAX


def test_pulse_source_against_the_programs_rc():
    """The VACASK rc (a PULSE into an RC, tau 1 ms) through the program's
    `tran_linear` on the CPU over 0-4 ms, two periods, judged as a unit;
    the same waveform judged against the deck with its pulse 10 us late
    reads the pulse's whole height."""
    cc = ct.parse_spice(RC_NETLIST, device="cpu")
    sol = ct.tran_linear(cc, (0.0, 4e-3), 1e-6)
    unit = _unit(RC_NETLIST, cc, sol, 4e-3)
    r = _judge(unit, 1.0)
    print(json.dumps(r))
    # read 5.4e-4: the reference's own rows, interpolated linearly between
    # its steps of up to span / 50, carry most of it
    assert r["op_kcl_A"] < 1e-15
    assert r["wave_max"] < 2e-3
    late = RC_NETLIST.replace("pulse 0 1 1u", "pulse 0 1 11u")
    assert _judge(dict(unit, text=late), 1.0)["wave_max"] > 0.9


def test_current_source_against_the_program():
    """A PULSE current source into R || C (1 V across 1 kOhm, tau 100 us)
    through the program's `tran_linear` on the CPU over 0-1 ms, judged as a
    unit; the source's direction reversed reads twice the response."""
    cc = ct.parse_spice(I_DECK, device="cpu")
    sol = ct.tran_linear(cc, (0.0, 1e-3), 1e-6)
    assert float(sol.xs[:, cc.names["1"]].max()) > 0.85
    unit = _unit(I_DECK, cc, sol, 1e-3)
    r = _judge(unit, 1.0)
    print(json.dumps(r))
    assert r["op_kcl_A"] < 1e-15
    assert r["wave_max"] < 2e-3           # read 6.0e-4, as the rc's
    flipped = I_DECK.replace("i1 0 1", "i1 1 0")
    assert _judge(dict(unit, text=flipped), 1.0)["wave_max"] > 1.5


def test_pulse_corners_and_spice_defaults():
    """PULSE's value and corners as SPICE3 reads it: omitted or zero tr
    and tf take the .tran card's step, pw and per its stop; without a
    .tran card such a PULSE is refused."""
    text = "t\nv1 1 0 pulse(0 2 1u 0 0)\nr1 1 0 1k\n.tran 0.1u 10u\n.end\n"
    net = netlist.parse(text)
    wave = net.elements[0].wave
    u, step, stop = (netlist.value(t) for t in ("1u", "0.1u", "10u"))
    assert wave == ("pulse", 0.0, 2.0, u, step, step, stop, stop)
    cir = mna.Circuit(net)
    assert cir.breakpoints(0.0, 5e-6) == [u, u + step, 5e-6]
    for t, v in ((0.5e-6, 0.0), (1.05e-6, 1.0), (3e-6, 2.0)):
        cir.set_time(t)
        assert abs(-cir._src[0, cir.internal_index["v1#i"]] - v) < 1e-12
    with pytest.raises(ValueError, match="tran"):
        netlist.parse(text.replace(".tran 0.1u 10u\n", ""))


def test_control_runs_on_every_registered_device(tmp_path):
    """control.py's float32 unit, unchanged, on decks of the new models
    (ekv26 behind .hdl, a PULSE V source, a current source): the float32
    operating point and transient run and the check reads them. The rc and
    the current source integrate in float32; the EKV DFF's float32
    transient does not converge at reltol 1e-5, which counts against the
    control as a failed job."""
    path = tmp_path / "ekv26.va"
    path.write_text(EKV_VA)
    for text, tstop, n_save, integrates in (
            (chip_smoke.ekv_dff_netlist(str(path)), 2e-8, 61, False),
            (RC_NETLIST, 4e-3, 401, True), (I_DECK, 1e-3, 101, True)):
        ts = np.linspace(0.0, tstop, n_save)
        unit, ok = control._unit(text, None, 1, tstop, ts, [0], 1e-5, True)
        assert ok is integrates
        r = _judge(unit, 1.0)
        print(json.dumps(r))
        assert np.isfinite(r["op_kcl_A"]) and "wave_max" in r


# ---------------------------------------------------------------------------
# the registry

BAD_DECKS = {
    "unknown_type": ("t\n.model q1 bsim4 (vth0=0.4)\nm1 d g 0 0 q1\n"
                     "v1 d 0 1\nv2 g 0 1\n.end\n", "bsim4"),
    "other_level": ("t\n.model n1 nmos (level=8)\nm1 d g 0 0 n1\n"
                    "v1 d 0 1\nv2 g 0 1\n.end\n", "level"),
    "unknown_card_parameter": ("t\n.model n1 nmos (tox=1e-8)\n"
                               "m1 d g 0 0 n1\nv1 d 0 1\nv2 g 0 1\n.end\n",
                               "tox"),
    "wrong_letter": ("t\n.model dx d (rs=1)\nm1 d g 0 0 dx\n"
                     "v1 d 0 1\nv2 g 0 1\n.end\n", "no .model card"),
    "unknown_instance_parameter": ("t\n.model n1 ekv26 (vto=0.5)\n"
                                   "m1 d g 0 0 n1 vto=0.6\nv1 d 0 1\n"
                                   "v2 g 0 1\n.end\n", "vto"),
    "unknown_element": ("t\nq1 c b e qmod\n.end\n", "q1"),
}


@pytest.mark.parametrize("case", list(BAD_DECKS))
def test_what_the_reference_does_not_model_raises(case):
    text, word = BAD_DECKS[case]
    with pytest.raises(ValueError, match=word):
        mna.Circuit(netlist.parse(text))


def test_every_model_module_declares_what_the_registry_reads():
    names = sorted(p.stem for p in (REFERENCE / "models").glob("[a-z]*.py"))
    assert {"r", "c", "v", "i", "d", "nmos", "pmos", "ekv26"} <= set(names)
    for name in names:
        mod = registry.module(name)
        assert mod.LETTER == name[0] or mod.CARD
        assert callable(mod.evaluate)
        assert set(mod.INSTANCE) <= set(mod.PARAMS)
        assert not (mod.SOURCE and mod.CARD)


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for path in REFERENCE.rglob("*.py"):
        bad = _imports(path) & {"cadnip_tpu_torch", "cadnip_tpu", "torch",
                                "jax", "jaxlib", "flax"}
        assert not bad, (path, bad)


def _strings(path):
    """The string constants of a file, its docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs}


def test_the_check_and_the_mna_name_no_device():
    kinds = {p.stem for p in (REFERENCE / "models").glob("*.py")} - {
        "__init__"}
    kinds |= {"m", "q", "mos1", "diode", "#i", "#int"}
    for path in (REFERENCE / "mna.py", HERE.parent / "core" / "check.py"):
        assert not _strings(path) & kinds, path


# ---------------------------------------------------------------------------
# what the harness judged before the registry

def test_dff_k2_unit_reads_as_before():
    """A dff_k2 unit (a pool draw of the cell through the program's
    vmem_tran on the CPU, 0-60 ns, saved in fixtures/) judged through the
    registry gives, bit for bit, the numbers the harness gave before the
    registry (stored beside it)."""
    meta = json.loads((HERE / "fixtures" / "dff_k2_unit.json").read_text())
    arr = np.load(HERE / "fixtures" / "dff_k2_unit.npz")
    unit = {"text": meta["text"], "names": meta["names"],
            "tstop": meta["tstop"], "sampled": np.array([0]),
            **{k: arr[k] for k in arr.files}}
    from benchmark.core import traffic as tf
    cfg = tf.load_json("configs", "dff_gf180")
    wl = tf.load_json("workloads", "dff_k2")
    r = chk.judge(dict(unit), cfg, wl["check"])
    was = meta["parent_numbers"]
    assert r["op_kcl_lanes"].tolist() == was["op_kcl_lanes"]
    assert r["final_kcl_A"] == was["final_kcl_A"]
    assert r["wave_max"] == was["wave_max"]
    assert r["reference_steps"] == was["reference_steps"]
    ok, rows = chk.verdict(chk.combine([r]), wl["check"]["limits"])
    assert [ok, [[n, v, lim] for n, v, lim in rows]] == was["verdict"]
