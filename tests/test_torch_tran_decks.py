"""Four `tran` paths that the port's tests held only against a closed form,
now against the JAX package's `tran` on the CPU: a gear2 transient, a deck
at `.temp 85`, EXP and SFFM sources, and `uic` with `ic=` on a nonlinear
circuit (a level-1 CMOS inverter). The periodic seed of `tran_pit` and its
`uic`/`ic` start go through the same `tran` code. Accepted, rejected and
Newton counts equal; waveforms within 1e-9 of each deck's scale."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu_torch.interop import params_from_numpy

torch.set_num_threads(1)

RECTIFIER = """diode rectifier driven by a sine
.model dd d is=1e-14 n=1.5 cjo=2p
vs in 0 sin 0 5 1meg
d1 in out dd
c1 out 0 1n
r1 out 0 1k
.end
"""

EXP_SFFM = """two rc sections driven by exp and sffm sources
v1 a 0 exp 0 1 10n 20n 200n 50n
r1 a b 1k
c1 b 0 10p
v2 c 0 sffm 0 1 20meg 2 2meg
r2 c d 1k
c2 d 0 5p
.end
"""

INVERTER = """level-1 cmos inverter
.model nm nmos (level=1 vto=0.7 kp=100u lambda=0.02 cgso=2f cgdo=2f)
.model pm pmos (level=1 vto=-0.7 kp=50u lambda=0.02 cgso=2f cgdo=2f)
vdd vdd 0 3.3
vin in 0 pulse 0 3.3 2n 0.5n 0.5n 5n 10n
m1 out in 0 0 nm w=1u l=1u
m2 out in vdd vdd pm w=2u l=1u
c1 out 0 50f
.end
"""

DECKS = {
    "gear2": (RECTIFIER, (0, 3e-6), dict(dt=1e-8, integ="gear2"), 5.0),
    "temp85": (RECTIFIER.replace(".end", ".temp 85\n.end"), (0, 3e-6),
               dict(dt=1e-8, integ="gear2"), 5.0),
    "exp_sffm": (EXP_SFFM, (0, 5e-7), dict(dt=1e-9), 1.0),
    "uic_ic": (INVERTER, (0, 3e-8), dict(dt=1e-10, uic=True,
                                         ic={"out": 3.3}), 3.3),
}


def counts(st):
    return tuple(int(np.asarray(v)) for v in st[:3])


@pytest.mark.parametrize("name", sorted(DECKS))
def test_tran_matches_jax(name):
    net, span, kw, scale = DECKS[name]
    jcc = jct.parse_spice(net)
    tcc = tct.parse_spice(net, device="cpu")
    p = params_from_numpy([jax.tree.map(np.array, d)
                           for d in jcc.params0()], device="cpu")
    sol = tct.tran(tcc, span, p, **kw)
    ref = jct.tran(jcc, span, **kw)
    assert bool(sol.converged) and bool(np.asarray(ref.converged))
    assert counts(sol.stats) == counts(ref.stats)
    assert sol.xs.shape == np.asarray(ref.xs).shape
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= 1e-9 * scale, err
    if name == "uic_ic":
        assert float(sol["out"][0]) == 3.3
    if name == "temp85":
        assert tcc.spec.temp_c == 85.0
