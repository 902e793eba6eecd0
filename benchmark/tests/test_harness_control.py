"""The lower-precision control (the reference in float32 in the program's
place, `control.py`) comes out not correct, at sizes a test run holds.
On the chip it runs at each cell's own size (PERF.md gives the readings).
The control's number lies over its limit by more than half the limit: the
float32 operating point's largest KCL residual (4.88e-11 A) against the
limit of 3e-11 A that the float64 lanes' largest (1.53e-11 A) leaves."""
import pytest

from benchmark import control

CASES = [
    ("dff_mc4096", {"lanes": 64, "tstop": 1.2e-07, "n_save": 13}, "op_kcl_A"),
    ("dff_k2", {"tstop": 1.2e-07}, "op_kcl_A"),
    ("graetz_k2", {"tstop": 4e-02}, "wave_max"),
]


@pytest.mark.parametrize("cell,params,fails", CASES,
                         ids=[c for c, _, _ in CASES])
def test_control_is_not_correct(cell, params, fails):
    r = control.control(cell, 2 ** 31 + 99, params=params)
    assert r["correct"] is False
    c = r["checks"][fails]
    assert c["value"] > 1.5 * c["limit"] or c["value"] != c["value"]
