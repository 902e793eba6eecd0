"""The cell ekv_dff_k2 (the DFF on Verilog-A EKV devices through K2): a run
through the command itself on the card is correct and reports the cell's
per-layer metrics, and the float32 control comes out not correct."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import control

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_ekv_cell_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ekv_dff_k2",
         "--seed", str(2 ** 31 + 2121 + trace), "--seconds", "1",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["kind"] == card
    if trace:
        for m in ("k2_group_eval_cycles.job", "va_pack_ms.job",
                  "k2_roofline.job", "k2_cycles_per_newton.job"):
            assert m in res["metrics"], m
        assert res["metrics"]["k2_roofline.job"]["value"] <= 100.0
    else:
        assert {"setup_s", "tran_s"} == set(res["metrics"])


@pytest.mark.gpu
def test_ekv_control_is_not_correct(card):
    """The reference in float32 in the program's place, one job over the
    cell's whole span: not correct (its operating point and its transient
    read beyond the cell's limits)."""
    r = control.control("ekv_dff_k2", 2 ** 31 + 99, jobs=1)
    assert r["correct"] is False


def _run(timings, nnewton=100):
    import types
    return types.SimpleNamespace(jobs=[{"timings": t, "nnewton": nnewton}
                                       for t in timings])


def test_new_readers_read_the_ports_counter_and_span():
    """k2_group_eval_cycles.job is the group's cycles per Newton iteration
    over the jobs, va_pack_ms.job the mean `prepare.pack.va` span; both
    read nothing where the port counts or opens none (a port without
    them)."""
    from benchmark import run
    cyc, va = run.reader("k2_group_eval_cycles.job"), run.reader(
        "va_pack_ms.job")
    jobs = [{"integrate.group_cycles#n": 700_000, "prepare.pack.va": 1e-3},
            {"integrate.group_cycles#n": 900_000, "prepare.pack.va": 3e-3}]
    assert cyc(_run(jobs)) == 8000.0
    assert va(_run(jobs)) == 2.0
    assert cyc(_run([{}])) is None and va(_run([{"prepare.pack": 1.0}])) \
        is None
