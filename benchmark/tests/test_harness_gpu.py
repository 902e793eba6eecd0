"""On the card: one short run of a cell through the command itself gives a
correct result on the card it names, and no JAX module."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_job_cell_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dff_k2",
         "--seed", str(2 ** 31 + 2024 + trace), "--seconds", "1",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == card
    if trace:
        assert res["device"]["busy_s"] > 0
        assert "k2_cycles_per_newton.job" in res["metrics"]
    else:
        assert {"setup_s", "tran_s"} == set(res["metrics"])
