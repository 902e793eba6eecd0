"""A run on the CPU at a tiny size (the chip's look skipped): the result
line has exactly the contract's keys, and the process holds no module of
JAX or of the JAX package afterwards (a fresh interpreter). The sweep's
mix, whose metrics BENCHMARK.json does not list at present, names them
here."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.core import traffic as tf
wl = tf.load_json("workloads", "dff_mc4096")
wl["params"] = {{"lanes": 4, "tstop": 3e-08, "n_save": 4, "warm_tstop": 1e-09,
                "profile_tstop": 1e-09}}
specs = [{{"name": n, "unit": "-"}} for n in (
    ["op_s.sweep", "newton_pass_ms.sweep", "k1_roofline.sweep",
     "device_idle.sweep"] if {trace} else ["mc_circuits_per_s"])]
res, rows = run.run_cell("dff_mc4096", 2 ** 31 + 101, 0.0, {trace},
                         device="cpu", workload=wl, specs=specs)
run.emit(res, rows)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(trace):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT), trace=trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), out.stderr


def test_result_line_and_no_jax():
    res, mods, err = _run(False)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 4
    # off the card there is no set-up to report
    assert set(res["metrics"]) == {"mc_circuits_per_s"}
    assert set(res["checks"]) == {"op_kcl_A", "wave_max", "failed"}
    assert err.strip().splitlines()[-1].startswith("check failed:")
    assert not {"jax", "jaxlib", "flax", "cadnip_tpu"} & set(mods)


def test_traced_result_line():
    res, mods, _ = _run(True)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"op_s.sweep", "newton_pass_ms.sweep"} <= set(res["metrics"])
    assert not {"jax", "jaxlib", "flax", "cadnip_tpu"} & set(mods)
