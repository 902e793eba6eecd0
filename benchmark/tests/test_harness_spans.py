"""The readers of the port's spans (`cadnip_tpu_torch/obs.py`) on a short
dff_k2 window on the CPU: each of the seven reports a finite number, the
operating point and K2's set-up add up to `op_s.job`, and a job record
without spans (an older port) gives nothing rather than an error."""
import math
import types

from benchmark import run
from benchmark.core import traffic as tf

SEED = 2 ** 31 + 17
SPANS = ["dc_s.job", "dc_iters.job", "dc_iter_ms.job", "dc_wait_ms.job",
         "dc_build_ms.job", "k2_setup_ms.job", "k2_host_ms.job"]


def test_span_metrics_on_a_short_window():
    wl = tf.load_json("workloads", "dff_k2")
    wl["params"] = {"tstop": 6e-08}
    specs = [{"name": n, "unit": "-"} for n in SPANS + ["op_s.job"]]
    res, rows = run.run_cell("dff_k2", SEED, 0.0, False, device="cpu",
                             workload=wl, specs=specs)
    assert res["correct"] is True, rows
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(SPANS) | {"op_s.job"}
    assert all(math.isfinite(v) and v >= 0 for v in m.values())
    assert math.isclose(m["dc_s.job"] + m["k2_setup_ms.job"] / 1e3,
                        m["op_s.job"], rel_tol=0.01)
    assert m["dc_iters.job"] >= 1
    assert m["dc_wait_ms.job"] <= m["dc_iter_ms.job"]
    assert (m["dc_iter_ms.job"] * m["dc_iters.job"] + m["dc_build_ms.job"]
            <= m["dc_s.job"] * 1e3)


def test_span_metrics_without_spans_give_nothing():
    # the record of a port that opens no span: the two hand-timed keys
    jobs = [{"timings": {"prepare": 1.7, "integrate": 0.05}}] * 2
    r = types.SimpleNamespace(jobs=jobs)
    assert all(run.reader(n)(r) is None for n in SPANS)
