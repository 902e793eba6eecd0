"""Every file BENCHMARK.json names, and every file the harness finds by
name, is there and loads."""
import json
from pathlib import Path

import pytest

from benchmark import run
from benchmark.core import traffic as tf

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_workload_loads(cell):
    wl = tf.load_json("workloads", cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"]
    assert wl["chips"] == entry["chips"]
    cfg = tf.load_json("configs", wl["config"])
    mix = tf.load_json("traffic", wl["traffic"])
    assert (ROOT / "benchmark" / "entries" / f"{mix['entry']}.py").is_file()
    assert "${" not in tf.render(cfg)
    assert wl["check"]["limits"]


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file(name):
    c = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == name and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads(name):
    assert callable(run.reader(name))


def test_every_cell_reports_setup_and_its_moves():
    for cell in CELLS:
        e2e = {m["name"] for m in run.metric_specs(cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = run.metric_specs(cell, True)
        assert layers
        assert all(m["moves"] in e2e for m in layers)


def test_unknown_workload_is_refused():
    assert run.main(["--workload", "no_such_cell", "--seed", "1",
                     "--seconds", "1"]) == 2
