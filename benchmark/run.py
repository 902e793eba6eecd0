"""The benchmark of cadnip_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is `workloads/<cell>.json`: its configuration (`configs/<name>.json`
and the netlist template it names: the circuit, its span and step, the
values the seed draws), its traffic mix (`traffic/<mix>.json`: the entry,
`entries/<entry>.py`, that runs one job through the program, and the
entry's parameters, which may cut the configuration's span), the cards it
needs, and the check (how many lanes or jobs the reference re-runs, and
each compared number's limit). Which metrics a cell reports, and with which
unit, is read from BENCHMARK.json; each metric is computed by its reader
`metrics/<metric>.py` (or `metrics/<stem>.py`, shared by `<stem>.job` and
`<stem>.sweep`). So a later cell on an existing entry, or a further
metric, is a new file and a new entry in BENCHMARK.json.

A run: set-up (imports, the card, the kernels' libraries, the circuit,
one warm-up of the cell's own shapes), then jobs one after another, each
starting when the last ends, until the clock passes --seconds (the job in
flight finishes and counts). With --trace 1 a bounded further piece of
work runs under torch.profiler. Then the device's peak memory is read,
the program's state is freed, and the reference judges what the jobs
produced. Every compared number and its limit go to stderr, and the
result, one JSON object, is the last line of stdout.

Exit codes: 0 a result was printed; 2 bad arguments; 3 no CUDA card, or
fewer than the cell needs; 4 jax, jaxlib, flax or cadnip_tpu was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cadnip_tpu")


def _bench_root():
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def metric_specs(cell: str, trace: bool) -> list:
    """The cell's metrics from BENCHMARK.json: end_to_end without trace,
    per_layer with it; a metric with a `workloads` list only in those."""
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if cell in m.get("workloads", [cell]):
            out.append(m)
    return out


def reader(name: str):
    """The metric's reader: `metrics/<name>.py`, or, where there is none,
    `metrics/<stem>.py` (the name before its first dot), which serves every
    variant of the metric alike."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    s = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device=None, workload=None, specs=None, entry_hook=None):
    """One run; returns (result dict, [(name, value, limit)]). `device`
    (a torch device string), `workload` (a dict in place of the file),
    `specs` (the metrics) and `entry_hook` (wraps the entry object) serve
    the harness's tests on the CPU."""
    _bench_root()
    from benchmark.core import check as chk
    from benchmark.core import traffic as tf

    wl = workload or tf.load_json("workloads", cell)
    cfg = tf.load_json("configs", wl["config"])
    mix = tf.load_json("traffic", wl["traffic"])
    params = {"tstop": cfg["tstop"], "dt": cfg["dt"], **mix["params"],
              **wl.get("params", {})}
    import torch

    devs = list(range(wl["chips"])) if device is None else []
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=params, seed=seed, device=device,
        devices=None if device is None else [device] * wl["chips"],
        check=wl["check"])
    entry = importlib.import_module(f"benchmark.entries.{mix['entry']}")
    prog = entry.make(ctx)
    if entry_hook is not None:
        prog = entry_hook(prog)
    prog.warm_up()
    setup_s = time.perf_counter() - T_START if device is None else None

    jobs = []
    w0 = time.perf_counter()
    while True:
        jobs.append(prog.job(len(jobs)))
        if time.perf_counter() - w0 >= seconds:
            break
    for d in devs:
        torch.cuda.synchronize(d)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devs),
               default=0)
    prof = None
    if trace:
        from benchmark.core import trace as trc
        info = {}

        def work():
            info.update(prog.profile())
        prof = trc.profile(work, devs)
        prof["job"] = info

    run = types.SimpleNamespace(
        cfg=cfg, traffic=params, jobs=jobs, setup_s=setup_s,
        window_s=sum(j["wall"] for j in jobs), profile=prof)
    metrics = {}
    for m in specs if specs is not None else metric_specs(cell, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's outputs to the host, its state freed; then the check
    units = prog.units(jobs)
    del prog
    gc.collect()
    if devs:
        torch.cuda.empty_cache()
    numbers = chk.combine([chk.judge(u, cfg, wl["check"]) for u in units])
    attempted = sum(j["lanes"] for j in jobs)
    failed = attempted - sum(j["converged"] for j in jobs)
    correct, rows = chk.verdict(numbers, wl["check"]["limits"])
    rows.append(("failed", failed, 0))
    correct = correct and failed == 0
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": _device(devs, peak, prof)}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {n: {"value": float(v), "limit": float(lim)}
                        for n, v, lim in rows}
    result["_notes"] = {k: v for k, v in numbers.items()
                        if k.startswith("reference_")}
    return result, rows


def _device(devs, peak, prof):
    import torch
    if not devs:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(devs[0]),
           "count": len(devs), "memory_peak_bytes": int(peak)}
    if prof is not None:
        out["busy_s"] = prof["busy_s"]
        out["window_s"] = prof["window_s"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _bench_root()
    from benchmark.core import traffic as tf
    try:
        wl = tf.load_json("workloads", args.workload)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); {found} "
              "found", file=sys.stderr)
        return 3
    result, rows = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark may import neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 4
    emit(result, rows)
    return 0


def emit(result: dict, rows: list):
    """The compared numbers beside their limits as the last lines of
    stderr; the result as the last line of stdout, `checks` its last key."""
    notes = result.pop("_notes")
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    # one process with one host thread for its CPU work: the host loop is
    # the measured path, and idle worker threads only add jitter
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.exit(main())
