"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the program on the CPU, at a small
size) and the entry's job is wrapped to plant each fault a cell can have:
a transient that returns its state unchanged, half of a sweep's lanes left
out (the other half's results in their place), and an answer altered
where it is produced (the output node moved by 5 % of the scale in every
row after the operating point)."""
import pytest

from benchmark import run
from benchmark.core import traffic as tf

SEED = 2 ** 31 + 313
OUT_NODE = {"dff_gf180": "q", "vacask_graetz": "outp"}


def _saved(prog, rec, k):
    """The waveform tensor the check will read for job k, if any."""
    if "sol" in rec:
        return rec["sol"].xs
    return next((xs for kk, xs in prog.reservoir if kk == k), None)


def plant(fault, scale, node):
    def hook(prog):
        job = prog.job
        prog.warm_up = lambda: None

        def broken(k):
            rec = job(k)
            xs = _saved(prog, rec, k)
            names = rec["names"] if "names" in rec else prog.cc.names
            if fault == "unchanged":
                if xs is not None:
                    xs[..., 1:, :] = xs[..., :1, :].clone()
                if "final" in rec:
                    rec["final"][:, 0] = rec["x0"]
            elif fault == "half":
                B = xs.shape[0]
                xs[B // 2:] = xs[:B - B // 2].clone()
            elif fault == "altered" and xs is not None:
                xs[..., 1:, names[node]] += 0.05 * scale
            return rec
        prog.job = broken
        return prog
    return hook


CASES = [
    ("dff_mc4096", "unchanged", {"lanes": 4, "tstop": 1.2e-07, "n_save": 13}),
    ("dff_mc4096", "half", {"lanes": 4, "tstop": 4.2e-07, "n_save": 421}),
    ("dff_mc4096", "altered", {"lanes": 4, "tstop": 1.2e-07, "n_save": 13}),
    ("dff_k2", "unchanged", {"tstop": 1.2e-07}),
    ("dff_k2", "altered", {"tstop": 1.2e-07}),
    ("graetz_k2", "unchanged", {"tstop": 1e-02}),
    ("graetz_k2", "altered", {"tstop": 1e-02}),
]


@pytest.mark.parametrize("cell,fault,params", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_planted_fault_is_not_correct(cell, fault, params):
    wl = tf.load_json("workloads", cell)
    cfg = tf.load_json("configs", wl["config"])
    wl["params"] = params
    res, rows = run.run_cell(
        cell, SEED, 0.0, False, device="cpu", workload=wl, specs=[],
        entry_hook=plant(fault, cfg["scale_v"], OUT_NODE[wl["config"]]))
    assert res["correct"] is False, rows


# on the card at each cell's own size
FULL = [(c, f) for c, f, _ in CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", FULL, ids=[f"{c}-{f}" for c, f in FULL])
def test_planted_fault_on_the_card(card, cell, fault):
    """The same faults at the cell's own size on the card, one job each;
    prints the numbers (the upper readings of PERF.md)."""
    wl = tf.load_json("workloads", cell)
    cfg = tf.load_json("configs", wl["config"])
    res, rows = run.run_cell(
        cell, SEED, 0.0, False, workload=wl, specs=[],
        entry_hook=plant(fault, cfg["scale_v"], OUT_NODE[wl["config"]]))
    print(f"fault {cell} {fault} on {card}: {rows}")
    assert res["correct"] is False, rows
