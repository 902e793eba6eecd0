"""The port's spans and call records (`cadnip_tpu_torch/obs.py`): nesting,
dotted names, counts, per-thread records, profiler ranges, and the
timings of `vmem_tran` (K2's twin on the CPU DFF) and `tran` built from
them."""
import math
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cadnip_tpu_torch as tct
from cadnip_tpu_torch import obs
from cadnip_tpu_torch.models.dff import dff_netlist

DIODE_RC = """diode rc
v1 in 0 pulse(0 2 1n 1n 1n 5n 20n)
r1 in a 1k
d1 a 0 dm
c1 a 0 1p
.model dm d is=1e-14 cjo=1p
.end
"""


def test_nesting_names_and_counts():
    with obs.call() as rec:
        with obs.span("a"):
            for _ in range(3):
                with obs.span("b"):
                    with obs.span("c"):
                        pass
        with obs.span("a"):
            pass
    assert set(rec) == {"a", "a#n", "a.b", "a.b#n", "a.b.c", "a.b.c#n"}
    assert (rec["a#n"], rec["a.b#n"], rec["a.b.c#n"]) == (2, 3, 3)
    assert rec["a"] >= rec["a.b"] >= rec["a.b.c"] >= 0.0
    assert isinstance(rec["a"], float) and isinstance(rec["a#n"], int)


def test_a_call_opens_a_fresh_record_and_path():
    with obs.call() as outer:
        with obs.span("seed"):
            with obs.call() as inner:
                with obs.span("op"):
                    pass
    assert set(inner) == {"op", "op#n"}
    assert set(outer) == {"seed", "seed#n"}


def test_a_span_outside_a_call_records_nothing():
    with obs.span("loose"):
        with obs.call() as rec:
            pass
    assert rec == {}


def test_a_span_records_on_an_exception():
    with obs.call() as rec:
        with pytest.raises(ValueError):
            with obs.span("fails"):
                raise ValueError("x")
        with obs.span("after"):
            pass
    assert rec["fails#n"] == 1 and rec["after#n"] == 1


def test_each_thread_keeps_its_own_record():
    barrier = threading.Barrier(2, timeout=30)
    records = {}

    def work(name, n):
        with obs.call() as rec:
            barrier.wait()
            for _ in range(n):
                with obs.span(name):
                    with obs.span("iter"):
                        pass
            barrier.wait()
        records[name] = rec

    threads = [threading.Thread(target=work, args=(name, n))
               for name, n in (("left", 5), ("right", 7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert set(records["left"]) == {"left", "left#n", "left.iter",
                                    "left.iter#n"}
    assert records["left"]["left.iter#n"] == 5
    assert records["right"]["right.iter#n"] == 7


def test_merge_sums_over_the_union_of_keys():
    out = obs.merge([{"op": 1.0, "op#n": 1, "op.gmin#n": 2},
                     {"op": 0.5, "op#n": 1}])
    assert out == {"op": 1.5, "op#n": 2, "op.gmin#n": 2}


def _cpu_events(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def test_spans_are_profiler_ranges_around_their_ops():
    x = torch.ones(8, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.call():
            with obs.span("outer"):
                with obs.span("inner"):
                    torch.mul(x, 3.0)
    ev = _cpu_events(prof)
    (_, o0, o1), = [e for e in ev if e[0] == "outer"]
    (_, i0, i1), = [e for e in ev if e[0] == "outer.inner"]
    muls = [e for e in ev if e[0] == "aten::mul"]
    assert muls and o0 <= i0 and i1 <= o1
    assert all(i0 <= s and f <= i1 for _, s, f in muls)


def test_ranges_are_cpu_ops_not_user_annotations():
    # a user annotation is mirrored on the device's timeline, where a trace
    # reduction would count it as device time
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.call():
            with obs.span("op"):
                pass
    (ev,), = [[e for e in prof.profiler.kineto_results.events()
               if e.name() == "op"]]
    assert not ev.is_user_annotation()


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    real = obs._Range

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(obs, "_Range", counting)
    with obs.call() as rec:
        with obs.span("quiet"):
            torch.ones(2) + 1
    assert opened == [] and rec["quiet#n"] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("loud"):
            pass
    assert opened == ["loud"]


def test_parse_spice_front_end_spans():
    cc = tct.parse_spice(DIODE_RC, device="cpu")
    t = cc.timings
    for k in ("frontend", "frontend.parse", "frontend.elaborate",
              "frontend.compile"):
        assert t[k + "#n"] == 1 and t[k] > 0.0
    assert t["frontend"] >= (t["frontend.parse"] + t["frontend.elaborate"]
                             + t["frontend.compile"])


@pytest.fixture(scope="module")
def dff_k2_twin():
    cc = tct.parse_spice(dff_netlist(), device="cpu")
    return tct.vmem_tran(cc, (0.0, 6e-8), dt=3.333e-10)


def test_vmem_tran_prepare_splits_into_op_and_pack(dff_k2_twin):
    t = dff_k2_twin.timings
    assert t["prepare#n"] == t["integrate#n"] == 1
    assert math.isclose(t["prepare.op"] + t["prepare.pack"], t["prepare"],
                        rel_tol=0.01)
    assert 0.0 < t["prepare.pack.build"] < t["prepare.pack"]
    assert 0.0 < t["prepare.op.build"] < t["prepare.op"]
    # the twin ran: no kernel arguments, launch or wait
    assert not any(k.startswith("integrate.") for k in t)


def test_vmem_tran_dc_tiers_and_iterations(dff_k2_twin):
    t = dff_k2_twin.timings
    tiers = {k.split(".")[2] for k in t if k.startswith("prepare.op.")
             and k.endswith(".iter#n")}
    # the DFF's direct Newton stops at its cap; gmin stepping finishes it
    assert tiers == {"direct", "gmin"}
    iters = sum(v for k, v in t.items() if k.startswith("prepare.op.")
                and k.endswith(".iter#n"))
    assert iters == int(dff_k2_twin.op_iters)
    for tier in tiers:
        base = f"prepare.op.{tier}"
        n = t[base + ".iter#n"]
        assert t[base + ".iter.assemble#n"] == t[base + ".iter.solve#n"] == n
        # one any-lane read per iteration, and one that ends each loop
        assert t[base + ".sync#n"] == n + t[base + "#n"]
        assert t[base + ".iter"] >= (t[base + ".iter.assemble"]
                                     + t[base + ".iter.solve"])


def test_tran_keeps_op_and_transient_and_splits_the_pass():
    cc = tct.parse_spice(DIODE_RC, device="cpu")
    sol = tct.tran(cc, (0.0, 2e-8), dt=1e-10)
    t = sol.timings
    assert t["op#n"] == t["transient#n"] == 1
    assert t["op"] > 0.0 and t["transient"] > 0.0
    assert t["op.direct.iter#n"] == int(sol.op_iters)
    # every pass reads the any-lane flag once; all but the last iterate
    assert t["transient.sync#n"] == sol.host_syncs
    assert t["transient.iter#n"] == t["transient.control#n"] \
        == sol.host_syncs - 1 == int(sol.stats.nnewton)
    assert t["transient.iter.assemble#n"] == t["transient.iter.solve#n"] \
        == t["transient.iter#n"]
    assert t["transient"] >= t["transient.iter"] + t["transient.control"]


def _diode5(**spec):
    # five junctions at 100 V behind 10 ohms (tests/test_torch_robust.py)
    return tct.parse_spice("""five diodes
.model dd d is=1e-15 n=1
vs in 0 dc 100
r1 in a 10
d1 a b dd
d2 b c dd
d3 c d dd
d4 d e dd
d5 e 0 dd
.end
""", spec=tct.SimSpec(**spec), device="cpu")


def _tier_iters(t):
    return {k.split(".")[2]: v for k, v in t.items()
            if k.startswith("prepare.op.") and k.endswith(".iter#n")}


def test_gmin_stepping_is_recorded_as_its_tier():
    # with 8 iterations a Newton the direct solve gives up, gmin finishes
    sol = tct.vmem_tran(_diode5(max_newton_iters=8), (0.0, 1e-9), dt=1e-10)
    it = _tier_iters(sol.timings)
    assert bool(sol.op_converged)
    assert set(it) == {"direct", "gmin"} and it["direct"] == 8
    assert sum(it.values()) == int(sol.op_iters)


def test_rescue_tiers_are_recorded():
    # the capped chain fails; pseudo-transient, then LM, run on the lane
    sol = tct.vmem_tran(_diode5(max_newton_iters=8, gmin_steps=2,
                                src_steps=2), (0.0, 1e-9), dt=1e-10)
    t = sol.timings
    it = _tier_iters(t)
    assert set(it) == {"direct", "gmin", "source", "ptran", "lm"}
    assert t["prepare.op.ptran#n"] == t["prepare.op.lm#n"] == 1
    # LM's two assemblies an iteration
    assert t["prepare.op.lm.iter.assemble#n"] == 2 * it["lm"]
    # the iterations the solution reports leave the march's out
    assert sum(it.values()) > int(sol.op_iters)
