"""The window paths of the port's parallel-in-time transient against the
JAX package's on the CPU: periodic seeding (the serial seed and the flat
runner), the flat runner's stall path, the robust ladder's rescue level and
its halving, `uic` with `ic=`, and the oscillator mode.

The ladder's per-level budget is max(max_iters, 64) iterations, so a tiny
max_iters cannot make a window fail; a ladder without coarse levels
(coarsen=1) over a long constant-seed window does, and takes the rescue
level (and, where that fails too, the halving) as the reference does."""
import jax
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu.analyses.tran_pit as jtp
import cadnip_tpu_torch as tct
import cadnip_tpu_torch.analyses.tran_pit as ttp
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.models.vacask import MUL

torch.set_num_threads(1)


def half_wave(amp=5, cl="100p"):
    """tests/test_tran_pit.py's 1 MHz half-wave rectifier (period 1000
    steps at 1 ns), its amplitude and smoothing capacitor as given."""
    return f"""half-wave rectifier, fast source
.model dfast d is=1e-14 n=1.8 cjo=1p
vs in 0 dc 0 sin 0 {amp} 1e6
d1 in out dfast
cl out 0 {cl}
rl out 0 10k
.end
"""


def run_both(net, tspan, dt, **kw):
    """The same deck through both packages, the JAX parameters carried into
    the port."""
    jcc = jct.parse_spice(net)
    tcc = tct.parse_spice(net, device="cpu")
    p = params_from_numpy([jax.tree.map(np.array, d)
                           for d in jcc.params0()], device="cpu")
    sol = ttp.tran_pit(tcc, tspan, dt, params=p, **kw)
    ref = jtp.tran_pit(jcc, tspan, dt, **kw)
    assert sol.xs.shape == np.asarray(ref.xs).shape
    assert bool(sol.stats.fail) == bool(np.asarray(ref.stats.fail))
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    return sol, ref, err


def offsets(sol):
    return [o for o, _ in sol.window_iters]


def test_periodic_seeding_matches_jax():
    """Three periods: the window snaps to one period, window 0 is seeded
    by the serial `tran` at 8 dt and every later window by its
    predecessor, under one pooled budget. Counts equal, within 1e-12 V."""
    sol, ref, err = run_both(half_wave(), (0, 3e-6), 1e-9, window=1000,
                             windows_per_exec=4)
    assert not bool(sol.stats.fail)
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton) == 16
    assert offsets(sol) == [0, 1000, 2000]
    assert sol.timings["seed"] > 0.0
    assert err <= 1e-12, err
    v = sol["out"].numpy()[-1000:]
    assert 3.0 < v.max() < 5.0


def test_stall_path_matches_jax():
    """At 50 V and one window per execution, window 1's seed (window 0's
    waveform) is outside what 32 trips converge: that execution banks
    nothing, and the window goes through the robust ladder before seeding
    resumes. Counts equal, within 1e-12 of 50 V."""
    sol, ref, err = run_both(half_wave(amp=50), (0, 4e-6), 1e-9,
                             window=1000, windows_per_exec=1)
    assert not bool(sol.stats.fail)
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton)
    # the stalled execution (32 trips) and window 1's ladder
    assert sol.window_iters[1:3] == [(1000, 32), (1000, 20)]
    assert err <= 1e-12 * 50, err


def test_rescue_level_matches_jax():
    """A 4000-step constant-seed window without coarse levels: the trap
    level exhausts its 64 iterations, and the rescue ladder (backward Euler
    on the same grid, then trap from it) converges. Counts equal (64 + 25),
    within 1e-12 V."""
    sol, ref, err = run_both(half_wave(), (0, 4e-6), 1e-9, window=4000,
                             coarsen=1, periodic="off", windows_per_exec=1)
    assert not bool(sol.stats.fail)
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton) == 89
    assert sol.window_iters == [(0, 64), (0, 25)]
    assert err <= 1e-12, err


def test_rescue_halving_matches_jax():
    """The mul charge pump's startup over 256 steps without coarse levels:
    the window fails, its rescue fails, and the two halves of 128 steps
    converge through the rescue ladder. Counts equal window by window, the
    waveform within 1e-12 of 50 V."""
    sol, ref, err = run_both(MUL, (0, 2.56e-6), 1e-8, window=256,
                             coarsen=1, periodic="off", windows_per_exec=1)
    assert not bool(sol.stats.fail)
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton) == 250
    assert sol.window_iters == [(0, 64), (0, 128), (0, 48), (128, 10)]
    assert err <= 1e-12 * 50, err


def test_seed_replay_is_exact():
    """A periodic-seeded run replayed from its own operating point and
    window-0 seed (`x0`, `xseed`: how a run on the card is replayed on the
    CPU) takes the same iterations to the same bits. On the CPU K1 is never
    launched, so each part's launch count is 0."""
    cc = tct.parse_spice(half_wave(), device="cpu")
    kw = dict(window=1000, windows_per_exec=4)
    sol = ttp.tran_pit(cc, (0, 3e-6), 1e-9, **kw)
    again = ttp.tran_pit(cc, (0, 3e-6), 1e-9, x0=sol.xs[0],
                         xseed=sol.xseed, **kw)
    assert sol.xseed.shape == (1000, cc.n)
    assert again.window_iters == sol.window_iters
    assert torch.equal(again.xs, sol.xs)
    assert sol.k1_launches == {"op": 0, "seed": 0, "windows": 0}


def test_serial_trap_witness():
    """The ladder's converged window against the same trapezoidal
    recursion solved one step at a time (`serial_trap`, the witness
    chip_smoke.py holds mul to): every step converges, and the two lie
    within twice Newton's tolerance (reltol of the largest value)."""
    cc = tct.parse_spice(half_wave(), device="cpu")
    sol = ttp.tran_pit(cc, (0, 5e-7), 1e-9, window=500, periodic="off")
    wit, ok = ttp.serial_trap(cc, (0, 5e-7), 1e-9)
    assert ok and wit.shape == sol.xs.shape
    bar = 2 * cc.spec.reltol * float(sol.xs.abs().max())
    err = float((wit - sol.xs).abs().max())
    assert err <= bar, (err, bar)


def test_uic_with_ic_matches_jax():
    """`uic` starts from zeros with `out` pinned at 2 V (no operating
    point), then the seeded path; counts equal, within 1e-12 V."""
    sol, ref, err = run_both(half_wave(), (0, 3e-6), 1e-9, window=1000,
                             windows_per_exec=4, uic=True, ic={"out": 2.0})
    assert float(sol["out"][0]) == 2.0 and float(sol["in"][0]) == 0.0
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton)
    assert sol.op_iters == 0
    assert err <= 1e-12, err


@pytest.mark.integration
def test_oscillator_mode_ring():
    """The oscillator mode on the level-1 ring (tests/test_tran_pit.py's
    integration case): serial single steps until the period is seen, then
    windows snapped to it. The port's measured period within 2 % of JAX's.
    Integration only: the port takes about 6 minutes on one core here."""
    from cadnip_tpu.models.dff import ring_oscillator_netlist
    kw = dict(window=1024, windows_per_exec=8, osc=True, osc_window=64)
    sol, ref, _ = run_both(ring_oscillator_netlist(), (0, 150e-9), 0.1e-9,
                           **kw)
    assert not bool(sol.stats.fail)
    P = ttp.detect_period(sol.xs.numpy(), 0.1e-9)
    P_ref = jtp.detect_period(np.asarray(ref.xs), 0.1e-9)
    assert P is not None and P_ref is not None
    assert abs(P - P_ref) < 0.02 * P_ref, (P, P_ref)
