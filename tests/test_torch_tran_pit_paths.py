"""The window paths of the port's parallel-in-time transient against the
JAX package's on the CPU: periodic seeding (the serial seed and the flat
runner), the flat runner's stall path, the robust ladder's rescue level and
its halving, `uic` with `ic=`, the oscillator mode, and mul's startup at
bench.py's settings from the JAX package's own seed.

The ladder's per-level budget is max(max_iters, 64) iterations, so a tiny
max_iters cannot make a window fail; a ladder without coarse levels
(coarsen=1) over a long constant-seed window does, and takes the rescue
level (and, where that fails too, the halving) as the reference does."""
import jax
import jax.numpy as jnp
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


def test_mul_startup_follows_the_references_arithmetic(monkeypatch):
    """mul's first two windows at bench.py's settings, both packages from
    the JAX package's operating point and window-0 seed (its serial `tran`
    at 8 dt, as its tran_pit builds it). Window 0's first window-Newton
    solve: the port's `_window_dx` equals the JAX package's evaluated
    eagerly bit for bit, while the JAX package's jitted solve parts from
    its own eager arithmetic (XLA contracts the Gauss-Jordan's products,
    and the f32 scan amplifies the last bits to ~1e-4 of dx). The first two
    flat-runner executions then take equal trips (window 0 in 18, window
    1's 13 before the budget ends; then 32 trips that bank nothing: window
    1's seed is outside the Newton basin and its steps are non-finite) with
    the same converged prefix at every iteration, though the iterates
    differ beyond rounding. From there the robust ladder's budget
    decisions rest on rounding: the reference's jitted and eager runs end
    28 A apart (scripts/torch_pit_windows.py mul 2 --jax-seed
    --side-by-side --eager)."""
    from cadnip_tpu.analyses.dc import dc as jdc
    from cadnip_tpu.analyses.tran import tran as jtran
    from cadnip_tpu.mna.assemble import make_rhs_assembler, pad_state
    from cadnip_tpu.mna.spec import MODE_TRAN as JMODE_TRAN
    from cadnip_tpu.mna.spec import MODE_TRANOP as JMODE_TRANOP
    from cadnip_tpu_torch.mna.spec import MODE_TRAN
    W, dt, trips = 2000, 1e-8, 32
    jcc = jct.parse_spice(MUL)
    tcc = tct.parse_spice(MUL, device="cpu")
    jp = jcc.params0()
    tp = params_from_numpy([jax.tree.map(np.array, d) for d in jp],
                           device="cpu")
    x0 = jdc(jcc, jp, mode=JMODE_TRANOP, time=0.0).x
    seed = np.array(jtran(jcc, (0.0, W * dt), jp, dt=8 * dt, dtmax=8 * dt,
                          save_ts=dt * (1.0 + np.arange(W)), x0=x0).xs)
    f, q = make_rhs_assembler(jcc)(pad_state(x0), jp, jcc.spec.dyn(
        mode=JMODE_TRANOP, time=0.0))
    q0, qd0 = np.array(q), -np.array(f)

    # window 0's first solve, from the port's operands
    dyn0 = tcc.spec.dyn("cpu", mode=MODE_TRAN, time=0.0)
    win = ttp._Window(tcc, tp, dyn0)
    X = torch.as_tensor(seed)
    c0 = 2.0 / dt
    _, frozen, R, _, _, G, C, _ = win.evaluate(
        X, win.init_lim(X), torch.zeros(X.shape, dtype=torch.bool),
        win.times(0.0, dt, 1.0, W), c0, torch.as_tensor(q0),
        torch.as_tensor(qd0), False)
    D = G + c0 * C
    Lm = torch.cat([torch.zeros_like(D[:1]), G[:-1] - c0 * C[:-1]])
    ops = tuple(t[:256] for t in (R, D, Lm, 1.0 - frozen))
    dx = ttp._window_dx(*ops, win.n, True, True, win.max_dv,
                        win.is_v)[0].numpy()

    def jdx(R_, D_, L_, a_):
        return jtp._window_dx(R_, D_, L_, a_, win.n, 256, True, True,
                              win.max_dv, jnp.asarray(win.is_v.numpy()),
                              jnp.float64)[0]

    jops = [t.numpy() for t in ops]
    with jax.disable_jit():
        dx_eager = np.asarray(jdx(*map(jnp.asarray, jops)))
    dx_jit = np.asarray(jax.jit(jdx)(*jops))
    assert np.array_equal(dx, dx_eager)
    assert not np.array_equal(dx_jit, dx_eager)

    # the first two flat-runner executions, side by side
    recs = {"port": [], "JAX": []}

    def rec(to, active, dx_):
        a, d = np.asarray(active), np.asarray(dx_)
        recs[to].append((int(round(a.shape[0] - a.sum())),
                         bool(np.isfinite(d).all())))

    jwin, twin = jtp._window_dx, ttp._window_dx

    def jtraced(R_, D_, L_, a_, *rest, **kw):
        out = jwin(R_, D_, L_, a_, *rest, **kw)
        jax.debug.callback(lambda a, d: rec("JAX", a, d), a_, out[0])
        return out

    def ttraced(R_, D_, L_, a_, *rest):
        out = twin(R_, D_, L_, a_, *rest)
        rec("port", a_, out[0])
        return out

    monkeypatch.setattr(jtp, "_window_dx", jtraced)
    monkeypatch.setattr(ttp, "_window_dx", ttraced)
    jrun = jax.jit(jtp.make_flat_runner(jcc, W, 2, trips))
    trun = ttp.make_flat_runner(tcc, tp, dyn0, W, 2, trips)
    jdyn0 = jcc.spec.dyn(mode=JMODE_TRAN, time=0.0)
    t_args = [torch.as_tensor(q0), torch.as_tensor(qd0), torch.as_tensor(seed)]
    j_args = [jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(seed)]
    for e, t0 in enumerate((0.0, W * dt)):
        xs, tw, ti, w, q1, qd1, Xe, _ = trun(*t_args[:2], t0, dt, t_args[2])
        Xo, st, jq1, jqd1, jXe = jrun(*j_args[:2], jnp.asarray(t0),
                                     jnp.asarray(dt), jp, jdyn0, j_args[2])
        st = np.asarray(st)
        its = [sum(i for ww, i in zip(tw, ti) if ww == k) for k in (0, 1)]
        jits = np.bincount(np.minimum(np.concatenate([[0], st[:trips - 1]]),
                                      1), weights=st[trips:2 * trips],
                           minlength=2).astype(int).tolist()
        assert (w, its) == (int(st[-1]), jits) == ((1, [18, 13]) if e == 0
                                                   else (0, [32, 0]))
        if e == 0:
            # window 0 banked; window 1 goes on from its partial iterate
            assert float(np.abs(xs.numpy() - np.asarray(Xo[:W])).max()) \
                <= 1e-9 * 50
            t_args, j_args = [q1, qd1, Xe], [jq1, jqd1, jXe]
    assert recs["port"] == recs["JAX"] and len(recs["port"]) == 63
    # window 1 from window 0's waveform: its first step is not finite, and
    # the converged prefix crawls
    assert not recs["port"][31][1]
    assert recs["port"][-1][0] > recs["port"][31][0]


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
