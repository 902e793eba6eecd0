"""The port's parallel-in-time transient (`analyses/tran_pit.py`) against the
JAX package's on the CPU: the window solve (K1's plain twin on scaled rows,
and the batch-major branch), the doubling scan in f64 and mixed precision,
the host helpers, the VACASK rc on its periodic-seeded path, the graetz
ladder, and the unsupported-circuit refusal. The seeded, stall, rescue,
`uic` and oscillator paths are in test_torch_tran_pit_paths.py."""
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
from cadnip_tpu_torch.models.vacask import (DARLINGTON, GRAETZ, MUL,
                                            RC_NETLIST)

torch.set_num_threads(1)

#: a deck of every aperiodic waveform kind beside a pulse
AWAVES = """aperiodic sources
vp p 0 pulse 0 1 2n 0.5n 0.7n 4n 10n
vw w 0 pwl 0 0 1n 1 1.5n 1 3n 0
ve e 0 exp 0 1 1n 0.3n 5n 0.2n
vf f 0 sffm 0 1 50meg 2 5meg
r1 p 0 1k
r2 w 0 1k
r3 e 0 1k
r4 f 0 1k
.end
"""


def jax_params(jcc):
    """The JAX circuit's parameters carried into the port (CPU)."""
    return params_from_numpy([jax.tree.map(np.array, d)
                              for d in jcc.params0()], device="cpu")


def both(net):
    return tct.parse_spice(net, device="cpu"), jct.parse_spice(net)


def window_systems(W, n, seed):
    """Random diagonally dominant window systems (D, L, R), a frozen
    prefix of 5 points, and a mask of voltage rows."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((W, n, n)) * 0.3
    D[:, np.arange(n), np.arange(n)] += n * (1.0 + rng.random((W, n)))
    L = rng.standard_normal((W, n, n)) * 0.3
    L[0] = 0.0
    R = rng.standard_normal((W, n)) * 2.0
    active = np.ones((W, 1))
    active[:5] = 0.0
    is_v = rng.random(n) < 0.6
    return D, L, R, active, is_v


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n,mixed", [(9, True), (9, False), (44, False)])
def test_window_dx_matches_jax(n, mixed):
    """One window solve: the lane-major branch (n <= 40, scaled rows in one
    K1 launch, mixed or f64 scan) and the batch-major branch (n = 44,
    unscaled rows, f64 scan), with the voltage clamp, within 1e-12."""
    W = 256
    D, L, R, active, is_v = window_systems(W, n, seed=n)
    lane = n <= ttp.LANE_MAJOR_MAX
    mdv = 0.0
    for _ in range(2):
        want, uw = jtp._window_dx(
            jnp.asarray(R), jnp.asarray(D), jnp.asarray(L),
            jnp.asarray(active), n, W, lane, mixed, mdv, jnp.asarray(is_v),
            jnp.float64)
        got, ug = ttp._window_dx(
            *(torch.as_tensor(a) for a in (R, D, L, active)), n, lane,
            mixed, mdv, torch.as_tensor(is_v))
        assert rel(got.numpy(), np.asarray(want)) <= 1e-12
        np.testing.assert_array_equal(ug.numpy(), np.asarray(uw))
        if mdv:
            # the clamp acted on some points and not on others
            assert 0 < int(ug.sum()) < W
        # then a clamp at the median voltage step of the unclamped solve
        mdv = float(np.median(np.abs(got.numpy())[:, is_v].max(1)))


@pytest.mark.parametrize("mixed", [False, True])
def test_scan_matches_jax(mixed):
    """The doubling scan at W = 1024 on random contractive maps, against the
    JAX `_scan_lanes` in f64: the f64 scan, and the mixed scan (f32, one f64
    defect correction, f32 again)."""
    W, n = 1024, 9
    rng = np.random.default_rng(3)
    M = rng.standard_normal((W, n, n))
    M *= 0.95 / np.abs(np.linalg.eigvals(M)).max(-1)[:, None, None]
    c = rng.standard_normal((W, n))
    want = np.asarray(jtp._scan_lanes(jnp.asarray(np.moveaxis(M, 0, -1)),
                                      jnp.asarray(c.T))).T
    scan = ttp.mixed_scan_affine if mixed else ttp.scan_affine
    got = scan(torch.as_tensor(M), torch.as_tensor(c)).numpy()
    assert rel(got, want) <= 1e-12
    # the f32 scan alone is far off: the defect pass does the work
    if mixed:
        f32 = ttp.scan_affine(torch.as_tensor(M).float(),
                              torch.as_tensor(c).float()).double().numpy()
        assert rel(f32, want) > 1e-9


def test_host_helpers_match_jax():
    decks = [RC_NETLIST, GRAETZ, MUL, DARLINGTON, AWAVES, tct.dff_netlist()]
    for net in decks:
        tcc, jcc = both(net)
        assert ttp.supported(tcc) == jtp.supported(jcc) is True
        assert ttp.fastest_timescale(tcc) == jtp.fastest_timescale(jcc)
        np.testing.assert_equal(ttp.common_period(tcc),
                                jtp.common_period(jcc))
    for args in [(1024,), (8192, 8, 32), (20000, 8, 32), (4096, 4, 16),
                 (1024, 1), (2048, 8, 300), (1, 8, 32)]:
        assert ttp.level_grids(*args) == jtp.level_grids(*args)
    # tests/test_tran_pit.py's synthetic period: a sine with a harmonic
    # under a startup envelope, too few crossings, and a flat waveform
    dt, P = 0.05e-9, 3.4423e-9
    t = dt * np.arange(1200)
    v = np.minimum(t / (4 * P), 1.0) * (0.6 * np.sin(2 * np.pi * t / P)
                                        + 0.1 * np.sin(4 * np.pi * t / P
                                                       + 0.7))
    xs = np.stack([v, 0.01 * v, np.zeros_like(v)], axis=1)
    for a, kw in [(xs, {}), (xs, {"min_cross": 4}), (xs[:120], {}),
                  (np.zeros((500, 3)), {}), (xs + 1e-12, {})]:
        assert ttp.detect_period(a, dt, **kw) == jtp.detect_period(
            a, dt, **kw)
    assert abs(ttp.detect_period(xs, dt) - P) < 0.01 * P


def test_rc_matches_jax_and_closed_form():
    """The VACASK rc over 0-5 ms at 1 us, window 512 (snapped to the pulse
    period, 2000 steps: the periodic-seeded path), against JAX (counts
    equal, 1e-12 V) and the exact pulse response (< 1e-6, bench.py's
    gate)."""
    tcc, jcc = both(RC_NETLIST)
    sol = ttp.tran_pit(tcc, (0, 5e-3), 1e-6, window=512,
                       params=jax_params(jcc))
    ref = jtp.tran_pit(jcc, (0, 5e-3), 1e-6, window=512)
    assert not bool(sol.stats.fail) and bool(sol.converged)
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton)
    assert sol.xs.shape == (5001, 3)
    assert float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max()) <= 1e-12
    v2, ts = sol["2"].numpy(), np.asarray(sol.ts)
    seg = (ts >= 5e-6) & (ts <= 9e-4)
    tau, tr = 1e-3, 1e-6
    v_ramp_end = 1.0 - tau / tr * (1 - np.exp(-tr / tau))
    v_exact = 1.0 + (v_ramp_end - 1.0) * np.exp(-(ts[seg] - 2e-6) / tau)
    assert float(np.sqrt(np.mean((v2[seg] - v_exact) ** 2))) < 1e-6
    assert sol.timings["seed"] > 0


def test_graetz_ladder_matches_jax():
    """The graetz rectifier over 0-4 ms at 1 us, window 1024, periodic
    seeding off: four ladder windows (BE at 128 points, then trap at 1024).
    The window-Newton iterations equal JAX's (31) window by window; the
    waveform within 1e-7 of 20 V. Not closer: the off-state diodes put D's
    condition near 1e15, so last-bit differences of the device evaluations
    (XLA's and torch's exp, forward against reverse-mode Jacobians) move
    each accepted point within Newton's tolerance. The serial `tran` of
    both packages, counts equal, parts by 5.9e-8 V on the same span; the
    ladder by 5.9e-7 V."""
    tcc, jcc = both(GRAETZ)
    kw = dict(window=1024, periodic="off")
    sol = ttp.tran_pit(tcc, (0, 4e-3), 1e-6, params=jax_params(jcc), **kw)
    ref = jtp.tran_pit(jcc, (0, 4e-3), 1e-6, **kw)
    assert not bool(sol.stats.fail) and not bool(np.asarray(ref.stats.fail))
    assert int(sol.stats.nnewton) == int(ref.stats.nnewton) == 31
    assert [o for o, _ in sol.window_iters] == [0, 1024, 2048, 3072]
    assert sol.timings["seed"] == 0.0
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= 1e-7 * 20.0, err


def test_unsupported_circuit_raises():
    tcc, jcc = both(RC_NETLIST)
    tcc.bbd, jcc.bbd = object(), object()
    for fn, cc in ((ttp.tran_pit, tcc), (jtp.tran_pit, jcc)):
        assert not (ttp.supported(tcc) or jtp.supported(jcc))
        with pytest.raises(ValueError):
            fn(cc, (0, 1e-3), 1e-6)


@pytest.mark.gpu
def test_window_dx_on_the_card():
    """K1 at [4096, 9, 10] inside `_window_dx` on the card against the same
    call on the CPU (the plain twin), lane-major with the mixed scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    W, n = 4096, 9
    D, L, R, active, is_v = window_systems(W, n, seed=11)
    args = (R, D, L, active)
    want, uw = ttp._window_dx(*(torch.as_tensor(a) for a in args), n, True,
                              True, 5.0, torch.as_tensor(is_v))
    gj_solve.launches = 0
    got, ug = ttp._window_dx(*(torch.as_tensor(a, device="cuda")
                               for a in args), n, True, True, 5.0,
                             torch.as_tensor(is_v, device="cuda"))
    assert gj_solve.launches == 1
    assert rel(got.cpu().numpy(), want.numpy()) <= 1e-12
    np.testing.assert_array_equal(ug.cpu().numpy(), uw.numpy())
