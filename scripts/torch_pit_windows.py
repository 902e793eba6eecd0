"""Window by window: the port's tran_pit on a VACASK deck at bench.py's
settings, on the CPU, over its first few windows.

    python scripts/torch_pit_windows.py mul 5          # five windows
    python scripts/torch_pit_windows.py graetz 2 --jax  # and the JAX package's
    python scripts/torch_pit_windows.py mul 2 --serial  # and serial_trap
    python scripts/torch_pit_windows.py mul 2 --trace --res-eps 3e-7
    python scripts/torch_pit_windows.py mul 2 --jax-seed --side-by-side
    python scripts/torch_pit_windows.py mul 2 --jax-seed --eager --serial

Prints the window length, the window-Newton iterations of every solved
piece (step offset, iterations), the wall split into operating point,
periodic seed and windows, the golden RMSE over the span where a golden
exists; with --jax the JAX package's run of the same call from the same
parameters (its total iterations and the largest difference); with
--serial the same trapezoidal recursion solved one step at a time
(`serial_trap`), its golden RMSE, and how far each window run lies from it.
Differences are split into node voltages and branch currents. --trace
prints, for every Newton level of every window, the converged prefix
(frozen points) after each iteration; --res-eps sets the KCL-residual
acceptance floor (1e-9 by default) of the port and of the JAX package.

--jax-seed (implies --jax) starts the port from the JAX package's
operating point and window-0 seed (its serial `tran` at 8 dt, as its
tran_pit builds it), so that the seed leaves the comparison.
--side-by-side records every window-Newton iteration of both packages
(points, converged prefix, max |R|, max |dx|, whether every step was
finite) and prints the first iteration where the converged prefix or the
finiteness part, the first where max |dx| parts beyond 1e-12 relative, and
the iteration 0 of window 0 evaluated three ways from the port's operands:
the port's `_window_dx`, the JAX package's jitted and its eager (the same
function under jax.disable_jit). --eager adds the JAX package's whole run
evaluated eagerly (jax.disable_jit, from the same seed; slow: about 9 min
for mul's two windows). Runs on one CPU thread.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: bench.py's tran_pit settings (bench.py:190-269, 411-443): step and
#: arguments; the window after snapping to the source period, in steps
DECKS = {
    "graetz": (1e-6, dict(window=8192, windows_per_exec=16), 20000,
               ("outp", "outn"), 20.0),
    "mul": (1e-8, dict(window=2000, windows_per_exec=64, max_iters=96),
            2000, ("20", None), 50.0),
    "darlington": (2e-9, dict(window=8000, windows_per_exec=32,
                              max_iters=96), 8000, ("coll", None), 5.0),
}


def jax_start(jcc, W, dt, t0=0.0):
    """The JAX package's operating point and window-0 seed as its tran_pit
    builds them on the CPU (jitted): (x0, seed), numpy."""
    import jax.numpy as jnp
    from cadnip_tpu.analyses.dc import dc
    from cadnip_tpu.analyses.tran import tran
    from cadnip_tpu.mna.spec import MODE_TRANOP
    params = jcc.params0()
    x0 = dc(jcc, params, mode=MODE_TRANOP, time=t0).x
    s0 = tran(jcc, (t0, t0 + W * dt), params, dt=8 * dt, dtmax=8 * dt,
              save_ts=t0 + dt * (1.0 + np.arange(W)), x0=jnp.asarray(x0))
    return np.asarray(x0), np.asarray(s0.xs)


def record(rec, active, R, dx):
    """One window iteration's (points, converged prefix, max |R|,
    max |dx|, every step finite), numpy operands."""
    act, R, dx = (np.asarray(a) for a in (active, R, dx))
    fin = np.isfinite(dx)
    rec.append((int(act.shape[0]), int(round(act.shape[0] - act.sum())),
                float(np.abs(R).max()),
                float(np.abs(dx[fin]).max()) if fin.any() else np.nan,
                bool(fin.all())))


def side_by_side(a, b, names):
    """Print where two runs' per-iteration records part."""
    n = min(len(a), len(b))
    first = next((i for i in range(n) if a[i][1] != b[i][1]
                  or a[i][4] != b[i][4]), None)
    vals = next((i for i in range(n) if abs(a[i][3] - b[i][3])
                 > 1e-12 * abs(a[i][3])), None)
    print(f"{names[0]} {len(a)} and {names[1]} {len(b)} window iterations; "
          f"max |dx| first parts beyond 1e-12 relative at iteration {vals}"
          + (f" ({a[vals][3]!r} and {b[vals][3]!r})" if vals is not None
             else ""))
    if first is None:
        print(f"   the converged prefix and finiteness agree at all {n}")
        return
    print(f"   the converged prefix or finiteness first part at iteration "
          f"{first}: (points, prefix, max |R|, max |dx|, finite)")
    for i in range(max(0, first - 3), min(n, first + 3)):
        print(f"   {i}: {names[0]} {a[i]}  {names[1]} {b[i]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("deck", choices=sorted(DECKS))
    ap.add_argument("windows", type=int)
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX package's tran_pit (CPU, f64)")
    ap.add_argument("--serial", action="store_true",
                    help="also solve the recursion step by step")
    ap.add_argument("--trace", action="store_true",
                    help="the converged prefix after every iteration")
    ap.add_argument("--res-eps", type=float, default=None,
                    help="the KCL-residual acceptance floor")
    ap.add_argument("--jax-seed", action="store_true",
                    help="start the port from the JAX package's operating "
                         "point and window-0 seed")
    ap.add_argument("--side-by-side", action="store_true",
                    help="record and compare every window iteration")
    ap.add_argument("--eager", action="store_true",
                    help="also the JAX package's run evaluated eagerly")
    args = ap.parse_args()
    args.jax = args.jax or args.jax_seed or args.side_by_side or args.eager

    if args.res_eps is not None:
        # read by the JAX package when it builds its runners
        os.environ["CADNIP_PIT_RES_EPS"] = repr(args.res_eps)
    import torch
    import cadnip_tpu_torch as ct
    import cadnip_tpu_torch.analyses.tran_pit as ttp
    from cadnip_tpu_torch.mna.devices import CLASS_V
    from cadnip_tpu_torch.models import vacask

    torch.set_num_threads(1)
    dt, kw, W, (na, nb), scale = DECKS[args.deck]
    net = getattr(vacask, args.deck.upper())
    span = (0, args.windows * W * dt)
    cc = ct.parse_spice(net, device="cpu")
    is_v = cc.classes == CLASS_V
    params = None
    start = {}
    if args.jax:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import cadnip_tpu as jct
        import cadnip_tpu.analyses.tran_pit as jtp
        from cadnip_tpu_torch.interop import params_from_numpy
        jcc = jct.parse_spice(net)
        params = params_from_numpy([jax.tree.map(np.array, d)
                                    for d in jcc.params0()], device="cpu")
        if args.jax_seed:
            x0j, seedj = jax_start(jcc, W, dt)
            start = dict(x0=torch.as_tensor(x0j.copy()),
                         xseed=torch.as_tensor(seedj.copy()))
    if args.res_eps is not None:
        ttp.RES_EPS = args.res_eps
    recs = {"port": [], "JAX": [], "JAX eager": []}
    first_dx = {}
    if args.side_by_side:
        window_dx = ttp._window_dx

        def traced_dx(R, D, Lm, active, *rest):
            out = window_dx(R, D, Lm, active, *rest)
            if not first_dx:
                first_dx.update(R=R, D=D, Lm=Lm, active=active, rest=rest,
                                dx=out[0])
            record(recs["port"], active, R, out[0])
            return out
        ttp._window_dx = traced_dx

        jwindow_dx = jtp._window_dx
        eager = [False]

        def jtraced_dx(R, D, Lm, active, *rest, **kw_):
            out = jwindow_dx(R, D, Lm, active, *rest, **kw_)
            rec = recs["JAX eager" if eager[0] else "JAX"]
            if eager[0]:
                record(rec, active, R, out[0])
            else:
                jax.debug.callback(lambda a, r, d: record(rec, a, r, d),
                                   active, R, out[0])
            return out
        jtp._window_dx = jtraced_dx
    trace, fresh = [], [True]
    if args.trace:
        # every Newton level (and every flat-runner window) starts from
        # init_lim; each evaluation then adds its converged prefix
        evaluate, init_lim = ttp._Window.evaluate, ttp._Window.init_lim

        def traced_init(self, X):
            fresh[0] = True
            return init_lim(self, X)

        def traced(self, X, lim, ok, tw, c0, *rest):
            ev = evaluate(self, X, lim, ok, tw, c0, *rest)
            if fresh[0]:
                k = round((float(tw[0]) - span[0]) / dt)
                trace.append(((k, X.shape[0], "BE" if rest[-1] else "trap"),
                              []))
                fresh[0] = False
            trace[-1][1].append(int(ev[1].sum()))
            return ev
        ttp._Window.evaluate, ttp._Window.init_lim = traced, traced_init
    t = time.perf_counter()
    sol = ct.tran_pit(cc, span, dt, params=params, **start, **kw)
    wall = time.perf_counter() - t
    tm = sol.timings
    print(f"{args.deck} 0-{span[1]:g} s: window {sol.window}, window-Newton "
          f"iterations {int(sol.stats.nnewton)}, fail {bool(sol.stats.fail)};"
          f" wall {wall:.1f} s (operating point {tm['op']:.1f} s, seed "
          f"{tm['seed']:.1f} s, windows {tm['windows']:.1f} s)"
          + ("; from the JAX package's operating point and seed"
             if start else ""))
    print(f"pieces (step offset, iterations): {sol.window_iters}")
    for (k, wl, kind), frozen in trace:
        print(f"   {wl} points from step {k}, {kind}: converged prefix at "
              f"each of {len(frozen)} evaluations {frozen}")
    path = os.path.join(ROOT, "tests", "goldens", f"{args.deck}.npz")
    golden = np.load(path) if os.path.exists(path) else None

    def golden_rmse(xs):
        v = xs[:, cc.index_of(na)] - (xs[:, cc.index_of(nb)] if nb else 0.0)
        m = golden["ts"] <= span[1]
        gv = golden[na][m] - (golden[nb][m] if nb else 0.0)
        return np.sqrt(np.mean((np.interp(golden["ts"][m], sol.ts, v)
                                - gv) ** 2)) / scale

    def apart(a, b):
        d = np.abs(a - b)
        return (f"voltages {d[:, is_v].max():.3e} V, currents "
                f"{d[:, ~is_v].max() if (~is_v).any() else 0.0:.3e} A")

    xs = sol.xs.numpy()
    if golden is not None:
        print(f"golden RMSE over the span: {golden_rmse(xs):.3e} of {scale} V")
    runs = {"port": xs}
    if args.jax:
        import jax.numpy as jnp
        jx0 = {"x0": jnp.asarray(start["x0"].numpy())} if start else {}
        variants = [("JAX", False)] + ([("JAX eager", True)]
                                       if args.eager else [])
        for label, is_eager in variants:
            if args.side_by_side:
                eager[0] = is_eager
            t = time.perf_counter()
            if is_eager:
                import cadnip_tpu.analyses.tran as jtran_mod
                jtran = jtran_mod.tran
                if start:
                    # the same window-0 seed: the jitted serial tran's
                    class Seed:
                        xs = jnp.asarray(start["xseed"].numpy())
                    jtran_mod.tran = lambda *a, **k: Seed
                try:
                    with jax.disable_jit():
                        ref = jtp.tran_pit(jcc, span, dt, **jx0, **kw)
                finally:
                    jtran_mod.tran = jtran
            else:
                ref = jtp.tran_pit(jcc, span, dt, **jx0, **kw)
            runs[label] = np.asarray(ref.xs)
            print(f"{label}: window-Newton iterations "
                  f"{int(ref.stats.nnewton)}, wall "
                  f"{time.perf_counter() - t:.1f} s; max |port - {label}| "
                  f"{apart(xs, runs[label])}"
                  + (f"; its golden RMSE {golden_rmse(runs[label]):.3e} of "
                     f"{scale} V" if golden is not None else ""))
    if args.side_by_side:
        others = [k for k in ("JAX", "JAX eager") if recs[k]]
        for other in others:
            side_by_side(recs["port"], recs[other], ("port", other))
        if len(others) == 2:
            side_by_side(recs["JAX"], recs["JAX eager"], others)
        f = first_dx
        n = cc.n
        ops = [np.asarray(f[k]) for k in ("R", "D", "Lm", "active")]
        lane_major, mixed, mdv, isv = f["rest"][1:]
        jf = (lambda R_, D_, L_, a_: jtp._window_dx(
            R_, D_, L_, a_, n, R_.shape[0], lane_major, mixed, mdv,
            jnp.asarray(isv.numpy()), jnp.float64)[0])
        jtp._window_dx = jwindow_dx
        with jax.disable_jit():
            dx_e = np.asarray(jf(*map(jnp.asarray, ops)))
        dx_j = np.asarray(jax.jit(jf)(*ops))
        dx_p = f["dx"].numpy()
        print(f"window 0, iteration 0, from the port's operands: max |dx| "
              f"{np.abs(dx_p).max():.6e}; |port - JAX eager| "
              f"{np.abs(dx_p - dx_e).max():.3e}, |JAX jitted - JAX eager| "
              f"{np.abs(dx_j - dx_e).max():.3e}")
    if args.serial:
        from cadnip_tpu_torch.analyses.tran_pit import serial_trap
        t = time.perf_counter()
        wit, ok = serial_trap(cc, span, dt, params=params, x0=xs[0])
        wit = wit.numpy()
        print(f"serial_trap: every step converged {ok}, wall "
              f"{time.perf_counter() - t:.1f} s"
              + (f"; golden RMSE {golden_rmse(wit):.3e} of {scale} V"
                 if golden is not None else ""))
        for name, x in runs.items():
            print(f"   max |{name} - serial_trap| {apart(x, wit)}")


if __name__ == "__main__":
    main()
