"""Window by window: the port's tran_pit on a VACASK deck at bench.py's
settings, on the CPU, over its first few windows.

    python scripts/torch_pit_windows.py mul 5          # five windows
    python scripts/torch_pit_windows.py graetz 2 --jax  # and the JAX package's
    python scripts/torch_pit_windows.py mul 2 --serial  # and serial_trap
    python scripts/torch_pit_windows.py mul 2 --trace --res-eps 3e-7

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
Runs on one CPU thread.
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
    args = ap.parse_args()

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
    if args.jax:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import cadnip_tpu as jct
        from cadnip_tpu_torch.interop import params_from_numpy
        jcc = jct.parse_spice(net)
        params = params_from_numpy([jax.tree.map(np.array, d)
                                    for d in jcc.params0()], device="cpu")
    if args.res_eps is not None:
        ttp.RES_EPS = args.res_eps
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
    sol = ct.tran_pit(cc, span, dt, params=params, **kw)
    wall = time.perf_counter() - t
    tm = sol.timings
    print(f"{args.deck} 0-{span[1]:g} s: window {sol.window}, window-Newton "
          f"iterations {int(sol.stats.nnewton)}, fail {bool(sol.stats.fail)};"
          f" wall {wall:.1f} s (operating point {tm['op']:.1f} s, seed "
          f"{tm['seed']:.1f} s, windows {tm['windows']:.1f} s)")
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
        from cadnip_tpu.analyses.tran_pit import tran_pit as jpit
        t = time.perf_counter()
        ref = jpit(jcc, span, dt, **kw)
        runs["JAX"] = np.asarray(ref.xs)
        print(f"JAX: window-Newton iterations {int(ref.stats.nnewton)}, wall "
              f"{time.perf_counter() - t:.1f} s; max |port - JAX| "
              f"{apart(xs, runs['JAX'])}"
              + (f"; its golden RMSE {golden_rmse(runs['JAX']):.3e} of "
                 f"{scale} V" if golden is not None else ""))
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
