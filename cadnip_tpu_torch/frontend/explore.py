"""Interactive circuit explorer: live parameter sliders over a transient.

The counterpart of the reference's Makie extension
(`ext/CadnipMakieExt.jl:1-126`: `explore(circuit, tspan)` builds one
log-slider per scalar parameter and re-runs `tran!` on every slider
move), as in the JAX package's `frontend/explore.py`. The figure is
matplotlib, imported when an Explorer is built (never at module import);
every slider move is a value-only `alter` and a re-run of `tran` on the
circuit's own device, and the plotted samples are host copies.

Headless use (tests, scripts): `Explorer.set(name, value)` performs the
same update without a GUI event loop; `explore(..., show=False)` never
calls `plt.show()`.
"""
from __future__ import annotations

import numpy as np

from ..interop import to_numpy


class Explorer:
    """Figure + sliders + re-run plumbing. Create via `explore()`."""

    def __init__(self, cc, run, outputs, slider_names, params,
                 decades=2.0, show=True):
        import matplotlib
        if not show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        self.cc = cc
        self.run = run
        self.outputs = list(outputs)
        self.params = params
        self.base = {nm: float(self._leaf(nm))
                     for nm in slider_names}
        for nm, v in self.base.items():
            if v <= 0:
                raise ValueError(
                    f"explore sliders are log-scale; parameter {nm!r} has "
                    f"non-positive default {v!r} — pass sliders=[...] "
                    f"excluding it")

        nrows = len(slider_names)
        self.fig, self.ax = plt.subplots(
            figsize=(8, 4 + 0.3 * nrows))
        self.fig.subplots_adjust(bottom=0.15 + 0.05 * nrows)
        self.sliders = {}
        for i, nm in enumerate(slider_names):
            sax = self.fig.add_axes(
                [0.25, 0.04 + 0.05 * (nrows - 1 - i), 0.6, 0.03])
            v0 = np.log10(self.base[nm])
            sl = Slider(sax, nm, v0 - decades, v0 + decades, valinit=v0)
            sl.valtext.set_text(f"{self.base[nm]:.4g}")
            sl.on_changed(self._make_cb(nm))
            self.sliders[nm] = sl

        sol = self.run(self.params)
        self.ts = to_numpy(sol.ts)
        self.lines = {}
        for out in self.outputs:
            (ln,) = self.ax.plot(self.ts, to_numpy(sol[out]), label=out)
            self.lines[out] = ln
        self.ax.set_xlabel("t [s]")
        self.ax.set_ylabel("V")
        self.ax.legend(loc="best")
        self.ax.set_title(cc.title)
        if show:  # pragma: no cover - GUI path
            plt.show(block=False)

    # ---- helpers
    def _leaf(self, name):
        gi, pname, slot = self.cc.param_slots[name]
        holder, _head, tail = self.cc._get_leaf(self.params[gi], pname)
        return holder[tail][..., slot]

    def _make_cb(self, nm):
        def cb(logval):
            self.set(nm, 10.0 ** float(logval), _from_slider=True)
        return cb

    def set(self, name, value, _from_slider=False):
        """Set a parameter to `value` (linear units), re-run, update."""
        self.params = self.cc.alter(self.params, **{name: float(value)})
        if name in self.sliders:
            sl = self.sliders[name]
            if not _from_slider:
                sl.eventson = False
                sl.set_val(np.log10(float(value)))
                sl.eventson = True
            sl.valtext.set_text(f"{float(value):.4g}")
        sol = self.run(self.params)
        for out, ln in self.lines.items():
            ln.set_ydata(to_numpy(sol[out]))
        self.ax.relim()
        self.ax.autoscale_view()
        self.fig.canvas.draw_idle()
        return sol

    def values(self, out):
        """Current plotted samples for output `out` (numpy array)."""
        return np.asarray(self.lines[out].get_ydata())


def explore(cc, tspan, dt=None, *, outputs=None, sliders=None,
            params=None, decades=2.0, max_sliders=8, show=True,
            run=None, **tran_kw):
    """Open an interactive transient explorer for a compiled circuit.

    One log-scale slider per scalar parameter (default: the first
    `max_sliders` alterable instance parameters with positive defaults);
    moving a slider re-runs the transient and redraws in place —
    the behavior of the reference's `explore(circuit, tspan)` Makie
    extension (`ext/CadnipMakieExt.jl`).

    outputs: node names to plot (default: every node, capped at 6).
    run: optional override `run(params) -> TranSolution` replacing the
    built-in `tran(cc, tspan, dt=dt, params=...)` (e.g. to explore an
    AC response instead).
    """
    from ..analyses.tran import tran

    if params is None:
        params = cc.params0()
    if outputs is None:
        outputs = sorted(cc.node_names, key=cc.node_names.get)[:6]
    if run is None:
        if dt is None:
            dt = (float(tspan[1]) - float(tspan[0])) / 1000.0

        def run(p):
            return tran(cc, tspan, dt=dt, params=p, **tran_kw)

    if sliders is None:
        # default: the first max_sliders alterable parameters with
        # positive scalar defaults (log-slider domain), like the
        # reference's per-field slider sweep
        sliders = []
        for nm, (gi, pname, slot) in cc.param_slots.items():
            holder, _head, tail = cc._get_leaf(params[gi], pname)
            val = float(holder[tail][..., slot])
            if val > 0:
                sliders.append(nm)
            if len(sliders) >= max_sliders:
                break
    return Explorer(cc, run, outputs, sliders, params,
                    decades=decades, show=show)
