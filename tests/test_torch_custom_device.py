"""A user-defined device through the public DeviceModel API, in the port
against the JAX package, case for case with tests/test_custom_device.py:
the same saturating conductance, written once with torch and once with
jnp, goes through dc, tran, ac and dcsweep in both packages. DC to 1e-10
relative with equal Newton counts; the transient with equal accepted,
rejected and Newton counts, waveforms to 1e-9 of the 1 V scale; AC to
1e-10 relative. Every port call runs on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct

torch.set_num_threads(1)

DC_RTOL, DC_ATOL = 1e-10, 1e-15
TRAN_TOL = 1e-9
AC_RTOL = 1e-10
DEFAULTS = {"g0": 1e-3, "isat": 1e-3, "c": 0.0}


# a saturating (tanh) conductance, i = isat*tanh(g0*v/isat), with a
# parallel charge q = c*v: nothing like it among the built-in devices
def _sat_res_jnp(u, p, dyn):
    v = u[0] - u[1]
    i = p["isat"] * jnp.tanh(p["g0"] * v / p["isat"])
    q = p["c"] * v
    return jnp.stack([i, -i]), jnp.stack([q, -q])


def _sat_res_torch(u, p, dyn):
    v = u[0] - u[1]
    i = p["isat"] * torch.tanh(p["g0"] * v / p["isat"])
    q = p["c"] * v
    return torch.stack([i, -i]), torch.stack([q, -q])


SATR = {
    jct: jct.DeviceModel(name="satres", terminals=("p", "n"),
                         residual=_sat_res_jnp, defaults=dict(DEFAULTS)),
    tct: tct.DeviceModel(name="satres", terminals=("p", "n"),
                         residual=_sat_res_torch, defaults=dict(DEFAULTS)),
}


def build(build_fn):
    """build_fn(pkg, model) -> Circuit, for both packages: (JAX cc, port
    cc on the CPU)."""
    return (build_fn(jct, SATR[jct]).compile(),
            build_fn(tct, SATR[tct]).compile(device="cpu"))


def assert_dc(js, ts):
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.iters) == int(js.iters)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)


def test_custom_device_dc_small_and_large_signal():
    def circuit(pkg, model):
        c = pkg.Circuit("custom dc")
        c.V("vs", "in", "0", dc=0.1)
        c.R("r1", "in", "out", 1e3)
        c.add(model, "x1", ("out", "0"), g0=1e-3, isat=1e-3)
        return c

    jcc, tcc = build(circuit)
    ts = tct.dc(tcc)
    assert_dc(jct.dc(jcc), ts)
    # hand Newton on (0.1 - v)/1e3 = 1e-3*tanh(v)
    v = 0.05
    for _ in range(60):
        f = (0.1 - v) / 1e3 - 1e-3 * np.tanh(v)
        df = -1e-3 - 1e-3 / np.cosh(v) ** 2
        v -= f / df
    assert abs(float(ts["out"]) - v) < 1e-9

    # deep into saturation: the device current pins at isat
    js2 = jct.dc(jcc, jcc.alter(jcc.params0(), **{"vs.dc": 50.0}))
    ts2 = tct.dc(tcc, tcc.alter(tcc.params0(), **{"vs.dc": 50.0}))
    assert_dc(js2, ts2)
    assert abs((50.0 - float(ts2["out"])) / 1e3 - 1e-3) < 1e-5


def test_custom_device_tran_and_ac():
    # the device with its charge term: an RC built from the custom element
    # (g0 tiny, so the tanh leak is negligible)
    def circuit(pkg, model):
        c = pkg.Circuit("custom tran2")
        c.V("vs", "in", "0", dc=1.0, acmag=1.0)
        c.R("r1", "in", "out", 1e3)
        c.add(model, "x1", ("out", "0"), g0=1e-12, isat=1.0, c=1e-6)
        return c

    jcc, tcc = build(circuit)
    kw = dict(dt=5e-6, uic=True)
    ref = jct.tran(jcc, (0.0, 5e-3), **kw)
    sol = tct.tran(tcc, (0.0, 5e-3), **kw)
    assert bool(ref.converged) and bool(sol.converged)
    assert tuple(int(v) for v in sol.stats[:3]) == \
        tuple(int(v) for v in ref.stats[:3])
    err = float(np.abs(sol.xs.numpy() - np.asarray(ref.xs)).max())
    assert err <= TRAN_TOL * 1.0, err
    # RC charging, tau = 1 ms
    ts, v = np.asarray(sol.ts), sol["out"].numpy()
    i = int(np.argmin(np.abs(ts - 1e-3)))
    assert abs(v[i] - (1 - np.exp(-1.0))) < 5e-3

    # AC: a single-pole lowpass, |H| = 1/sqrt(2) at the pole
    f0 = 1.0 / (2 * np.pi * 1e-3)
    freqs = np.array([f0 / 10, f0, f0 * 10])
    ha = np.asarray(jct.ac(jcc, freqs)["out"])
    ht = tct.ac(tcc, freqs)["out"]
    ht = ht.numpy() if isinstance(ht, torch.Tensor) else np.asarray(ht)
    np.testing.assert_allclose(ht, ha, rtol=AC_RTOL, atol=0)
    assert abs(abs(ht[1]) - 1 / np.sqrt(2)) < 1e-3


def test_custom_device_sweeps_and_errors():
    def circuit(pkg, model):
        c = pkg.Circuit("custom sweep")
        c.V("vs", "in", "0", dc=0.1)
        c.R("r1", "in", "out", 1e3)
        c.add(model, "x1", ("out", "0"))
        return c

    jcc, tcc = build(circuit)
    values = [1e-4, 1e-3, 1e-2]
    js = jct.dcsweep(jcc, jct.Sweep("x1.g0", values))
    ts = tct.dcsweep(tcc, tct.Sweep("x1.g0", values))
    v = ts["out"].numpy()
    assert v.shape == (3,)
    assert v[0] > v[1] > v[2]     # more conductance pulls out lower
    assert bool(np.asarray(js.converged).all())
    assert bool(ts.converged.all())
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                               rtol=DC_RTOL, atol=DC_ATOL)

    # an unknown parameter at add() time is a build error, in both
    for pkg in (jct, tct):
        with pytest.raises(ValueError, match="nope"):
            pkg.Circuit("bad").add(SATR[pkg], "x1", ("a", "0"), nope=1.0)
