"""Device models of the port (cadnip_tpu_torch/mna/devices.py) and its
waveforms against the JAX package: residuals (f, q) and their jacfwd
Jacobians (J, C) at random points, the SPICE limiters, and eval_wave for
every waveform kind. Inputs are made with numpy from a seed and handed to
both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from cadnip_tpu.mna import devices as jdv
from cadnip_tpu.mna import waveforms as jwf
from cadnip_tpu.mna.spec import make_dynspec as jax_dynspec
from cadnip_tpu_torch.interop import params_from_numpy
from cadnip_tpu_torch.mna import devices as tdv
from cadnip_tpu_torch.mna import waveforms as twf
from cadnip_tpu_torch.mna.spec import MODE_TRAN, make_dynspec

torch.set_num_threads(1)
NPTS = 64
T_EVAL = 2.3e-8


def _pwl():
    return jwf.PWL([0, 0, 1e-8, 5.0, 2e-8, 5.0, 2.1e-8, 0.5, 5e-8, 1.0])


def _setup(kind, rng):
    """(JAX model, port model, params dict of numpy [NPTS] leaves, u)."""
    if kind in ("nmos_fwd", "nmos_rev", "pmos_fwd", "pmos_rev"):
        ty = 1.0 if kind.startswith("n") else -1.0
        p = {k: np.full(NPTS, float(v))
             for k, v in jdv.MOSFET1.defaults.items()}
        p.update(type=np.full(NPTS, ty), vth=np.full(NPTS, 0.8 * ty),
                 kp=rng.uniform(50e-6, 200e-6, NPTS),
                 w=rng.uniform(0.4e-6, 2e-6, NPTS),
                 l=rng.uniform(0.5e-6, 1e-6, NPTS),
                 **{"lambda": np.full(NPTS, 0.05)},
                 cgs=np.full(NPTS, 5e-15), cgd=np.full(NPTS, 5e-15),
                 cbd=np.full(NPTS, 1e-14), cbs=np.full(NPTS, 1e-14))
        u = rng.uniform(-0.5, 5.5, (NPTS, 4))
        u[:, 3] = 0.0 if ty > 0 else 5.0
        # drain above (forward) or below (reverse) the source, in the
        # device's own polarity
        gap = np.abs(u[:, 0] - u[:, 2]) + 1e-3
        sign = 1.0 if kind.endswith("fwd") else -1.0
        u[:, 0] = u[:, 2] + ty * sign * gap
        return jdv.MOSFET1, tdv.MOSFET1, p, u
    if kind == "diode":
        p = {k: np.full(NPTS, float(v))
             for k, v in jdv.DIODE.defaults.items()}
        p.update(cjo=np.full(NPTS, 2e-12), tt=np.full(NPTS, 1e-9),
                 bv=np.full(NPTS, 20.0), n=rng.uniform(1.0, 1.5, NPTS))
        u = rng.uniform(-25.0, 0.9, (NPTS, 2))
        u[:, 1] = rng.uniform(-0.2, 0.2, NPTS)
        return jdv.DIODE, tdv.DIODE, p, u
    if kind == "diode_rs":
        # the graetz rectifier's d1n4007, rs varied; u = [p, n, internal]
        p = {k: np.full(NPTS, float(v))
             for k, v in jdv.DIODE_RS.defaults.items()}
        p.update({"is": np.full(NPTS, 76.9e-12)},
                 rs=rng.uniform(0.01, 10.0, NPTS), bv=np.full(NPTS, 1e3),
                 ibv=np.full(NPTS, 5e-6), cjo=np.full(NPTS, 26.5e-12),
                 m=np.full(NPTS, 0.333), n=rng.uniform(1.2, 1.6, NPTS),
                 tt=np.full(NPTS, 1e-9))
        u = rng.uniform(-25.0, 1.2, (NPTS, 3))
        u[:, 1] = rng.uniform(-0.2, 0.2, NPTS)
        return jdv.DIODE_RS, tdv.DIODE_RS, p, u
    if kind == "capacitor":
        p = {"c": rng.uniform(1e-15, 1e-9, NPTS)}
        return (jdv.CAPACITOR, tdv.CAPACITOR, p,
                rng.uniform(-5, 5, (NPTS, 2)))
    # voltage sources with a packed waveform (PWL or DC)
    wave = _pwl() if kind == "vsource_pwl" else jwf.DC(3.3)
    packed = jwf.pack_waveforms([wave] * NPTS)
    p = {"acmag": np.zeros(NPTS), "acphase": np.zeros(NPTS),
         "wave": {k: np.asarray(v) for k, v in packed.items()}}
    u = rng.uniform(-5, 5, (NPTS, 3))
    return jdv.VSOURCE, tdv.VSOURCE, p, u


KINDS = ["nmos_fwd", "nmos_rev", "pmos_fwd", "pmos_rev", "diode",
         "capacitor", "vsource_pwl", "vsource_dc", "diode_rs"]


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12,
                               atol=1e-12 * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("kind", KINDS)
def test_residual_and_jacobians_match_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    jmodel, tmodel, p, u = _setup(kind, rng)
    times = rng.uniform(0.0, 6e-8, NPTS)

    def jf(uu, pp, t):
        dyn = jax_dynspec(time=t, mode=MODE_TRAN)
        fq = lambda x: jmodel.residual(x, pp, dyn)
        return fq(uu), jax.jacfwd(fq)(uu)

    (jfv, jqv), (jJ, jC) = jax.vmap(jf)(
        jnp.asarray(u), jax.tree.map(jnp.asarray, p), jnp.asarray(times))

    tp = params_from_numpy([p], device="cpu")[0]
    dyn0 = make_dynspec(mode=MODE_TRAN, device="cpu")
    tdyn = dyn0._replace(time=torch.as_tensor(times),
                         **{k: getattr(dyn0, k).expand(NPTS)
                            for k in ("temp", "gmin", "gshunt", "srcfact",
                                      "mode")})

    def tf(uu, pp, d):
        fq = lambda x: tmodel.residual(x, pp, d)
        return fq(uu), jacfwd(fq)(uu)

    (tfv, tqv), (tJ, tC) = vmap(tf)(torch.as_tensor(u), tp, tdyn)
    for a, b in ((tfv, jfv), (tqv, jqv), (tJ, jJ), (tC, jC)):
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["nmos_fwd", "pmos_rev", "diode",
                                  "diode_rs"])
def test_limiters_match_jax_exactly(kind):
    rng = np.random.default_rng(100 + len(kind))
    jmodel, tmodel, p, u = _setup(kind, rng)
    u_prev = u + rng.normal(0.0, 1.5, u.shape)
    jd = jax_dynspec(mode=MODE_TRAN)
    ref = jax.vmap(lambda a, b, pp: jmodel.limit(a, b, pp, jd))(
        jnp.asarray(u), jnp.asarray(u_prev), jax.tree.map(jnp.asarray, p))
    td = make_dynspec(mode=MODE_TRAN, device="cpu")
    got = vmap(lambda a, b, pp: tmodel.limit(a, b, pp, td))(
        torch.as_tensor(u), torch.as_tensor(u_prev),
        params_from_numpy([p], device="cpu")[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fetlim_limvds_pnjlim_match_jax_exactly():
    rng = np.random.default_rng(11)
    vnew = rng.uniform(-6, 8, 4000)
    vold = rng.uniform(-6, 8, 4000)
    vto = rng.choice([-0.9, 0.4, 0.8], 4000)
    t = lambda a: torch.as_tensor(a)
    np.testing.assert_array_equal(
        tdv.fetlim(t(vnew), t(vold), t(vto)).numpy(),
        np.asarray(jdv.fetlim(vnew, vold, vto)))
    np.testing.assert_array_equal(
        tdv.limvds(t(np.abs(vnew)), t(np.abs(vold))).numpy(),
        np.asarray(jdv.limvds(np.abs(vnew), np.abs(vold))))
    vt = np.full(4000, 0.02585)
    vcrit = np.full(4000, 0.6)
    np.testing.assert_array_equal(
        tdv.pnjlim(t(vnew), t(vold), t(vt), t(vcrit)).numpy(),
        np.asarray(jdv.pnjlim(vnew, vold, vt, vcrit)))


WAVES = {
    "dc": jwf.DC(1.25),
    "pulse": jwf.Pulse(0.0, 5.0, 1e-8, 2e-9, 3e-9, 1.5e-8, 4e-8),
    "sin": jwf.Sin(0.5, 2.0, 5e7, 1e-8, 1e6, 30.0),
    "pwl": _pwl(),
    "exp": jwf.Exp(0.0, 4.0, 5e-9, 3e-9, 3e-8, 6e-9),
    "sffm": jwf.Sffm(1.0, 0.5, 1e8, 2.0, 1e7),
}


@pytest.mark.parametrize("name", list(WAVES))
def test_eval_wave_matches_jax(name):
    wave = WAVES[name]
    packed = jwf.pack_waveforms([wave])
    ts = np.random.default_rng(5).uniform(-1e-8, 1e-7, 200)
    ref = jax.vmap(lambda t: jwf.eval_wave(
        packed["kind"][0], packed["coeffs"][0], packed["ncoef"][0], t))(
        jnp.asarray(ts))
    tp = twf.pack_waveforms([twf.Waveform(wave.kind, wave.coeffs,
                                          wave.dc)], device="cpu")
    got = twf.eval_wave(tp["kind"][0], tp["coeffs"][0], tp["ncoef"][0],
                        torch.as_tensor(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=1e-14)
    # the host breakpoints are the same too
    np.testing.assert_array_equal(
        twf.Waveform(wave.kind, wave.coeffs, wave.dc).breakpoints(1e-7),
        wave.breakpoints(1e-7))


def test_deferred_devices_raise():
    import cadnip_tpu_torch as ct
    cir = ct.Circuit("deferred")
    with pytest.raises(NotImplementedError, match="inductor"):
        cir.L("l1", "a", "0", 1e-9)


@pytest.mark.parametrize("time", [0.0, 5e-3, 1.5e-2])
def test_diode_rs_operating_point_matches_jax(time):
    """The graetz rectifier (four diodes with series rs) through the SPICE
    front end of both packages, at transient source values: at t = 0 the
    source is 0 V; at 5 ms and 15 ms it is +-20 V and two diodes conduct."""
    import cadnip_tpu as jct
    import cadnip_tpu_torch as ct
    from cadnip_tpu.models.vacask import GRAETZ
    from cadnip_tpu_torch.mna.spec import MODE_TRANOP

    jcc = jct.parse_spice(GRAETZ)
    tcc = ct.parse_spice(GRAETZ, device="cpu")
    assert [g.model.name for g in tcc.groups].count("diode_rs") == 1
    assert tcc.names == jcc.names
    jsol = jct.dc(jcc, mode=MODE_TRANOP, time=time)
    tsol = ct.dc(tcc, params_from_numpy([jax.tree.map(np.array, d)
                                         for d in jcc.params0()],
                                        device="cpu"),
                 mode=MODE_TRANOP, time=time)
    assert bool(jsol.converged) and bool(tsol.converged)
    assert int(tsol.iters) == int(jsol.iters)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               rtol=1e-9, atol=1e-12)
    if time:
        # the load sees the source less two diode drops
        assert 17.0 < abs(float(tsol.v("outp", "outn"))) < 19.5
