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
    """The devices that once raised here build now: `Circuit.L` compiles
    to the JAX package's circuit (names, classes, connections and the
    inductance), and its operating point shorts the inductor."""
    import cadnip_tpu as jct
    import cadnip_tpu_torch as ct
    cirs = []
    for pkg, kw in ((jct, {}), (ct, {"device": "cpu"})):
        cir = pkg.Circuit("deferred")
        cir.V("v1", "a", "0", dc=1.0)
        cir.R("r1", "a", "b", 1e3)
        cir.L("l1", "b", "0", 1e-9)
        cirs.append(cir.compile(**kw))
    jcc, tcc = cirs
    assert tcc.names == jcc.names and tcc.n == jcc.n == 4
    np.testing.assert_array_equal(tcc.classes, jcc.classes)
    for tg, jg in zip(tcc.groups, jcc.groups):
        assert tg.model.name == jg.model.name
        np.testing.assert_array_equal(tg.conn, jg.conn)
    assert tcc.groups[2].params["l"].tolist() == [1e-9]
    import cadnip_tpu_torch as tct
    sol = tct.dc(tcc)
    assert float(sol["b"]) == pytest.approx(0.0, abs=1e-12)
    assert float(sol.i("l1")) == pytest.approx(1e-3, rel=1e-9)


# ---------------------------------------------------------------------------
# the models that were deferred, and every noise, flicker and opvars channel

def _bjt_params(rng, ty):
    p = {k: np.full(NPTS, float(v)) for k, v in jdv.BJT.defaults.items()}
    early = rng.random(NPTS) < 0.5
    p.update(type=np.full(NPTS, ty), bf=rng.uniform(50, 200, NPTS),
             br=rng.uniform(0.5, 5, NPTS), nf=rng.uniform(1.0, 1.2, NPTS),
             nr=rng.uniform(1.0, 1.2, NPTS),
             vaf=np.where(early, rng.uniform(2, 100, NPTS), 1e12),
             var=np.where(early, rng.uniform(2, 50, NPTS), 1e12),
             cje=rng.uniform(1e-12, 1e-11, NPTS),
             cjc=rng.uniform(1e-12, 5e-12, NPTS),
             vje=rng.uniform(0.6, 0.9, NPTS), vjc=rng.uniform(0.6, 0.9, NPTS),
             mje=rng.uniform(0.3, 0.5, NPTS), mjc=rng.uniform(0.3, 0.5, NPTS),
             tf=rng.uniform(1e-10, 1e-9, NPTS),
             tr=rng.uniform(1e-9, 1e-8, NPTS),
             area=rng.uniform(0.5, 2.0, NPTS),
             **{"is": rng.uniform(1e-16, 1e-14, NPTS)})
    return p


def _setup_new(kind, rng):
    """(JAX model, port model, params, u) for the once-deferred models."""
    if kind in ("npn", "pnp"):
        u = rng.uniform(-1.5, 1.5, (NPTS, 3))
        return jdv.BJT, tdv.BJT, _bjt_params(
            rng, 1.0 if kind == "npn" else -1.0), u
    jm, tm, key, lo, hi = {
        "inductor": (jdv.INDUCTOR, tdv.INDUCTOR, "l", 1e-9, 1e-3),
        "mutual": (jdv.MUTUAL, tdv.MUTUAL, "m", -1e-6, 1e-6),
        "vcvs": (jdv.VCVS, tdv.VCVS, "gain", -10.0, 10.0),
        "vccs": (jdv.VCCS, tdv.VCCS, "gm", -1e-2, 1e-2),
        "cccs": (jdv.CCCS, tdv.CCCS, "gain", -10.0, 10.0),
        "ccvs": (jdv.CCVS, tdv.CCVS, "r", -1e3, 1e3)}[kind]
    p = {k: np.full(NPTS, float(v)) for k, v in jm.defaults.items()}
    p[key] = rng.uniform(lo, hi, NPTS)
    return jm, tm, p, rng.uniform(-5, 5, (NPTS, jm.n_local))


NEW_KINDS = ["inductor", "mutual", "vcvs", "vccs", "cccs", "ccvs", "npn",
             "pnp"]
#: the stated bar of the once-deferred models against JAX, relative
NEW_TOL = 1e-13


def _close_new(a, b):
    np.testing.assert_allclose(a, b, rtol=NEW_TOL,
                               atol=NEW_TOL * max(np.abs(b).max(), 1e-300))


def _both(kind, rng):
    jm, tm, p, u = (_setup_new if kind in NEW_KINDS else _setup)(kind, rng)
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy([p], device="cpu")[0]
    return jm, tm, jp, tp, u


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_new_models_match_jax(kind):
    """f, q and their Jacobians at seeded random points (junctions of the
    BJT past the exponential's clamps and both sides of the fc knee), and
    the parameters carried over by params_from_numpy, BJT's 18 among
    them."""
    rng = np.random.default_rng(200 + NEW_KINDS.index(kind))
    jm, tm, jp, tp, u = _both(kind, rng)
    assert set(tp) == set(tm.defaults) == set(jm.defaults)
    jd = jax_dynspec(mode=MODE_TRAN)
    td = make_dynspec(mode=MODE_TRAN, device="cpu")

    def jf(uu, pp):
        fq = lambda x: jm.residual(x, pp, jd)
        return fq(uu), jax.jacfwd(fq)(uu)

    def tf(uu, pp):
        fq = lambda x: tm.residual(x, pp, td)
        return fq(uu), jacfwd(fq)(uu)

    (jfv, jqv), (jJ, jC) = jax.vmap(jf)(jnp.asarray(u), jp)
    (tfv, tqv), (tJ, tC) = vmap(tf)(torch.as_tensor(u), tp)
    for a, b in ((tfv, jfv), (tqv, jqv), (tJ, jJ), (tC, jC)):
        _close_new(a.numpy(), np.asarray(b))


CHANNEL_KINDS = ["nmos_fwd", "pmos_rev", "diode", "diode_rs", "npn", "pnp"]


@pytest.mark.parametrize("kind", CHANNEL_KINDS)
def test_noise_flicker_opvars_match_jax(kind):
    """The white-noise, 1/f and operating-point channels at the same
    points (and the resistor's thermal noise) against JAX."""
    rng = np.random.default_rng(300 + CHANNEL_KINDS.index(kind))
    jm, tm, jp, tp, u = _both(kind, rng)
    if kind == "diode":
        p = {"kf": rng.uniform(1e-17, 1e-15, NPTS),
             "af": rng.uniform(0.8, 1.5, NPTS)}
        jp = dict(jp, **{k: jnp.asarray(v) for k, v in p.items()})
        tp = dict(tp, **{k: torch.as_tensor(v) for k, v in p.items()})
    assert tm.noise_pairs == jm.noise_pairs
    jd = jax_dynspec(mode=MODE_TRAN)
    td = make_dynspec(mode=MODE_TRAN, device="cpu")
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    for ch in ("noise", "flicker", "opvars"):
        jfn, tfn = getattr(jm, ch), getattr(tm, ch)
        assert (jfn is None) == (tfn is None), ch
        if jfn is None:
            continue
        ref = jax.vmap(lambda a, pp: jfn(a, pp, jd))(ju, jp)
        got = vmap(lambda a, pp: tfn(a, pp, td))(tu, tp)
        if isinstance(ref, dict):
            assert set(got) == set(ref)
            ref, got = [ref[k] for k in sorted(ref)], [got[k] for k in
                                                      sorted(ref)]
        ref, got = jax.tree.leaves(ref), torch.utils._pytree.tree_leaves(got)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close_new(a.numpy(), np.asarray(b))
    r = rng.uniform(1.0, 1e6, NPTS)
    np.testing.assert_allclose(
        vmap(lambda a, rr: tdv.RESISTOR.noise(a, {"r": rr}, td))(
            torch.as_tensor(u[:, :2]), torch.as_tensor(r)).numpy(),
        np.asarray(jax.vmap(lambda a, rr: jdv.RESISTOR.noise(
            a, {"r": rr}, jd))(jnp.asarray(u[:, :2]), jnp.asarray(r))),
        rtol=NEW_TOL)


@pytest.mark.parametrize("kind", ["npn", "pnp"])
def test_bjt_limiter_matches_jax_exactly(kind):
    """pnjlim on both junctions, from previous points near and far, some at
    the zeros a transient starts from: both sides of vcrit."""
    rng = np.random.default_rng(400 + len(kind))
    jm, tm, jp, tp, u = _both(kind, rng)
    u_prev = u + rng.normal(0.0, 1.0, u.shape)
    u_prev[: NPTS // 8] = 0.0
    jd = jax_dynspec(mode=MODE_TRAN)
    ref = jax.vmap(lambda a, b, pp: jm.limit(a, b, pp, jd))(
        jnp.asarray(u), jnp.asarray(u_prev), jp)
    td = make_dynspec(mode=MODE_TRAN, device="cpu")
    got = vmap(lambda a, b, pp: tm.limit(a, b, pp, td))(
        torch.as_tensor(u), torch.as_tensor(u_prev), tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # both sides of vcrit, and some instances moved by the limiter
    vt = float(td.vt)
    vcrit = vt * np.log(vt / (np.sqrt(2.0) * jp["is"] * jp["area"]))
    ty = np.asarray(jp["type"])
    vbe = ty * (u[:, 1] - u[:, 2])
    assert (vbe > vcrit).any() and (vbe < vcrit).any()
    assert (got.numpy() != u).any() and (got.numpy() == u).any()


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
