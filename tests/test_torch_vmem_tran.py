"""Kernel K2 of the port (cadnip_tpu_torch/ops/vmem_tran.py) against the
reference K2, the JAX package's Pallas integrator kernel
archive/pallas_tran.py, run in interpret mode on the CPU.

The reference lives outside the JAX package, in archive/. It is loaded as
a module of that package (so that its relative imports resolve against
cadnip_tpu) with importlib, without changing either. On the CPU the port's
`vmem_tran` runs its plain twin; the CUDA kernel is checked against the
twin by the `gpu` tests here and by chip_smoke.py.

This file: `supported`, rc, the host packer and the kernel's layouts. The
DFF and graetz cases are in test_torch_vmem_tran_dff.py and
test_torch_vmem_tran_graetz.py.
"""
import contextlib
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadnip_tpu as jct
import cadnip_tpu_torch as tct
from cadnip_tpu.models.dff import dff_netlist as jax_dff_netlist
from cadnip_tpu_torch.mna.assemble import make_sorted_scatter
from cadnip_tpu_torch.models.vacask import DARLINGTON, GRAETZ, MUL, RC_NETLIST
from cadnip_tpu_torch.ops import vmem_tran as vt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cadnip_tpu_torch", "ops", "csrc")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the L/K/E/G/F/H deck and the edge bar)


class _NumpyF64:
    """numpy with float32 meaning float64 (the reference's host packing)."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


class _JaxKeepX64:
    """jax whose enable_x64(False) context leaves x64 on."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def enable_x64(_):
        return contextlib.nullcontext()


def load_reference(x64=False):
    """The reference K2 module. With x64, a second copy of it traces the
    same kernel in f64 (its F32 dtype, host packing and x64 guard
    redirected): the reference's algorithm without its f32 arithmetic,
    which is what the f64 port computes."""
    name = "cadnip_tpu.ops.pallas_tran" + ("_f64" if x64 else "")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "archive", "pallas_tran.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        if x64:
            mod.F32 = jnp.float64
            mod.np = _NumpyF64()
            mod.jax = _JaxKeepX64()
    return sys.modules[name]


def counts(stats):
    return tuple(int(v) for v in (stats.naccept, stats.nreject,
                                  stats.nnewton))


def _on_cpu(ct):
    """The keyword that puts a circuit of the port on the host; the JAX
    package takes none."""
    return {"device": "cpu"} if ct is tct else {}


def _ladder(ct):
    cir = ct.Circuit("big")
    cir.V("v0", "n0", "0", dc=1.0)
    for i in range(200):
        cir.R(f"r{i}", f"n{i}", f"n{i + 1}", 10.0)
    return cir.compile(**_on_cpu(ct))


CIRCUITS = {"rc": lambda ct: ct.parse_spice(RC_NETLIST, **_on_cpu(ct)),
            "graetz": lambda ct: ct.parse_spice(GRAETZ, **_on_cpu(ct)),
            "mul": lambda ct: ct.parse_spice(MUL, **_on_cpu(ct)),
            "dff": lambda ct: ct.parse_spice(
                jax_dff_netlist() if ct is jct else ct.dff_netlist(),
                **_on_cpu(ct)),
            "ladder": _ladder,
            "darlington": lambda ct: ct.parse_spice(DARLINGTON,
                                                    **_on_cpu(ct)),
            "lkefgh": lambda ct: ct.parse_spice(chip_smoke.LKEFGH,
                                                **_on_cpu(ct))}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_supported_matches_reference(name):
    ref = load_reference()
    jcc, tcc = CIRCUITS[name](jct), CIRCUITS[name](tct)
    assert vt.supported(tcc) == ref.supported(jcc)
    assert vt.supported(tcc) == (name != "ladder")     # 201 unknowns > 127
    if name == "ladder":
        with pytest.raises(ValueError, match="not supported"):
            tct.vmem_tran(tcc, (0, 1e-6), dt=1e-8)
        with pytest.raises(ValueError):
            ref.vmem_tran(jcc, (0, 1e-6), dt=1e-8, interpret=True)


def test_model_without_device_function_is_refused():
    cir = tct.Circuit("custom")
    model = tct.DeviceModel(name="resistor", terminals=("p", "n"),
                            residual=tct.RESISTOR.residual,
                            defaults={"r": 1e3})
    cir.add(model, "r1", ("a", "0"), r=1e3)
    cir.V("v1", "a", "0", dc=1.0)
    assert not vt.supported(cir.compile(device="cpu"))


def test_rc_twin_meets_reference_bars():
    """rc, 0-8 ms: the twin holds the reference kernel's own bars against
    the JAX f64 runner (archive/test_vmem_tran.py: RMSE < 2e-3, max
    < 1e-2), and agrees with the reference K2 to 1e-5 V at every save
    point: the reference is f32 (about 1e-7 relative per operation), the
    port f64, and this linear circuit takes the same steps in both."""
    jcc = jct.parse_spice(RC_NETLIST)
    ref = jct.tran(jcc, (0, 8e-3), dt=8e-6)
    k2 = load_reference().vmem_tran(jcc, (0, 8e-3), dt=8e-6,
                                    interpret=True)
    sol = tct.vmem_tran(tct.parse_spice(RC_NETLIST, device="cpu"),
                        (0, 8e-3), dt=8e-6)
    assert bool(sol.converged)
    assert sol.xs.shape == (1001, 3)
    v = sol["2"].numpy()
    vr = np.asarray(ref["2"])
    assert np.sqrt(np.mean((v - vr) ** 2)) < 2e-3
    assert np.abs(v - vr).max() < 1e-2
    assert np.abs(v - np.asarray(k2["2"])).max() < 1e-5
    assert counts(sol.stats)[:2] == counts(k2.stats)[:2]


@pytest.mark.parametrize("name", ["dff", "graetz"])
def test_pack_reproduces_the_assembly(name):
    """The host packer's gather plans (K2's assembly) give the same F and
    J as the port's sorted scatter (the twin's assembly) for random local
    contributions at K2's padded strides, and its parameter rows hold each
    group's parameters in the order csrc/devices.cuh reads them."""
    cc = CIRCUITS[name](tct)
    S = vt.prepare(cc, (0, 1e-9 if name == "dff" else 1e-3),
                   dt=1e-10 if name == "dff" else 1e-4)
    pk = vt.pack(S)
    n = cc.n
    rng = np.random.default_rng(3)
    # random contributions in the scatter's order, placed at K2's strides
    # (the padding holds NaN, which no plan may read)
    fl = [rng.standard_normal(g.conn.shape) for g in cc.groups]
    jl = [rng.standard_normal(g.conn.shape + g.conn.shape[1:])
          for g in cc.groups]
    floc = np.full(pk["n_loc"], np.nan)
    jloc = np.full(pk["n_jac"], np.nan)
    for gd, g, f, j in zip(pk["gdesc"], cc.groups, fl, jl):
        I, L = g.conn.shape
        ls, js = vt.loc_strides(L)
        floc[gd[6]:gd[6] + I * ls].reshape(I, ls)[:, :L] = f
        jloc[gd[7]:gd[7] + I * js].reshape(I, js)[:, :L * L] = \
            j.reshape(I, -1)
    F = np.array([floc[pk["fq_idx"][pk["fq_ptr"][r]:pk["fq_ptr"][r + 1]]]
                  .sum() for r in range(n)])
    J = np.array([jloc[pk["jc_idx"][pk["jc_ptr"][e]:pk["jc_ptr"][e + 1]]]
                  .sum() for e in range(n * n)]).reshape(n, n)
    fq = make_sorted_scatter([g.conn for g in cc.groups], n + 1, "cpu")
    jc = make_sorted_scatter([g.conn[:, :, None] * (n + 1)
                              + g.conn[:, None, :] for g in cc.groups],
                             (n + 1) ** 2, "cpu")
    F_ref = fq([torch.as_tensor(np.concatenate(
        [f.reshape(-1) for f in fl]))[None]])[0, :n].numpy()
    J_ref = jc([torch.as_tensor(np.concatenate(
        [j.reshape(-1) for j in jl]))[None]])[0].reshape(n + 1, n + 1)
    np.testing.assert_allclose(F, F_ref, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(J, J_ref[:n, :n].numpy(), rtol=1e-14,
                               atol=1e-14)
    for gd, g in zip(pk["gdesc"], cc.groups):
        mid, pnames = vt.KERNEL_MODELS[g.model]
        assert list(gd[:4]) == [mid, g.n_inst, g.model.n_local, len(pnames)]
        rows = pk["par"][gd[5]:gd[5] + g.n_inst * len(pnames)]
        for j, k in enumerate(pnames):
            np.testing.assert_array_equal(rows[j::len(pnames)], g.params[k])
        conn = pk["conn"][gd[4]:gd[4] + g.conn.size]
        np.testing.assert_array_equal(conn, g.conn.reshape(-1))


@pytest.mark.parametrize("name", ["dff", "graetz", "mul"])
def test_pack_slots_give_each_group_whole_warps(name):
    """K2's instance slots: every instance once, in order, each group
    starting at a warp boundary and padded with -1 to whole warps; and
    whether the locals and plans take shared memory follows their size."""
    cc = CIRCUITS[name](tct)
    S = vt.prepare(cc, (0, 1e-9), dt=1e-10)
    pk = vt.pack(S)
    inst, grp = pk["slot_inst"], pk["slot_group"]
    assert len(inst) == len(grp) and len(inst) % 32 == 0
    np.testing.assert_array_equal(inst[inst >= 0], np.arange(pk["n_inst"]))
    for gi, (gd, g) in enumerate(zip(pk["gdesc"], cc.groups)):
        slots = np.nonzero(grp == gi)[0]
        assert slots[0] % 32 == 0 and len(slots) == -(-g.n_inst // 32) * 32
        np.testing.assert_array_equal(inst[slots[:g.n_inst]],
                                      gd[8] + np.arange(g.n_inst))
        assert (inst[slots[g.n_inst:]] == -1).all()
    cfg, _ = vt._kernel_args(S)
    fits = vt.smem_bytes(cc.n) + vt.locals_bytes(cc.n, pk) <= vt.SMEM_MAX
    assert cfg.locals_in_smem == int(fits) == 1
    assert (cfg.n_slots, cfg.n_fq, cfg.n_jc) == (
        len(inst), len(pk["fq_idx"]), len(pk["jc_idx"]))


def _fields(src, struct):
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.replace("*", " ").replace("const", " ").strip()
        if decl:
            names += [w.strip().split()[-1] for w in decl.split(",")]
    return names


def test_kernel_layouts_match_the_host():
    """The ctypes mirrors of VmemConfig and VmemPtrs, the parameter order
    of every model and the model ids agree with the CUDA sources."""
    cu = open(os.path.join(CSRC, "vmem_tran.cu")).read()
    cuh = open(os.path.join(CSRC, "devices.cuh")).read()
    assert _fields(cu, "VmemConfig") == [f[0] for f in vt._Config._fields_]
    assert _fields(cu, "VmemPtrs") == [f[0] for f in vt._Ptrs._fields_]
    assert all(t in ("double", "long long") for t in re.findall(
        r"(double|long long|int)\b", re.search(
            r"struct VmemConfig \{(.*?)\};", cu, re.S).group(1)))

    def enum(first):
        body = re.search(r"enum \{ (%s = 0[^}]*)\}" % first, cuh).group(1)
        return [w.split("=")[0].strip() for w in body.split(",")]

    prefix = {"diode": "D_", "mos1": "M_", "bjt": "Q_"}
    for model, (mid, pnames) in vt.KERNEL_MODELS.items():
        name = {"diode_rs": "DIODE_RS", "mos1": "MOS1"}.get(
            model.name, model.name.upper())
        assert re.search(r"\b%s = %d\b" % (name, mid), cuh), model.name
        key = prefix.get("diode" if model.name.startswith("diode")
                         else model.name)
        if key:
            assert enum(key + pnames[0].upper()) == [
                key + p.upper() for p in pnames]
        elif pnames:
            # one parameter: its P_ index is 0
            assert len(pnames) == 1
            assert re.search(r"enum \{ P_%s = 0 \}" % pnames[0].upper(),
                             cuh), model.name
    # every built-in model has a device function
    from cadnip_tpu_torch.mna.devices import BUILTINS
    assert set(vt.KERNEL_MODELS) == set(BUILTINS.values())
    assert max(m.n_local for m in BUILTINS.values()) == int(re.search(
        r"MAX_NL = (\d+);", cuh).group(1))
    assert vt.smem_bytes(vt.MAX_UNKNOWNS) <= 232448 - 2048


def test_phase_slots_match_the_kernel():
    """The statistics slots and phase names of the host agree with the
    kernel's N_STATS, PHASE0, phase enum and warp-solve bound."""
    cu = open(os.path.join(CSRC, "vmem_tran.cu")).read()
    assert int(re.search(r"N_STATS = (\d+);", cu).group(1)) == vt._N_STATS
    assert int(re.search(r"PHASE0 = (\d+);", cu).group(1)) == vt._PHASE0
    body = re.search(r"enum \{ (PH_EVAL[^}]*)\}", cu).group(1)
    phases = [w.strip() for w in body.split(",") if w.strip()]
    assert phases[-1] == "N_PHASES" and len(phases) - 1 == len(vt.PHASES)
    assert vt._PHASE0 + len(vt.PHASES) <= vt._N_STATS
    assert int(re.search(r"WARP_SOLVE_MAX = (\d+);", cu).group(1)) \
        == vt.WARP_SOLVE_MAX


def test_warp_iteration_slot_matches_the_kernel():
    """The statistics slot of the warp-resident iterations is the kernel's
    WARP_ITERS, and a slot no other statistic uses: past the counts the
    host reads and before the phase cycles."""
    cu = open(os.path.join(CSRC, "vmem_tran.cu")).read()
    slot = int(re.search(r"WARP_ITERS = (\d+);", cu).group(1))
    assert slot == vt._WARP_ITERS
    assert 5 <= slot < vt._PHASE0
    assert re.search(r"P\.stats\[WARP_ITERS\] = warp_iters;", cu)


def test_block_solve_layout_matches_the_kernel():
    """The host's block size is the kernel's (its block solve is compiled
    for that many threads), and above the warp solve the shared memory it
    sizes holds the blocked elimination's work area: K1's, for n + 1
    columns and every trailing column of the first panel."""
    cu = open(os.path.join(CSRC, "vmem_tran.cu")).read()
    assert int(re.search(r"K2_THREADS = (\d+);", cu).group(1)) == vt._THREADS
    from cadnip_tpu_torch.ops.gj_solve import PANEL, block_work_bytes
    for n in (vt.WARP_SOLVE_MAX, vt.WARP_SOLVE_MAX + 1, 64, vt.MAX_UNKNOWNS):
        plain = 8 * (n * (n + 1) + vt._N_VECTORS * (n + 1))
        if n <= vt.WARP_SOLVE_MAX:
            # the warp instance: rows of A at an odd stride, the
            # trial iterate with its ground slot, the chunk's entry state,
            # F, Q, the node-voltage mask, the accepted step with its
            # ground slot, its Q and charges, and two vectors of one warp
            assert vt.smem_bytes(n) == 8 * (n * (n | 1) + 2 * (n + 1)
                                            + 6 * n + 2 * 32)
        else:
            zw = -(-(n + 1 - PANEL) // PANEL) * PANEL
            assert zw >= n + 1 - PANEL and zw % PANEL == 0
            assert vt.smem_bytes(n) == plain + 8 * n * (n % 2) \
                + block_work_bytes(n, zw, 8)
    assert vt.smem_bytes(vt.MAX_UNKNOWNS) == 167912


def test_cuda_circuit_needs_the_kernel():
    """A circuit on a device the kernel does not serve is refused, not
    handed to the twin."""
    cc = tct.parse_spice(RC_NETLIST, device="cpu")
    S = vt.prepare(cc, (0, 1e-4), dt=1e-5)
    S.cc = tct.parse_spice(RC_NETLIST, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vt.integrate(S)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K2 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rc", "dff"])
def test_k2_matches_twin_on_gpu(cuda, name):
    span, dt = {"rc": ((0, 8e-3), 8e-6), "dff": ((0, 6e-8), 3.333e-10)}[name]
    net = RC_NETLIST if name == "rc" else tct.dff_netlist()
    S = vt.prepare(tct.parse_spice(net, device=cuda), span, dt=dt)
    before = tct.vmem_tran.launches
    rk = vt.integrate(S)
    rp = vt.integrate_plain(S)
    assert tct.vmem_tran.launches == before + 1
    assert not rk.stats[3]
    # rounding (FMA contraction, summation order, forward against reverse
    # mode derivatives) may flip a step decision: then the waveforms are
    # two step sequences of one integrator, held to its reltol
    assert all(abs(a - b) <= max(1, 0.02 * b)
               for a, b in zip(rk.stats[:3], rp.stats[:3]))
    rmse = float((rk.xs - rp.xs).pow(2).mean().sqrt())
    tol = 1e-7 if rk.stats[:3] == rp.stats[:3] else 1e-4
    assert rmse <= tol * (1.0 if name == "rc" else 5.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(chip_smoke.eval_inputs(
    np.random.default_rng(4), I=1)))
def test_device_functions_match_twin_on_gpu(cuda, name):
    from cadnip_tpu_torch.mna.spec import MODE_TRAN, make_dynspec

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=cuda)

    dyn = make_dynspec(gmin=vt.GMIN, mode=MODE_TRAN, device=cuda)
    model, u, up, p, wv = chip_smoke.eval_inputs(
        np.random.default_rng(4))[name]
    args = (t(u), t(up), {k: t(v) for k, v in p.items()},
            None if wv is None else t(wv), dyn)
    for a, b in zip(vt.eval_group(model, *args),
                    vt.eval_group_plain(model, *args)):
        assert float((a - b).abs().max()) <= 1e-10 * max(
            float(b.abs().max()), 1e-300), name


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["darlington", "lkefgh"])
def test_k2_new_models_match_twin_on_gpu(cuda, name):
    """The darlington (BJTs) over 0-1 us and the L/K/E/G/F/H deck over
    0-2 us through K2 against the twin, at chip_smoke.py's bars."""
    net = DARLINGTON if name == "darlington" else chip_smoke.LKEFGH
    span = (0, 1e-6) if name == "darlington" else (0, 2e-6)
    S = vt.prepare(tct.parse_spice(net, device=cuda), span, dt=2e-9)
    rk, rp = vt.integrate(S), vt.integrate_plain(S)
    assert not rk.stats[3] and not rp.stats[3]
    assert all(abs(a - b) <= max(1, chip_smoke.TWIN_COUNT_TOL * b)
               for a, b in zip(rk.stats[:3], rp.stats[:3]))
    tol = (chip_smoke.TWIN_RMSE_TOL if rk.stats[:3] == rp.stats[:3]
           else chip_smoke.TWIN_FLIP_TOL)
    assert float((rk.xs - rp.xs).pow(2).mean().sqrt()) / 5.0 <= tol


#: the circuits of CIRCUITS that take K2's warp instance (n <= 32): the
#: netlist, a span, its save interval, the waveform scale, and whether K2
#: takes the twin's step counts exactly. graetz does not: its diodes put
#: the system's condition near 1e15, and one step decision over 0-20 ms
#: flips between the kernel (products contracted into FMAs) and the twin's
#: torch ops, in the parent kernel as in this one; it is held to
#: chip_smoke.py's bars for a flipped decision.
WARP_SPANS = {"rc": (RC_NETLIST, (0, 4e-3), 8e-6, 1.0, True),
              "graetz": (GRAETZ, (0, 2e-2), 1e-4, 20.0, False),
              "mul": (MUL, (0, 5e-6), 1e-8, 50.0, True),
              "dff": (tct.dff_netlist(), (0, 6e-8), 3.333e-10, 5.0, True),
              "darlington": (DARLINGTON, (0, 1e-6), 2e-9, 5.0, True),
              "lkefgh": (chip_smoke.LKEFGH, (0, 2.5e-7), 2e-9, 2.0, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(WARP_SPANS))
def test_k2_warp_solve_replays_twin_counts_on_gpu(cuda, name):
    """Each circuit of n <= 32 over its span through the warp-resident
    Newton iteration: K2 takes the twin's accepted / rejected / Newton
    counts (exactly, but for graetz), runs every iteration on the warp
    path, and reports the cycles of every phase."""
    net, span, dt, scale, exact = WARP_SPANS[name]
    S = vt.prepare(tct.parse_spice(net, device=cuda), span, dt=dt)
    assert S.cc.n <= vt.WARP_SOLVE_MAX
    rk, rp = vt.integrate(S), vt.integrate_plain(S)
    assert not rk.stats[3] and not rp.stats[3]
    assert rk.warp_iterations == rk.stats[2]
    assert set(rk.phases) == set(vt.PHASES)
    assert all(v > 0 for v in rk.phases.values())
    rmse = float((rk.xs - rp.xs).pow(2).mean().sqrt())
    if exact:
        assert rk.stats == rp.stats
        assert rmse <= 1e-7 * scale
    else:
        assert all(abs(a - b) <= max(1, chip_smoke.TWIN_COUNT_TOL * b)
                   for a, b in zip(rk.stats[:3], rp.stats[:3]))
        assert rmse <= chip_smoke.TWIN_FLIP_TOL * scale


@pytest.mark.gpu
def test_k2_block_solve_runs_no_warp_iterations_on_gpu(cuda):
    """n = 42 takes the block instance: its warp-iteration counter stays
    at 0 while its Newton iterations run."""
    S = vt.prepare(_rc_ladder(tct), (0, 4e-6), dt=2e-7)
    assert S.cc.n > vt.WARP_SOLVE_MAX
    rk = vt.integrate(S)
    assert rk.stats[2] > 0 and not rk.stats[3]
    assert rk.warp_iterations == 0


def _rc_ladder(ct, sections=40):
    """An RC ladder driven by a pulse: n = sections + 2 unknowns."""
    cir = ct.Circuit("ladder")
    cir.V("vs", "n0", "0", wave=ct.Pulse(0.0, 1.0, 1e-6, 1e-7, 1e-7, 5e-6,
                                         1.2e-5))
    for i in range(sections):
        cir.R(f"r{i}", f"n{i}", f"n{i + 1}", 100.0)
        cir.C(f"c{i}", f"n{i + 1}", "0", 1e-9)
    return cir.compile(device="cuda")


@pytest.mark.gpu
def test_k2_block_solve_matches_twin_on_gpu(cuda):
    """n > 32: K2 keeps the block elimination, and takes the twin's
    counts on a linear ladder."""
    S = vt.prepare(_rc_ladder(tct), (0, 2e-5), dt=2e-7)
    assert S.cc.n > vt.WARP_SOLVE_MAX
    rk, rp = vt.integrate(S), vt.integrate_plain(S)
    assert rk.stats == rp.stats and not rk.stats[3]
    assert float((rk.xs - rp.xs).abs().max()) <= 1e-9


@pytest.mark.gpu
def test_k2_locals_in_device_memory_give_the_same_bits_on_gpu(cuda):
    """The per-instance locals and plans in device memory (the layout of
    a circuit too large for shared memory) give the bits of the shared
    memory layout."""
    import ctypes
    S = vt.prepare(tct.parse_spice(tct.dff_netlist(), device=cuda),
                   (0, 3e-8), dt=3.333e-10)
    ref = vt.integrate(S)
    cfg, t = vt._kernel_args(S)
    assert cfg.locals_in_smem == 1
    cfg.locals_in_smem = 0
    ptrs = vt._Ptrs(**{k: t[k].data_ptr() for k in vt._PTRS})
    err = vt.load_library().vmem_tran_f64(
        ctypes.byref(cfg), ctypes.byref(ptrs), vt._THREADS,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert tuple(t["stats"].tolist()[:4]) == ref.stats
    assert torch.equal(t["xs"][:S.n_save], ref.xs)


def test_twin_from_a_host_copy_of_the_setup():
    """chip_smoke.py's phase 6 runs the twin in a worker from a host copy
    of the card's set-up (host_setup, cpu_k2_twin): on the CPU the copy
    gives the same transient as the set-up itself, bit for bit."""
    S = vt.prepare(tct.parse_spice(RC_NETLIST, device="cpu"), (0, 1e-3),
                   dt=8e-6)
    ref = vt.integrate_plain(S)
    got = chip_smoke.cpu_k2_twin(RC_NETLIST, chip_smoke.host_setup(S))
    np.testing.assert_array_equal(got["xs"], ref.xs.numpy())
    assert got["stats"] == tuple(int(v) for v in ref.stats)
