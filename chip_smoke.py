#!/usr/bin/env python3
"""Smoke run of cadnip_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit, and the torch and CUDA versions;
  2. builds kernels K1 (ops/csrc/gj_solve.cu) and K2 (ops/csrc/vmem_tran.cu)
     with nvcc for sm_90a, one nvcc each, started together;
  3. K1 against its plain PyTorch twin on the card, at the DFF's shape and
     at a batch, an inverse, a larger system, a forced pivot and in f32,
     with kernel and plain times from CUDA events;
  4. the host-loop path: parse_spice(dff_netlist(), device="cuda") then
     tran() over 0-600 ns, checked against the f64 golden
     tests/goldens/dff.npz, with K1's launch count proving that every
     Newton solve went through the kernel;
  5. K2's device functions (every model, limiter branches included, and
     every waveform kind) against the twin's group evaluation;
  6. K2 against its twin vmem_tran_plain on the card: rc, the DFF over
     0-60 ns and graetz over 0-20 ms, on the same operating point;
  7. the K2 path: vmem_tran() of the full DFF (0-600 ns), cold and warm,
     against the golden, one K2 launch per transient and K1 launches for
     the operating point; then once at the reference's 512-row chunks;
  8. vmem_tran() of the full VACASK graetz span (0-1 s at 1 us, 1,000,001
     save rows) within bench.py's gates;
  9. a JSON line of the kernels, the card's name and power limit, and the
     last line {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
RMSE_TOL = 1e-6        # relative RMSE of q, scale 5 V (BASELINE.json bar)
RESID_TOL = 1e-13      # ||A x - b||_inf / (||A||_inf ||x||_inf), f64
EVAL_TOL = 1e-10       # K2 device functions vs the twin, normwise relative
TWIN_RMSE_TOL = 1e-7   # K2 vs twin waveform RMSE, relative to the scale
TWIN_FLIP_TOL = 1e-4   # the same after a flipped step decision (reltol)
TWIN_COUNT_TOL = 0.02  # K2 vs twin accepted / rejected / Newton counts
GRAETZ_TOL = 2e-3      # bench.py's golden gate for graetz (scale 20 V)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def golden_rmse(sol, name, node_a, node_b=None, scale=1.0):
    """Relative RMSE of a waveform against tests/goldens/<name>.npz at the
    golden's save instants (bench.py's golden_rmse)."""
    g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    v = sol[node_a].cpu().numpy()
    if node_b is not None:
        v = v - sol[node_b].cpu().numpy()
    gv = g[node_a] - (g[node_b] if node_b else 0.0)
    vi = np.interp(g["ts"], np.asarray(sol.ts), v)
    return float(np.sqrt(np.mean((vi - gv) ** 2))) / scale


def kernel_cases(card):
    """Phase 3: K1 against gj_solve_plain on the card."""
    import torch
    from cadnip_tpu_torch.ops.gj_solve import gj_solve, gj_solve_plain

    rng = np.random.default_rng(0)
    cases = [("f64 n=19 k=1 b=1", 19, 1, 1, torch.float64, False),
             ("f64 n=19 k=19 b=1 (inverse)", 19, 19, 1, torch.float64,
              False),
             ("f64 n=19 k=1 b=4096", 19, 1, 4096, torch.float64, False),
             ("f64 n=128 k=1 b=64", 128, 1, 64, torch.float64, False),
             ("f64 n=19 k=1 b=1 A[5,5]=0", 19, 1, 1, torch.float64, True),
             ("f32 n=19 k=1 b=1", 19, 1, 1, torch.float32, False)]
    results = {}
    for name, n, k, b, dtype, zero_diag in cases:
        # well-conditioned (eigenvalues within ~1 of 2), so the residual
        # bound below tests the elimination, not the matrix
        A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        if zero_diag:
            A[:, 5, 5] = 0.0
        if k == n:
            Bm = np.broadcast_to(np.eye(n), (b, n, n)).copy()
        else:
            Bm = rng.standard_normal((b, n, k))
        At = torch.as_tensor(A, dtype=dtype, device="cuda")
        Bt = torch.as_tensor(Bm, dtype=dtype, device="cuda")
        X = gj_solve(At, Bt)
        Xp = gj_solve_plain(At, Bt)
        torch.cuda.synchronize()
        if X.shape != (b, n, k) or not bool(torch.isfinite(X).all()):
            raise RuntimeError(f"K1 {name}: bad output {tuple(X.shape)}")
        err = float((X - Xp).abs().max())
        # nvcc contracts a - f*b into an FMA and the plain twin does not:
        # the two agree to rounding, scaled by the solution's size
        tol = (1e-10 if dtype == torch.float64 else 1e-4) \
            * max(1.0, float(Xp.abs().max()))
        if not err <= tol:
            raise RuntimeError(f"K1 {name}: max |kernel - plain| {err:.3e} "
                               f"> {tol:.1e}")
        line = f"K1 {name}: max_abs_err {err:.3e} (tol {tol:.1e})"
        if dtype == torch.float64:
            x64 = X.cpu().numpy()
            res = np.abs(A @ x64 - Bm).max(axis=(1, 2))
            scale = (np.abs(A).sum(-1).max(-1)
                     * np.abs(x64).max(axis=(1, 2)))
            rel = float((res / scale).max())
            if not rel <= RESID_TOL:
                raise RuntimeError(f"K1 {name}: residual {rel:.3e} > "
                                   f"{RESID_TOL:.0e}")
            line += f", residual {rel:.3e}"
        reps = 20 if b * n > 10000 else 200
        ms = cuda_time_ms(lambda: gj_solve(At, Bt), reps)
        plain_ms = cuda_time_ms(lambda: gj_solve_plain(At, Bt), reps)
        print(f"{line}; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f}"
              f" us [{card}]", flush=True)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def run_dff(card):
    """Phase 4: the DFF transient on the card through tran(), through K1."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    g = np.load(os.path.join(GOLDENS, "dff.npz"))
    out = {}
    for label in ("cold", "warm"):
        cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
        torch.cuda.synchronize()
        gj_solve.launches = 0
        t = time.perf_counter()
        sol = ct.tran(cc, (0, 6e-7), dt=3.333e-10, max_steps=100000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = gj_solve.launches
        q = sol["q"].cpu().numpy()
        st = sol.stats
        nnewton = int(st.nnewton)
        op_iters = int(sol.op_iters)
        if not bool(sol.converged):
            raise RuntimeError(f"DFF {label}: transient did not converge")
        if q.shape != g["q"].shape or not np.isfinite(q).all():
            raise RuntimeError(f"DFF {label}: bad q {q.shape}")
        rmse = float(np.sqrt(np.mean((q - g["q"]) ** 2))) / 5.0
        if not rmse <= RMSE_TOL:
            raise RuntimeError(f"DFF {label}: q relative RMSE {rmse:.3e} > "
                               f"{RMSE_TOL:.0e}")
        if launches < op_iters + nnewton:
            raise RuntimeError(f"DFF {label}: {launches} K1 launches < "
                               f"{op_iters} DC + {nnewton} transient Newton "
                               f"iterations")
        print(f"DFF tran() {label}: wall {wall:.3f} s, accepted "
              f"{int(st.naccept)}, rejected {int(st.nreject)}, newton "
              f"{nnewton} + DC {op_iters}, "
              f"{(nnewton + op_iters) / wall:.1f} Newton it/s, transient "
              f"host syncs {sol.host_syncs}, K1 launches {launches}, q rel "
              f"RMSE {rmse:.3e} [{card}]", flush=True)
        out[label] = dict(launches=launches, wall=wall)
    return out


def eval_inputs(rng, I=256):
    """Seeded inputs for every model K2 has a device function for:
    {name: (model, u, u_prev, params {name: [I]}, source values or None)}.
    u_prev lies far from u, and some of it at the zeros the integrator
    starts from, so the limiters take every branch; the diode voltages
    span the exponential's clamps at +-80 thermal voltages."""
    from cadnip_tpu_torch.mna import devices as dv

    def base(model):
        return {k: np.full(I, float(v)) for k, v in model.defaults.items()}

    def far(u, sd):
        up = u + rng.normal(0.0, sd, u.shape)
        up[: I // 8] = 0.0
        return up

    out = {}
    p = base(dv.RESISTOR)
    p["r"] = rng.uniform(1.0, 1e4, I)
    u = rng.uniform(-5, 5, (I, 2))
    out["resistor"] = (dv.RESISTOR, u, u, p, None)
    p = base(dv.CAPACITOR)
    p["c"] = rng.uniform(1e-15, 1e-9, I)
    u = rng.uniform(-5, 5, (I, 2))
    out["capacitor"] = (dv.CAPACITOR, u, u, p, None)
    u = rng.uniform(-5, 5, (I, 3))
    out["vsource"] = (dv.VSOURCE, u, u, base(dv.VSOURCE),
                      rng.uniform(-20, 20, I))
    u = rng.uniform(-5, 5, (I, 2))
    out["isource"] = (dv.ISOURCE, u, u, base(dv.ISOURCE),
                      rng.uniform(-1e-3, 1e-3, I))
    for name, model in (("diode", dv.DIODE), ("diode_rs", dv.DIODE_RS)):
        p = base(model)
        p.update(cjo=rng.uniform(1e-12, 3e-11, I), tt=np.full(I, 1e-9),
                 bv=np.where(rng.random(I) < 0.5, 0.0, 20.0),
                 n=rng.uniform(1.0, 1.5, I), m=rng.uniform(0.3, 0.5, I),
                 ibv=np.full(I, 5e-6), rs=rng.uniform(0.01, 10.0, I),
                 **{"is": rng.uniform(1e-14, 1e-10, I)})
        u = rng.uniform(-25.0, 3.0, (I, model.n_local))
        u[:, 1] = rng.uniform(-0.2, 0.2, I)
        out[name] = (model, u, far(u, 1.0), p, None)
    p = base(dv.MOSFET1)
    ty = np.where(rng.random(I) < 0.5, 1.0, -1.0)
    p.update(type=ty, vth=0.8 * ty, kp=rng.uniform(50e-6, 200e-6, I),
             w=rng.uniform(0.4e-6, 2e-6, I), l=rng.uniform(0.5e-6, 1e-6, I),
             cgs=np.full(I, 5e-15), cgd=np.full(I, 5e-15),
             cbd=np.full(I, 1e-14), cbs=np.full(I, 1e-14),
             **{"lambda": np.full(I, 0.05)})
    u = rng.uniform(-0.5, 5.5, (I, 4))
    u[:, 3] = np.where(ty > 0, 0.0, 5.0)
    out["mos1"] = (dv.MOSFET1, u, far(u, 1.5), p, None)
    return out


def device_eval(card):
    """Phase 5: K2's device functions and waveforms against the twin."""
    import torch
    from cadnip_tpu_torch.mna import waveforms as wf
    from cadnip_tpu_torch.mna.spec import MODE_TRAN, make_dynspec
    from cadnip_tpu_torch.ops import vmem_tran as vt

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device="cuda")

    dyn = make_dynspec(gmin=vt.GMIN, mode=MODE_TRAN, device="cuda")
    worst = 0.0
    for name, (model, u, up, p, wv) in eval_inputs(
            np.random.default_rng(1)).items():
        args = (t(u), t(up), {k: t(v) for k, v in p.items()},
                None if wv is None else t(wv), dyn)
        got = vt.eval_group(model, *args)
        ref = vt.eval_group_plain(model, *args)
        errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
                for a, b in zip(got, ref)]
        worst = max(worst, *errs)
        print(f"K2 device eval {name}: max relative error (f, q, J, C, "
              f"u_eval) " + ", ".join(f"{e:.2e}" for e in errs), flush=True)
        if not max(errs) <= EVAL_TOL:
            raise RuntimeError(f"K2 device eval {name}: {max(errs):.3e} > "
                               f"{EVAL_TOL:.0e}")
    waves = [wf.DC(1.25), wf.Pulse(0.0, 5.0, 1e-8, 2e-9, 3e-9, 1.5e-8, 4e-8),
             wf.Sin(0.5, 2.0, 5e7, 1e-8, 1e6, 30.0),
             wf.PWL([0, 0, 1e-8, 5.0, 2e-8, 5.0, 2.1e-8, 0.5, 5e-8, 1.0]),
             wf.Exp(0.0, 4.0, 5e-9, 3e-9, 3e-8, 6e-9),
             wf.Sffm(1.0, 0.5, 1e8, 2.0, 1e7)]
    packed = wf.pack_waveforms(waves, device="cuda")
    ts = t(np.random.default_rng(2).uniform(-1e-8, 1e-7, 512))
    got = vt.wave_values(packed, ts)
    ref = torch.stack([vt.wave_values_plain(packed, x) for x in ts])
    err = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    print(f"K2 waveforms (6 kinds x 512 times): max error {err:.2e}",
          flush=True)
    if not err <= EVAL_TOL:
        raise RuntimeError(f"K2 waveforms: {err:.3e} > {EVAL_TOL:.0e}")
    return max(worst, err)


def k2_vs_twin(card):
    """Phase 6: one K2 launch against the twin on the same set-up."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.vacask import GRAETZ, RC_NETLIST
    from cadnip_tpu_torch.ops import vmem_tran as vt

    cases = [("rc", RC_NETLIST, (0, 8e-3), 8e-6, ("2", None), 1.0),
             ("dff", ct.dff_netlist(), (0, 6e-8), 3.333e-10, ("q", None),
              5.0),
             ("graetz", GRAETZ, (0, 2e-2), 1e-4, ("outp", "outn"), 20.0)]
    out = {}
    for name, net, span, dt, (na, nb), scale in cases:
        cc = ct.parse_spice(net, device="cuda")
        S = vt.prepare(cc, span, dt=dt)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rk = vt.integrate(S)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        t = time.perf_counter()
        rp = vt.integrate_plain(S)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3

        def wave(r):
            v = r.xs[:, cc.index_of(na)]
            return v if nb is None else v - r.xs[:, cc.index_of(nb)]

        rmse = float((wave(rk) - wave(rp)).pow(2).mean().sqrt()) / scale
        err = float((rk.xs - rp.xs).abs().max())
        # within 2 %, and at least one count apart (2 % of the 5 rejects of
        # rc is a tenth of a step)
        counts_ok = all(abs(a - b) <= max(1.0, TWIN_COUNT_TOL * b)
                        for a, b in zip(rk.stats[:3], rp.stats[:3]))
        print(f"K2 vs twin {name} {span[1]:g} s: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.1f} ms; kernel / twin accepted, rejected, newton "
              f"{rk.stats[:3]} / {rp.stats[:3]}; waveform RMSE/scale "
              f"{rmse:.2e}, max |dx| {err:.2e} [{card}]", flush=True)
        if rk.stats[3] or rp.stats[3]:
            raise RuntimeError(f"K2 vs twin {name}: the integrator failed")
        # the bar holds while both take the same steps. Last-bit
        # differences (dual-number against reverse-mode derivatives,
        # summation order, FMA), amplified by an ill-conditioned system
        # (graetz: c0*C near 10 S beside 1e-12 S), can flip one step
        # decision; from there the two are two step sequences of one
        # integrator, held to its reltol
        tol = (TWIN_RMSE_TOL if rk.stats[:3] == rp.stats[:3]
               else TWIN_FLIP_TOL)
        if not rmse <= tol:
            raise RuntimeError(f"K2 vs twin {name}: RMSE {rmse:.3e} > "
                               f"{tol:.0e}")
        if not counts_ok:
            raise RuntimeError(f"K2 vs twin {name}: counts {rk.stats[:3]} vs"
                               f" {rp.stats[:3]} differ by more than 2 %")
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)
    return out


def k2_dff(card):
    """Phase 7: the K2 path, vmem_tran() of the full DFF.

    Cold and warm with the whole save grid in one chunk, gated on the
    golden at 1e-6; then once at the reference's 512-row chunks. Those
    chunk caps perturb the step sequence enough to move the q edge at
    403 ns by about 0.1 ps, which alone costs 2.5e-6 of relative RMSE (the
    reference K2 itself: 6.4e-6 in f32, 2.5e-6 traced in f64): that run is
    held to 1e-5."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    g = np.load(os.path.join(GOLDENS, "dff.npz"))
    out = {}
    for label, rc, tol in (("cold", 2048, RMSE_TOL), ("warm", 2048, RMSE_TOL),
                           ("512-row chunks", 512, 1e-5)):
        cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
        torch.cuda.synchronize()
        gj_solve.launches = 0
        ct.vmem_tran.launches = 0
        t = time.perf_counter()
        sol = ct.vmem_tran(cc, (0, 6e-7), dt=3.333e-10, rows_per_chunk=rc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k1, k2 = gj_solve.launches, ct.vmem_tran.launches
        st = sol.stats
        q = sol["q"].cpu().numpy()
        nnewton, op_iters = int(st.nnewton), int(sol.op_iters)
        if not bool(sol.converged):
            raise RuntimeError(f"DFF K2 {label}: transient did not converge")
        if q.shape != g["q"].shape or not np.isfinite(q).all():
            raise RuntimeError(f"DFF K2 {label}: bad q {q.shape}")
        rmse = float(np.sqrt(np.mean((q - g["q"]) ** 2))) / 5.0
        if not rmse <= tol:
            raise RuntimeError(f"DFF K2 {label}: q relative RMSE {rmse:.3e}"
                               f" > {tol:.0e}")
        if k2 != 1 or k1 < op_iters or op_iters == 0:
            raise RuntimeError(f"DFF K2 {label}: {k2} K2 launches (want 1), "
                               f"{k1} K1 launches for {op_iters} DC Newton "
                               f"iterations")
        tm = sol.timings
        print(f"DFF vmem_tran() {label} (rows_per_chunk {rc}): wall "
              f"{wall:.3f} s (operating point {tm['prepare']:.3f} s, K2 "
              f"{tm['integrate']:.3f} s), accepted {int(st.naccept)}, "
              f"rejected {int(st.nreject)}, newton {nnewton} + DC "
              f"{op_iters}, {nnewton / tm['integrate']:.0f} transient Newton"
              f" it/s, {(nnewton + op_iters) / wall:.1f} Newton it/s overall,"
              f" K2 launches {k2}, K1 launches {k1}, q rel RMSE {rmse:.3e} "
              f"[{card}]", flush=True)
        out[label] = dict(k1=k1, k2=k2, wall=wall)
    return out


def k2_graetz(card):
    """Phase 8: the full VACASK graetz span through vmem_tran()."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.vacask import GRAETZ

    cc = ct.parse_spice(GRAETZ, device="cuda")
    ct.vmem_tran.launches = 0
    t = time.perf_counter()
    sol = ct.vmem_tran(cc, (0, 1.0), dt=1e-6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    st = sol.stats
    v = (sol["outp"] - sol["outn"]).cpu().numpy()
    late = np.asarray(sol.ts) > 0.06
    ripple_ok = 16.0 < v[late].min() < v[late].max() < 19.5
    rmse = golden_rmse(sol, "graetz", "outp", "outn", scale=20.0)
    tm = sol.timings
    print(f"graetz vmem_tran() 0-1 s at 1 us ({v.shape[0]} rows): wall "
          f"{wall:.3f} s (operating point {tm['prepare']:.3f} s, K2 "
          f"{tm['integrate']:.3f} s), accepted {int(st.naccept)}, rejected "
          f"{int(st.nreject)}, newton {int(st.nnewton)}, K2 launches "
          f"{ct.vmem_tran.launches}, v(outp,outn) after 0.06 s in "
          f"[{v[late].min():.4f}, {v[late].max():.4f}] V, golden rel RMSE "
          f"{rmse:.3e} [{card}]", flush=True)
    if not bool(sol.converged) or not np.isfinite(v).all():
        raise RuntimeError("graetz K2: transient failed")
    if not (ripple_ok and rmse <= GRAETZ_TOL):
        raise RuntimeError(f"graetz K2: ripple in range {ripple_ok}, golden"
                           f" RMSE {rmse:.3e} (gate {GRAETZ_TOL:.0e})")
    if ct.vmem_tran.launches != 1:
        raise RuntimeError(f"graetz K2: {ct.vmem_tran.launches} launches")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    if not os.path.exists(os.path.join(GOLDENS, "dff.npz")):
        raise SystemExit(f"chip_smoke: goldens missing under {GOLDENS} (run"
                         f" from a checkout of the repository)")
    sys.path.insert(0, ROOT)
    from cadnip_tpu_torch.ops import nvcc
    from cadnip_tpu_torch.ops.gj_solve import load_library as load_k1
    from cadnip_tpu_torch.ops.vmem_tran import load_library as load_k2

    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t = time.perf_counter()
    nvcc.build(["gj_solve", "vmem_tran"])
    load_k1()
    load_k2()
    print(f"K1 + K2 build+load (parallel nvcc) "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    cases = kernel_cases(card)
    dff = run_dff(card)
    device_eval(card)
    twin = k2_vs_twin(card)
    k2 = k2_dff(card)
    k2_graetz(card)
    main_case = cases["f64 n=19 k=1 b=1"]
    kernels = [{"name": "K1 gj_solve", "route": "cuda",
                "source": "cadnip_tpu_torch/ops/csrc/gj_solve.cu",
                "replaces": "cadnip_tpu/ops/pallas_solve.py:35",
                "launches": dff["cold"]["launches"],
                "max_abs_err": main_case["max_abs_err"],
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"]},
               {"name": "K2 vmem_tran", "route": "cuda",
                "source": "cadnip_tpu_torch/ops/csrc/vmem_tran.cu",
                "replaces": "archive/pallas_tran.py:372",
                "launches": k2["cold"]["k2"],
                "max_abs_err": twin["dff"]["max_abs_err"],
                "ms": twin["dff"]["ms"],
                "plain_ms": twin["dff"]["plain_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
