#!/usr/bin/env python3
"""Smoke run of cadnip_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:
  1. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit, and the torch and CUDA versions;
  2. builds kernels K1 (ops/csrc/gj_solve.cu) and K2 (ops/csrc/vmem_tran.cu)
     with nvcc for sm_90a, and K2 with the emitted ekv26 (phase 12b's), one
     nvcc each, started together;
  3. K1 against its plain PyTorch twin on the card (gj_solve_plain for
     the warp variant, the blocked gj_solve_blocked_plain for the block
     and grid variants), at the DFF's shape and at a batch, an inverse, a
     larger system, a forced pivot and in f32, the block variant's shapes
     (the DFF's AC sweep [801, 38, 39], the nested BBD level's block
     solves [10, 104, 190], [64, 128, 129], [1, 160, 161] and the largest
     system one block holds, [1, 167, 168]) and the grid variant's (n =
     512 and 1024, and the 125-section ladder's AC shape [801, 254,
     255]), phase 17's to_veriloga AC [801, 16, 17], and K1's f32
     inverses (k = n) of the gjpl32ir method at phase 18's shapes
     ([1, 19, 38], [801, 38, 76], [159, 32, 64], [1, 973, 1946]) and the
     Monte Carlo's [4096, 19, 38] (F32_ROWS; f32 bar 1e-4 of the
     solution's size); where the warp variant takes the shape, the block variant
     forced at it against the blocked twin (GRID_BLOCK_TOL, the same NaN
     pattern); where one block holds a system above n = 64, the block and
     grid variants forced at it against each other (GRID_BLOCK_TOL: the
     two sum their products in other orders); kernel, block, grid, plain
     and torch.linalg.solve_ex times from CUDA events beside the bound
     from the shape (bytes over 3.35 TB/s, or the operations of an LU
     solve over 67 TFLOP/s, FP64 or FP32);
     then K1's derivative rules (jvp, vjp) through `gj_solve` against
     torch.func autodiff of the twin, at the Newton, sensitivity and
     4096-lane shapes, and each rule's fused entry (launch_tangent,
     launch_adjoint: one launch, its products in the kernel) against its
     twin; each rule's wall split into the device time of its two launches
     (graph replay), the two bare calls and the rest (functorch's dispatch
     and the route: the door);
  4. the host-loop path: parse_spice(dff_netlist(), device="cuda") then
     tran() over 0-600 ns, checked against the f64 golden
     tests/goldens/dff.npz, with K1's launch count proving that every
     Newton solve went through the kernel;
  5. K2's device functions (every model: R, C, V, I, the diodes, MOS1, L,
     K, E, G, F, H and the BJT, limiter branches included, and every
     waveform kind) against the twin's group evaluation;
  6. K2 on the card: rc over 0-4 ms, the DFF over 0-60 ns, graetz over
     0-20 ms, a 125-section RC ladder over 0-5 us (n = 127: the block
     solve, K1's blocked form, with its cycles per pivot; the locals in
     device memory), the darlington (two BJTs, 0-1 us) and an L/K/E/G/F/H
     deck (0-0.25 us), with K2's share of cycles per phase; each case's
     plain twin runs on the host CPU in a
     worker from the card's own set-up (the same operating point; graetz's
     on the card, TWIN_ON_CARD says why), and the two are held against
     each other in phase 14;
  7. the K2 path: vmem_tran() of the full DFF (0-600 ns), cold and warm,
     against the golden, one K2 launch per transient and K1 launches for
     the operating point; then once at the reference's 512-row chunks;
     with K2's share of cycles per phase of a Newton iteration;
  8. vmem_tran() of the full VACASK graetz span (0-1 s at 1 us, 1,000,001
     save rows) within bench.py's gates, with its phase shares;
 8b. vmem_tran() of the full VACASK darlington span (0-1 ms at 2 ns,
     500,001 save rows) in one K2 launch, within bench.py's physics gate;
     its first 2 us (one period of its pulse) are held against tran() on
     the host CPU (a worker) away from the switching edges in phase 14;
 8c. AC and noise on the card, 801 frequencies each in one K1 launch,
     against the same calls on the CPU: the DFF's supply rejection, its
     output noise referred to the supply, and a darlington biased ON; and
     the 125-section RC ladder's AC (n = 127: one launch of K1's grid
     variant), against the CPU port in a worker (compared in phase 14);
  9. the sweep path: bench.py's 4096-way DFF Monte Carlo (montecarlo_table
     over cq.c, mno1.w and mpo1.w, seed 42), once, through transweep() over
     0-600 ns, unchunked, every Newton iteration of all lanes one K1
     launch; four lanes held against the same rows run on the host CPU
     (in a worker process, beside the card),
     the operating point again (bit for bit) and a torch.profiler run of
     the first 10 ns of the transient from it, and
     K1's jvp and vjp rules on every lane's Jacobian at its operating
     point, held to a bound scaled by cond(G);
 10. dcsweep() with its neighbour-seeded rescue on a crippled 5-diode
     chain, against the CPU;
 11. derivatives through K1: dc_sensitivity() of the DFF operating point
     (mno1.w, cq.c, vvdd.dc) and torch.func.jacfwd through tran() of an
     RC, against the CPU (the worker's), with the jacfwd's wall and its
     rule calls and crossings of GJSolve.apply;
 12. the Verilog-A path: the EKV model compiled by the port, and the DFF
     with every MOSFET an ekv26 instance loaded by `.hdl`, through dc()
     and tran() over 0-300 ns on the card, every Newton solve a K1
     launch, gated on q still low before the latching edge (EKV_SPAN)
     and held against the CPU port over the same span (the worker's);
     its noise (q referred to vvdd) in one K1 launch against the CPU;
     the host time of one evaluation of the EKV group on the card and on
     the CPU; and a ten-diode chain behind `$limit` at DC against the
     CPU, K1's launches counted per path;
 12b. the EKV DFF through K2 (kernel vmem_tran built with the device
     function that va/cuda.py emits for ekv26): that function against the
     twin's group evaluation on the DFF's 26 instances (EVAL_TOL), then
     one K2 launch over 0-60 ns and one over 0-600 ns, q latched high
     after the 401 ns edge; their twins run on the host CPU (worker A)
     and are held to K2 in phase 14 with phase 6's cases;
 13. (in a process of its own on the same card, started before phase 9,
     its output printed when it is joined after phase 18) the fixed-step
     engines at bench.py's settings: the VACASK rc through
     tran_linear() (0-1 s at 1 us, 1,000,001 points, K^-1 one K1 launch)
     against the closed form; graetz (0-1 s at 1 us) and, in phase 13b's
     process of its own (started with phase 13's), the darlington
     (0-1 ms at 2 ns), full spans, and mul over its first two windows only
     (0-40 us at 10 ns, not bench.py's 0-5 ms: MUL_SPAN says why) through
     tran_pit(), every window-Newton iteration one K1 launch of
     [W, n, n + 1] (gated: the windows' launches equal the iterations):
     the wall split into the operating point, the periodic seed's serial
     tran() and the windows, ms per window iteration, K1 launches per part
     and peak device memory; bench.py's gates (graetz's ripple and golden,
     mul's v(20), the darlington's switching over its last period); mul's
     golden over its span (MUL_GOLDEN_TOL) and against the same
     trapezoidal recursion solved step by step on the CPU (serial_trap, a
     worker); graetz against phase 8's K2 waveform, the darlington against
     phase 8b's at the edge-masked bar; the first two windows of graetz
     and mul replayed by the CPU port's tran_pit() from the card's
     operating point and window-0 seed (a worker, beside the card's later
     runs); and K1 at each path's shape against its twin, its bound and
     solve_ex;
 15. the block-bordered-diagonal backend: a 64 x 64 power-delivery mesh
     (n = 4097) as SPICE text through parse_spice, which selects BBD; dc
     and tran over 0-3 ns on the card, every block solve and Schur solve a
     K1 launch (two per Newton iteration, gated per window); one Newton
     Jacobian through the nested Schur level against the single level;
     the same mesh compiled dense and solved with the explicit lu64 method
     as the witness; after phase 13's process has ended, K1 at the mesh's
     block and Schur shapes (and the nested level's) against its twin,
     bound and solve_ex, and the BBD Newton iteration split into the
     Schur launch, the block solves' launch and host time;
 16. (after phase 15, inside the wait on phase 13's process) Verilog-A
     absdelay, behavioral B-sources and simulate() on the card: the delay
     line of tests/test_delay.py (td = 5 us, a pulse) through tran() over
     0-30 us within its gates (out(t) = in(t - td) within 0.03, the
     plateaus within 1e-6), the mixed delay over 0-12 us with trace=True
     (1.0 at 3 us, 1.5 at 9 us), each against the CPU port (equal step
     counts, 1e-9 V, the trace's rows at equal indices) with K1 launches
     at least its Newton passes; the delay line's AC over 801 frequencies
     from 1 to 100 kHz (|H| = 1, phase -wt, one K1 launch, 1e-9 of max
     |H| of the CPU port's); simulate() of the .meas, .op/.ac/.tran and
     B-source decks of tests/test_frontend.py against the CPU port; the
     wall, Newton passes, ms per pass and the delay probe's host time per
     accepted step;
 17. (after phase 16, inside the same wait) the Spectre dialect on the
     card: the DFF written by to_spectre and sniffed back by parse_spice,
     its summary() and op_table() equal to the CPU port's, tran() over
     0-300 ns at phase 4's settings and step limit within the golden's
     bar on its rows up to 300 ns, with K1 launches at least its Newton
     passes (counts printed: the Spectre text rounds five parameters by
     an ulp), and
     TranSolution.save / load of it; simulate() of tests/test_spectre.py's
     decks (the sweep and Monte Carlo containers among them, every point
     compiled on the card) against the CPU port and the JAX tests'
     expectations, K1 launches at least one per analysis point; and an R,
     C, V, E, G network exported by to_veriloga and compiled by compile_va
     against the built-in elements, DC and an 801-frequency AC in one K1
     launch;
 18. the JAX package's accelerator solve methods: (a, in phase 13b's
     process after the darlington) the DFF through tran(method=
     "gjpl32ir") over 0-600 ns (K1 in f32 on the equilibrated Jacobian,
     one launch per Newton pass, two f64 refinement steps), gated on
     phase 4's counts, the golden's bar and f32 launches at least its
     Newton passes, held after the join against the CPU port's run
     (worker B: equal counts, 1e-9 x 5 V); the DFF through
     tran(method="lu32ir") over 0-100 ns on the golden's rows; (c) the
     DFF's supply rejection and noise through make_ac_sweep /
     make_noise_sweep(method="gjpl32ir"), one f32 launch of [801, 38,
     76] each, against phase 8c's gauss runs (1e-9); (d) phase 15's power
     grid through tran(method="gjpl32ir"), two f32 launches per Newton
     iteration (the blocks [159, 32, 64], the Schur [1, 973, 1946]),
     against phase 15's gauss run; (e) the mesh: tests/
     test_sharded_dff.py's 1024-lane DFF Monte Carlo through
     sharded_transweep over two shards of the one card against the local
     transweep (equal counts, 1e-9 x 5 V, bit-equality printed; the JAX
     test's gates), and sharded_dcsweep of the same table against the
     plain DC chain. TF32 is asserted off. Phases c-e run in the main
     process after phase 17, inside the wait on phases 13 and 13b;
 14. phase 6's, 12b's and 8b's comparisons with their CPU twins and phase 8c's
     ladder against the CPU port, the wall time of every phase and of the
     whole run, a JSON line of the kernels, the card's name and power
     limit, and the last line {"ok": true, "device": {...}}.

From phase 9 on, two spawned worker processes replay the CPU references
beside the card's host loop: worker A phase 9's check lanes, phases 11 and
12, then phase 6's and 12b's twins; worker B phase 8b's reference, phase 8c's
ladder and the CPU sides of phases 16, 17 and 18a. Phases 13 and 13b run
at the same time in spawned processes on the card (the card must be in
the Default compute mode), phase 13's with two workers of its own (mul's
serial_trap witness and its replay; graetz's replay); their gates, launch counts and
results come back to the main process, and a failure fails the run. Every read
of a worker's result prints its wait. The workers never open the card,
and the script stops every process it started on every exit.
"""
import json
import os
import subprocess
import sys
import threading
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
#: phase 6's cases whose twin runs on the card, the others' on the host CPU
#: (a worker). graetz's: on the host the twin takes K2's counts exactly and
#: yet parts by 1.8e-6 of 20 V RMSE on an H100 (PERF.md), over
#: TWIN_RMSE_TOL: the host's libm rounds exp otherwise than the card, and
#: graetz's system (c0*C near 10 S beside 1e-12 S) amplifies the last bit
TWIN_ON_CARD = ("graetz",)
GRAETZ_TOL = 2e-3      # bench.py's golden gate for graetz (scale 20 V)
DERIV_TOL = 1e-12      # K1 jvp / vjp vs autodiff of the twin, relative
#: the kernels line's row of K1's rules: the jvp at the Monte Carlo's shape
RULE_ROW = "jvp n=19 k=1 b=4096"
#: K1's blocked form (block and grid variants) against its blocked twin on
#: the card, and the block and grid variants against each other, relative:
#: the kernels contract products into FMAs and sum the trailing product on
#: the tensor cores in another order (about 1e-15 observed)
GRID_BLOCK_TOL = 1e-12
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (on-chip guide)
#: peak rates of the H100 SXM (NVIDIA data sheet): FP64 on the tensor
#: cores, FP32 outside them
PEAK_FLOPS = {8: 67e12, 4: 67e12}
JAC_DERIV_FACTOR = 4   # the same on DFF Jacobians: / (n cond(G) eps)
#: the DFF's step counts (accepted, rejected, Newton) and DC Newton
#: iterations through tran(), as the JAX package takes them; and through
#: K2 (one 2048-row chunk), as every earlier K2 took them
DFF_TRAN_COUNTS, DFF_DC_ITERS = (995, 143, 2062), 111
DFF_K2_COUNTS = (995, 143, 2060)
MC_SPREADS = {"cq.c": 0.1, "mno1.w": 0.1, "mpo1.w": 0.1}   # bench.py:381
MC_LANES = 4096
MC_CHECK = [0, 1, 2047, 4095]   # lanes rerun on the host CPU
MC_KW = dict(dt=3.333e-10, max_steps=20000, n_save=61)
MC_TOL = 1e-9          # check lanes, card vs CPU: max |dx| / 5 V
CPU_TOL = 1e-9         # DC sweep, sensitivities, jacfwd: card vs CPU
AC_TOL = 1e-9          # AC card vs CPU, of max |H|; noise PSD, relative
AC_FREQS = (100, 1e3, 1e11)    # acdec: 801 points, 1 kHz to 100 GHz
AC_DFF_ROW = "f64 n=38 k=1 b=801 (AC sweep, DFF)"
AC_LADDER_ROW = "f64 n=254 k=1 b=801 (AC sweep, 125-section ladder)"
GRID_ROW = "f64 n=1024 k=1 b=1"
NESTED_BLOCK_ROW = "f64 n=104 k=86 b=10 (nested BBD block solves)"
#: phase 3's rows at the shapes one block's shared memory holds above the
#: warp variant: the kernels line carries each (kernel, block and grid
#: variants, solve_ex, bound)
BLOCK_ROWS = (AC_DFF_ROW, NESTED_BLOCK_ROW, "f64 n=128 k=1 b=64",
              "f64 n=160 k=1 b=1", "f64 n=167 k=1 b=1")
#: phase 3's f32 rows: K1's f32 inverse (k = n) of the "gjpl32ir" method
#: at each shape it takes (phase 18's paths, and the Monte Carlo's, which
#: no path of the script runs under gjpl32ir); the first is the kernels
#: line's f32 row
F32_ROWS = {"f32 n=19 k=19 b=1 (DFF Newton, gjpl32ir)": (19, 1),
            "f32 n=38 k=38 b=801 (DFF AC and noise, gjpl32ir)": (38, 801),
            "f32 n=32 k=32 b=159 (power grid blocks, gjpl32ir)": (32, 159),
            "f32 n=973 k=973 b=1 (power grid Schur, gjpl32ir)": (973, 1),
            "f32 n=19 k=19 b=4096 (Monte Carlo, gjpl32ir; no path)":
                (19, 4096)}
VA_EXPORT_ROW = "f64 n=16 k=1 b=801 (to_veriloga AC sweep, phase 17)"
#: tran()'s default dtmax over phase 4's 0-600 ns: a shorter span at this
#: dtmax takes phase 4's steps up to its end (phases 17 and 18)
DFF_DTMAX = 6e-7 / 50
#: phase 17's Spectre DFF and phase 18's lu32ir DFF: the spans they run,
#: each gated on the golden's rows up to its end
SPECTRE_DFF_SPAN = 3e-7
LU32_SPAN = 1e-7
#: phase 18's mesh: tests/test_sharded_dff.py's workload at full width
#: (the 1024-way DFF Monte Carlo over MC_SPREADS, seed 7, 0-100 ns), split
#: over MESH_SHARDS shards on the one card
MESH_LANES, MESH_SEED, MESH_SHARDS = 1024, 7, 2
MESH_SPAN, MESH_KW = 1e-7, dict(dt=3.333e-10, max_steps=8000)
DIODE_CHAIN = """diode chain
.model dd d is=1e-15 n=1
vs in 0 dc 0
r1 in a 10
d1 a b dd
d2 b c dd
d3 c d dd
d4 d e dd
d5 e 0 dd
.end
"""


#: an RLC driven through a VCVS with a coupled secondary, a VCCS into a
#: sensing V source, and the CCCS and CCVS that read its current: every
#: linear model K2 gained beside the BJT (L, K, E, G, F, H)
LKEFGH = """rlc driven through a vcvs, coupled secondary, controlled sources
vin in 0 dc 0 pulse 0 1 10n 5n 5n 200n 400n
e1 drv 0 in 0 2
r1 drv a 50
l1 a b 10u
c1 b 0 1n
rload b 0 1k
l2 s 0 40u
k12 l1 l2 0.8
rs s 0 200
vsen drv2 0 0
g1 0 drv2 b 0 1m
f1 0 fo vsen 5
rf fo 0 100
cf fo 0 10p
h1 ho 0 vsen 1k
rh ho 0 1k
.end
"""


#: the DFF's level-1 cards as ekv26 (models/ekv.py) cards: EKV has no
#: junction capacitors, so ekv_dff_netlist() puts each MOSFET's cbd / cbs
#: back as explicit capacitors from drain and source to its bulk
EKV_CARDS = {
    "n1": ("vto=0.8 kp=120u lambda=0.05 cgso=5f cgdo=5f", "10f"),
    "p1": ("sign=-1 vto=0.9 kp=50u lambda=0.05 cgso=6f cgdo=6f", "12f"),
}


def ekv_dff_netlist(va_path, kf=None):
    """The DFF of models/dff.py with every MOSFET an ekv26 instance, loaded
    by `.hdl` from `va_path` (a file holding models/ekv.py's EKV_VA): the
    same devices, sizes and drive waveforms, `.model n1/p1 ekv26` cards,
    and a capacitor from each drain and each source to the bulk (none
    where the two nodes are one). kf: a flicker coefficient for both
    cards (the noise phase)."""
    import re

    from cadnip_tpu_torch.models.dff import dff_netlist
    lines = dff_netlist().splitlines()
    extra = "" if kf is None else f" kf={kf}"
    out = [lines[0], f'.hdl "{va_path}"'] + [
        f".model {m} ekv26 ({card}{extra})"
        for m, (card, _) in EKV_CARDS.items()]
    caps = []
    for line in lines[1:]:
        if line.startswith((".model", "+ cbd", ".end")) or not line.strip():
            continue
        out.append(line)
        m = re.match(r"^(m\S+) (\S+) \S+ (\S+) (\S+) (n1|p1) ", line)
        if m:
            name, d, s, b, card = m.groups()
            for tag, node in (("d", d), ("s", s)):
                if node != b:
                    caps.append(f"c{name}{tag} {node} {b} "
                                f"{EKV_CARDS[card][1]}")
    return "\n".join(out + caps + [".end"])


#: phase 12: the EKV DFF's span on the card and the time at which its q
#: must still be low. 0-300 ns (clkn's edges at 50 and 100 ns, d's rise at
#: 200 ns): the span has no latching edge (that comes at 400 ns), so q
#: stays at 0 V and this gate does not test the latch. The full 0-600 ns
#: with phase 9's latch gate ran the whole script to 420.0 s, over its
#: 414 s limit (PERF.md, section 6); the JAX package holds the latch over
#: the full span and this gate over this span (tests/test_torch_ekv_dff.py),
#: and the card is held to the CPU port's replay of the span (counts
#: exact).
EKV_SPAN, EKV_LOW_AT, EKV_DT = 3e-7, 290e-9, 3.333e-10
#: phase 12b: the EKV DFF through K2 over its first 60 ns and over the whole
#: 0-600 ns, whose latching edge at 401 ns sets q high by EKV_HIGH_AT
EKV_K2_SPANS = {"ekv_dff 60 ns": 6e-8, "ekv_dff 600 ns": 6e-7}
EKV_HIGH_AT = 550e-9
#: the benchmark's copy of models/ekv.py's EKV_VA (byte for byte): a `.hdl`
#: file that the CPU worker can parse again
EKV_VA_FILE = os.path.join(ROOT, "benchmark", "configs", "ekv26.va")
EKV_KF = 1e-24         # flicker coefficient of both cards for the noise
VA_DC_TOL = 1e-12      # $limit diode chain at DC: card vs CPU, relative
#: phases 3 and 3b time a plain twin over at most this many calls: the
#: twin is no yardstick of speed, and 20 calls give a steady mean
PLAIN_REPS = 20
#: torch threads of the CPU reference worker; the card's host loop keeps
#: the other cores
CPU_THREADS = 2

#: tests/test_va_advanced.py's exponential junction behind `$limit`
VA_LIMIT_DIODE = """
module vadiode_lim(a, c);
  inout a, c; electrical a, c;
  parameter real is_ = 1e-15;
  analog I(a, c) <+ is_ * (limexp($limit(V(a, c), "pnjlim", $vt, 0.7)
                                  / $vt) - 1.0);
endmodule
"""


def _exit_with_parent():
    """End this process within a second of its parent's end, so that no
    worker outlives a run that failed (it would hold the run's output
    open)."""
    import threading
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _cpu_worker_init(root):
    """Initializer of the CPU reference worker: it replays circuits on the
    host CPU while the main process drives the card, and never opens the
    card itself."""
    _exit_with_parent()
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, root)
    import torch
    torch.set_num_threads(CPU_THREADS)


def cpu_worker():
    """One spawned process for CPU references (main() starts two). Their
    jobs run beside the card's host-bound loops, off the script's critical
    path; main() shuts them down on every exit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(ROOT,))


def cpu_mc_lanes(rows):
    """Phase 9's check lanes on the host CPU, as one B = 4 transweep."""
    import cadnip_tpu_torch as ct
    cc = ct.parse_spice(ct.dff_netlist(), device="cpu")
    t = time.perf_counter()
    ref = ct.transweep(cc, rows, (0, 6e-7), **MC_KW)
    return dict(stats=[v.numpy() for v in ref.stats[:3]], xs=ref.xs.numpy(),
                wall=time.perf_counter() - t)


def ekv_circuit(device, kf=None):
    """ekv_dff_netlist() through parse_spice on `device`, its `.hdl` file
    models/ekv.py's EKV_VA in a temporary directory."""
    import tempfile
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.ekv import EKV_VA

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ekv26.va")
        with open(path, "w") as fh:
            fh.write(EKV_VA)
        return ct.parse_spice(ekv_dff_netlist(path, kf=kf), device=device)


def cpu_ekv_tran():
    """Phase 12's CPU side: the EKV DFF through tran() over EKV_SPAN."""
    import cadnip_tpu_torch as ct
    cc = ekv_circuit("cpu")
    t = time.perf_counter()
    r = ct.tran(cc, (0, EKV_SPAN), dt=EKV_DT)
    return dict(counts=tuple(int(v) for v in r.stats[:3])
                + (int(r.op_iters),), xs=r.xs.numpy(),
                converged=bool(r.converged), wall=time.perf_counter() - t)


def cpu_ekv_noise(op_x):
    """Phase 12's CPU noise sweep, at the card's operating point."""
    import torch
    import cadnip_tpu_torch as ct
    r = ct.noise(ekv_circuit("cpu", kf=EKV_KF), "q", ct.acdec(*AC_FREQS),
                 input="vvdd", op_x=torch.as_tensor(op_x))
    return np.asarray(r.onoise_psd), np.asarray(r.inoise_psd)


def edge_masked(ts, a, b):
    """The darlington's bar away from its switching edges
    (tests/test_vacask_circuits.py::test_darlington_pit_matches_serial):
    where the pulse (period 2 us) is more than 50 ns from a transition,
    the 99th percentile of |a - b| and its maximum."""
    tm = np.asarray(ts) % 2e-6
    mask = (((tm > 0.05e-6) & (tm < 0.95e-6))
            | ((tm > 1.05e-6) & (tm < 1.95e-6)))
    err = np.abs(np.asarray(a)[mask] - np.asarray(b)[mask])
    return float(np.quantile(err, 0.99)), float(err.max())


#: the edge-masked bar: 99th percentile and maximum, volts
EDGE_Q99_TOL, EDGE_MAX_TOL = 0.15, 0.6
DARL_REF_SPAN = 2e-6   # the darlington's tran() reference: one period

#: phase 13: the fixed-step engines at bench.py's settings. rc through
#: tran_linear (bench.py:147-187); graetz, mul and the darlington through
#: tran_pit (bench.py:190-269, 411-443): the models/vacask netlist, span,
#: step, tran_pit's arguments, the waveform's nodes and its scale
RC_SPAN, RC_DT, RC_TOL = (0, 1.0), 1e-6, 1e-6
DARL_PIT_SPAN = 1e-3
#: mul runs its first two windows (two 100 kHz periods each), not bench.py's
#: 0-5 ms: through the pump's startup the window Newton's converged prefix
#: stalls at a diode's switching onset, in the JAX package as in the port
#: and at either residual floor (1e-9 or 3e-7), so every window after the
#: first falls to the rescue ladder, about 600 window iterations each (the
#: CPU port over five windows: 2874), and the 250 windows of 0-5 ms would
#: take hours on the card (PERF.md). At the span's end the pump has passed
#: bench.py's 40 V (the golden: 69.2 V)
MUL_SPAN = 4e-5
#: mul's golden gate over MUL_SPAN. bench.py's 5e-3 holds over 0-5 ms, where
#: the steady state dominates; over the startup the trapezoidal recursion
#: at 10 ns, solved one step at a time (serial_trap), itself reads 5.294e-3
#: of 50 V (scripts/torch_pit_windows.py mul 2 --serial, CPU): the step's
#: discretization error, which the window solver cannot beat
MUL_GOLDEN_TOL = 5.5e-3
#: mul's voltages on the card against serial_trap of the same recursion on
#: the host CPU (a worker), max |dv| / 50 V: each point of either lies
#: within Newton's tolerance (reltol 1e-4 of up to 97 V) of the recursion's
#: solution. The CPU port reads 3.6e-4; the JAX package's CPU run, which
#: takes a backward-Euler rescue window at 20 us, 8.7e-2 (PERF.md)
MUL_WITNESS_TOL = 1e-3
PIT_RUNS = {
    "graetz": ("GRAETZ", (0, 1.0), 1e-6,
               dict(window=8192, windows_per_exec=16), ("outp", "outn"), 20.0),
    "mul": ("MUL", (0, MUL_SPAN), 1e-8,
            dict(window=2000, windows_per_exec=64, max_iters=96),
            ("20", None), 50.0),
    "darlington": ("DARLINGTON", (0, DARL_PIT_SPAN), 2e-9,
                   dict(window=8000, windows_per_exec=32, max_iters=96),
                   ("coll", None), 5.0),
}
#: the CPU port's replay of the card's tran_pit, in a worker, compared over
#: the first two windows (graetz: one 50 Hz period each; mul: two 100 kHz
#: periods each). The span gives the replay the card's first execution:
#: graetz's 16 windows (windows_per_exec) share one pooled trip budget, and
#: over two windows alone window 1 would run out of trips and restart
#: (6.25e-5 of 20 V apart at equal counts on an H100, PERF.md); mul's whole
#: span
PIT_CPU_SPAN = {"graetz": 0.32, "mul": MUL_SPAN}
#: card against that replay, both from the card's operating point and
#: window-0 seed (a host copy): max |dx| / scale with equal window-Newton
#: iterations PIT_CPU_TOL, where one decision flips (the counts differ) the
#: runner's own tolerance TWIN_FLIP_TOL (reltol); RMSE / scale always
#: PIT_CPU_RMSE_TOL. graetz's bar is its runner's tolerance even at equal
#: counts: its off-state diodes put D's condition near 1e15, so the card's
#: and the host's last-bit differences (exp; K1's FMA) move an accepted
#: point within Newton's tolerance (on an H100, PERF.md: 8.9e-6 apart at
#: 41 / 41 iterations, RMSE 3.4e-6); mul 289 / 290 iterations, 2.9e-10
#: apart, RMSE 1.5e-11
PIT_CPU_TOL = {"graetz": TWIN_FLIP_TOL, "mul": 1e-9}
PIT_CPU_RMSE_TOL = 1e-5

#: phase 15: an on-chip power-delivery mesh, the textbook large sparse
#: circuit (IR drop): PG_SIDE x PG_SIDE nodes, 1 kOhm between neighbours,
#: 1 pF from every node to ground, a diode (is = 1e-14) from every third
#: node in each direction to ground, 1 kOhm from the far corner to ground,
#: driven at one corner by a pulse whose first edge runs from 1 to 2 ns.
#: n = 4097 unknowns, so Circuit.compile's "auto" takes the
#: block-bordered-diagonal backend: at 4096 nodes it stands at the scale
#: of the reference's first c6288 point (5,156 unknowns), whose netlist
#: neither machine has
PG_SIDE = 64
#: its transient: 0-3 ns (the first edge and a nanosecond after) at 10 ps
PG_SPAN, PG_DT = 3e-9, 1e-11
#: the BBD run against the dense witness (`lu64`, the one library path of
#: the phase, off the BBD path): dc in volts; tran at the JAX package's
#: BBD-against-dense bar (tests/test_bbd.py), and tighter where both take
#: the same steps; the nested Schur solve against the single level
PG_DC_TOL, PG_TRAN_TOL, PG_TRAN_SAME_TOL = 1e-9, 1e-3, 1e-8
PG_CURRENT_TOL = 1e-9  # the source's branch current, relative
PG_NESTED_TOL = 1e-10


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


def graph_time_ms(fn, reps):
    """Mean device time of fn() over reps calls captured in one CUDA graph:
    the launches run back to back, without the host's time between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def golden_rmse(sol, name, node_a, node_b=None, scale=1.0, upto=None):
    """Relative RMSE of a waveform against tests/goldens/<name>.npz at the
    golden's save instants (bench.py's golden_rmse), those up to `upto`
    where it is given."""
    g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    v = sol[node_a].cpu().numpy()
    if node_b is not None:
        v = v - sol[node_b].cpu().numpy()
    gv = g[node_a] - (g[node_b] if node_b else 0.0)
    m = slice(None) if upto is None else g["ts"] <= upto * (1 + 1e-12)
    vi = np.interp(g["ts"][m], np.asarray(sol.ts), v)
    return float(np.sqrt(np.mean((vi - gv[m]) ** 2))) / scale


def roofline(bytes_, flops, itemsize):
    """The least time of a kernel: the larger of its bytes over the memory
    rate and its operations over the peak rate of their type."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[itemsize]
    return dict(bytes=bytes_, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def solve_flops(n, k):
    """Operations that solving A X = B needs, A [n, n] and B [n, k]: an LU
    factorisation (2n^3/3) and two triangular solves per column (2n^2 k).
    The Gauss-Jordan elimination does about three times as many; the
    bound does not charge them."""
    return 2 * n ** 3 // 3 + 2 * n * n * k


def kernel_cases(card):
    """Phase 3: K1 against its plain twin on the card (gj_solve_plain for
    the warp variant, gj_solve_blocked_plain for the block and grid
    variants); where the warp variant takes the shape, the block variant
    forced at it against the blocked twin; where one block holds a system
    above n = 64, the block and grid variants forced at it against each
    other; times beside the bound and torch.linalg.solve_ex (timed only:
    the port never calls it)."""
    import torch
    from cadnip_tpu_torch.ops.gj_solve import (WARP_ROWS, block_bytes,
                                               block_plan, gj_solve,
                                               gj_solve_blocked_plain, launch,
                                               plain_twin, variant,
                                               MAX_SMEM)

    rng = np.random.default_rng(0)
    cases = [("f64 n=19 k=1 b=1", 19, 1, 1, torch.float64, False),
             ("f64 n=19 k=19 b=1 (inverse)", 19, 19, 1, torch.float64,
              False),
             ("f64 n=19 k=1 b=4096", 19, 1, 4096, torch.float64, False),
             ("f64 n=128 k=1 b=64", 128, 1, 64, torch.float64, False),
             ("f64 n=19 k=1 b=1 A[5,5]=0", 19, 1, 1, torch.float64, True),
             ("f32 n=19 k=1 b=1", 19, 1, 1, torch.float32, False),
             # an AC or noise sweep of 801 frequencies: the real 2n x 2n
             # embedding of the DFF (n = 19) and of the darlington (n = 7)
             (AC_DFF_ROW, 38, 1, 801, torch.float64, False),
             ("f64 n=14 k=1 b=801 (AC sweep, darlington)", 14, 1, 801,
              torch.float64, False),
             # the grid variant: beyond one block's shared memory; the
             # 125-section ladder's AC shape (n = 127, 2n = 254)
             ("f64 n=512 k=1 b=1", 512, 1, 1, torch.float64, False),
             (GRID_ROW, 1024, 1, 1, torch.float64, False),
             (AC_LADDER_ROW, 254, 1, 801, torch.float64, False),
             # the shapes one block holds: the nested BBD level's block
             # solves, a batch, the top of the range at b = 1 (the plan
             # gives small batches of wide systems to the grid variant)
             (NESTED_BLOCK_ROW, 104, 86, 10, torch.float64, False),
             ("f64 n=160 k=1 b=1", 160, 1, 1, torch.float64, False),
             ("f64 n=167 k=1 b=1", 167, 1, 1, torch.float64, False),
             # phase 16's shapes: a Newton pass of the delay lines (n = 4)
             # and the delayed AC sweep (2n = 8, 801 frequencies)
             ("f64 n=4 k=1 b=1 (delay line Newton)", 4, 1, 1,
              torch.float64, False),
             ("f64 n=8 k=1 b=801 (delayed AC sweep)", 8, 1, 801,
              torch.float64, False),
             # phase 17's to_veriloga export: its AC sweep (2n = 16)
             (VA_EXPORT_ROW, 16, 1, 801, torch.float64, False)]
    cases += [(name, n, n, b, torch.float32, False)
              for name, (n, b) in F32_ROWS.items()]
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
        Xp = plain_twin(At, Bt)
        torch.cuda.synchronize()
        if X.shape != (b, n, k) or not bool(torch.isfinite(X).all()):
            raise RuntimeError(f"K1 {name}: bad output {tuple(X.shape)}")
        err = float((X - Xp).abs().max())
        # the kernel rounds a - f*b as one FMA and the plain twin does not:
        # the two agree to rounding, scaled by the solution's size
        tol = (1e-10 if dtype == torch.float64 else 1e-4) \
            * max(1.0, float(Xp.abs().max()))
        if not err <= tol:
            raise RuntimeError(f"K1 {name}: max |kernel - plain| {err:.3e} "
                               f"> {tol:.1e}")
        which = variant(n, k, At.element_size(), b)
        line = f"K1 {name} ({which}): max_abs_err {err:.3e} (tol {tol:.1e})"
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
        if which == "grid":
            reps = 5 if b * n * n > 1e7 else 20
        block_ms = grid_ms = None
        in_block = block_bytes(n, k, At.element_size()) <= MAX_SMEM
        if which == "warp":
            # the block variant at the same shape, against its own twin
            Xb = launch(At, Bt, "block")
            Xbp = gj_solve_blocked_plain(At, Bt)
            vdiff = rel_err(Xb, Xbp)
            line += f", block vs blocked twin {vdiff:.3e}"
            btol = GRID_BLOCK_TOL if dtype == torch.float64 else 1e-4
            if not (vdiff <= btol and bool(
                    (torch.isnan(Xb) == torch.isnan(Xbp)).all())):
                raise RuntimeError(f"K1 {name}: block vs blocked twin "
                                   f"{vdiff:.3e} > {btol:.0e}")
            block_ms = cuda_time_ms(lambda: launch(At, Bt, "block"), reps)
        elif in_block and n > 2 * WARP_ROWS:
            Xb, Xg = launch(At, Bt, "block"), launch(At, Bt, "grid")
            vdiff = rel_err(Xg, Xb)
            line += (f", grid vs block {vdiff:.3e}, block plan "
                     f"{block_plan(b, n, k)}")
            if not vdiff <= GRID_BLOCK_TOL:
                raise RuntimeError(f"K1 {name}: grid vs block {vdiff:.3e} "
                                   f"> {GRID_BLOCK_TOL:.0e}")
            block_ms = cuda_time_ms(lambda: launch(At, Bt, "block"), reps)
            grid_ms = cuda_time_ms(lambda: launch(At, Bt, "grid"), reps)
        ms = cuda_time_ms(lambda: gj_solve(At, Bt), reps)
        # one system: a loop of launches times the host's launch rate; a
        # graph replay times the device
        graph_ms = graph_time_ms(lambda: gj_solve(At, Bt), reps) \
            if b == 1 else None
        plain_ms = cuda_time_ms(lambda: plain_twin(At, Bt),
                                min(reps, PLAIN_REPS, 3 if b * n > 1e5
                                    or n > 256 else PLAIN_REPS))
        library_ms = cuda_time_ms(lambda: torch.linalg.solve_ex(At, Bt),
                                  reps)
        bound = roofline(At.element_size() * b * (n * n + 2 * n * k),
                         b * solve_flops(n, k), At.element_size())
        blk = "" if block_ms is None else f", block {block_ms * 1e3:.1f} us"
        if grid_ms is not None:
            blk += f", grid {grid_ms * 1e3:.1f} us"
        if graph_ms is not None:
            blk += f", graph replay {graph_ms * 1e3:.1f} us"
        print(f"{line}; kernel {ms * 1e3:.1f} us{blk}, plain "
              f"{plain_ms * 1e3:.1f} us, torch.linalg.solve_ex "
              f"{library_ms * 1e3:.1f} us; {bound['bytes']} bytes, "
              f"{bound['flops']} FLOP, bound {bound['bound_ms'] * 1e3:.2f} "
              f"us ({bound['bound_by']}) [{card}]", flush=True)
        results[name] = dict(max_abs_err=err, ms=ms, block_ms=block_ms,
                             grid_ms=grid_ms,
                             graph_ms=graph_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             **bound)
    return results


def rel_err(a, b):
    """max |a - b| / max |b| (0 where both are 0), of tensors or arrays."""
    scale = float(abs(b).max())
    err = float(abs(a - b).max())
    return err / scale if scale > 0 else err


def k1_derivative_cases(card):
    """Phase 3b: K1's jvp and vjp rules through `gj_solve` on the card
    against torch.func autodiff of the plain twin on the same inputs; times
    beside the bound and the same torch.func call on torch.linalg.solve
    (timed only). Each rule reads A, B and one tangent or cotangent pair and
    writes X and its derivative (2n^2 + 4nk numbers per system); it does
    one solve and two more n^2 k products or triangular solves per column.
    Each rule's fused entry (the tangent: launch_tangent; the adjoint:
    launch_adjoint) is held to its twin, and the rule's wall is split into
    the device time of its two launches (the forward solve and the entry,
    each a CUDA graph replay), the host time of the two bare calls, and the
    door: the rest (functorch's dispatch and the route of the rule)."""
    import torch
    from torch.func import jvp, vjp
    from cadnip_tpu_torch.ops.gj_solve import (gj_adjoint_plain, gj_solve,
                                               gj_solve_plain,
                                               gj_tangent_plain,
                                               launch_adjoint,
                                               launch_tangent)

    rng = np.random.default_rng(5)
    out = {}
    for b, n, k in ((1, 19, 1), (1, 19, 3), (4096, 19, 1)):
        # well-conditioned (eigenvalues within ~1 of 2), with rows 5 and 6
        # swapped to force a pivot: the bound tests the rules, not the
        # matrix (a zeroed diagonal leaves some of 4096 systems nearly
        # singular)
        A = rng.standard_normal((b, n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
        A[:, [5, 6]] = A[:, [6, 5]]
        At, dAt = (torch.as_tensor(a, device="cuda")
                   for a in (A, rng.standard_normal((b, n, n))))
        Bt, dBt, gXt = (torch.as_tensor(rng.standard_normal((b, n, k)),
                                        device="cuda") for _ in range(3))
        X = gj_solve(At, Bt)
        runs = {
            "jvp": (lambda: jvp(gj_solve, (At, Bt), (dAt, dBt))[1],
                    lambda: jvp(gj_solve_plain, (At, Bt), (dAt, dBt))[1],
                    lambda: jvp(torch.linalg.solve, (At, Bt), (dAt, dBt))[1],
                    lambda: launch_tangent(At, X, dAt, dBt),
                    lambda: gj_tangent_plain(At, X, dAt, dBt)),
            "vjp": (lambda: vjp(gj_solve, At, Bt)[1](gXt),
                    lambda: vjp(gj_solve_plain, At, Bt)[1](gXt),
                    lambda: vjp(torch.linalg.solve, At, Bt)[1](gXt),
                    lambda: launch_adjoint(At, X, gXt),
                    lambda: gj_adjoint_plain(At, X, gXt))}
        name = f"n={n} k={k} b={b}"
        bound = roofline(8 * b * (2 * n * n + 4 * n * k),
                         b * (solve_flops(n, k) + 4 * n * n * k), 8)
        reps = 20 if b > 1 else 100
        solve_ms = cuda_time_ms(lambda: gj_solve(At, Bt), reps)
        solve_dev_ms = graph_time_ms(lambda: gj_solve(At, Bt), reps)
        for rule, (kern, plain, library, entry, twin) in runs.items():
            got, ref = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max(rel_err(a, c) for a, c in zip(got, ref))
            eg, et = entry(), twin()
            eg = eg if isinstance(eg, tuple) else (eg,)
            et = et if isinstance(et, tuple) else (et,)
            entry_err = max(rel_err(a, c) for a, c in zip(eg, et))
            entry_abs = max(float((a - c).abs().max())
                            for a, c in zip(eg, et))
            ms = cuda_time_ms(kern, reps)
            plain_ms = cuda_time_ms(plain, min(reps, PLAIN_REPS))
            library_ms = cuda_time_ms(library, reps)
            entry_ms = cuda_time_ms(entry, reps)
            entry_dev_ms = graph_time_ms(entry, reps)
            door_ms = ms - solve_ms - entry_ms
            print(f"K1 {rule} {name}: max relative error {err:.3e}, fused "
                  f"entry against its twin {entry_err:.3e}; kernel "
                  f"{ms * 1e3:.1f} us, twin {plain_ms * 1e3:.1f} us, "
                  f"torch.linalg.solve {library_ms * 1e3:.1f} us; "
                  f"{bound['bytes']} bytes, {bound['flops']} FLOP, bound "
                  f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}); "
                  f"split: device {(solve_dev_ms + entry_dev_ms) * 1e3:.1f} "
                  f"us (solve {solve_dev_ms * 1e3:.1f} + entry "
                  f"{entry_dev_ms * 1e3:.1f}), bare calls solve "
                  f"{solve_ms * 1e3:.1f} + entry {entry_ms * 1e3:.1f} us, "
                  f"door {door_ms * 1e3:.1f} us [{card}]", flush=True)
            if not (err <= DERIV_TOL and entry_err <= DERIV_TOL):
                raise RuntimeError(f"K1 {rule} {name}: {err:.3e}, entry "
                                   f"{entry_err:.3e} > {DERIV_TOL:.0e}")
            out[f"{rule} {name}"] = dict(
                max_rel_err=err, entry_rel_err=entry_err,
                entry_abs_err=entry_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, entry_ms=entry_ms,
                entry_device_ms=entry_dev_ms, solve_ms=solve_ms,
                solve_device_ms=solve_dev_ms, door_ms=door_ms, **bound)
    return out


def k1_dff_jacobian_cases(card, cc, sol, tab):
    """Phase 9c: K1's jvp and vjp rules on the Jacobians the rules meet on
    the path: G of every Monte Carlo lane at its own operating point (the
    transweep's t = 0 row), with dG the Jacobian's tangent along mno1.w.
    Each lane is held to JAC_DERIV_FACTOR * n * cond(G) * eps, the forward
    error bound of a pivoted elimination, so that the ill-conditioned
    systems stay under test."""
    import torch
    from torch.func import jvp, vjp
    from cadnip_tpu_torch.analyses.sweeps import batch_params
    from cadnip_tpu_torch.mna.assemble import make_assembler, pad_state
    from cadnip_tpu_torch.mna.spec import MODE_TRANOP
    from cadnip_tpu_torch.ops.gj_solve import (GJSolve, gj_solve,
                                               gj_solve_plain)

    assemble = make_assembler(cc)
    bp = batch_params(cc, tab)
    xp = pad_state(sol.xs[:, 0].contiguous())
    lim = assemble.init_lim(xp)
    dyn = cc.spec.dyn(cc.device, mode=MODE_TRANOP, time=0.0)
    w = torch.as_tensor(tab["mno1.w"], dtype=torch.float64, device=cc.device)
    A, dA = jvp(lambda v: assemble(xp, lim, cc.alter(bp, **{"mno1.w": v}),
                                   dyn)[2], (w,), (torch.ones_like(w),))
    A, dA = A.contiguous(), dA.contiguous()
    b, n, _ = A.shape
    rng = np.random.default_rng(9)
    Bt, dBt, gXt = (torch.as_tensor(rng.standard_normal((b, n, 1)),
                                    device=cc.device) for _ in range(3))
    cond = np.linalg.cond(A.cpu().numpy())
    bound = JAC_DERIV_FACTOR * n * cond * np.finfo(np.float64).eps
    torch.cuda.synchronize()
    gj_solve.rule_launches = 0
    got = {"jvp": (jvp(GJSolve.apply, (A, Bt), (dA, dBt))[1],),
           "vjp": vjp(GJSolve.apply, A, Bt)[1](gXt)}
    rule_launches = gj_solve.rule_launches
    ref = {"jvp": (jvp(gj_solve_plain, (A, Bt), (dA, dBt))[1],),
           "vjp": vjp(gj_solve_plain, A, Bt)[1](gXt)}
    out = {}
    for rule in ("jvp", "vjp"):
        err = np.zeros(b)
        for g, r in zip(got[rule], ref[rule]):
            lane_err = ((g - r).abs().amax((1, 2))
                        / r.abs().amax((1, 2)).clamp(min=1e-300))
            err = np.maximum(err, lane_err.cpu().numpy())
        worst = int(np.argmax(err / bound))
        print(f"K1 {rule} on {b} DFF Monte Carlo Jacobians (dG along "
              f"mno1.w): cond(G) {cond.min():.3e}-{cond.max():.3e}, max "
              f"relative error {err.max():.3e}, worst error / bound "
              f"{err[worst] / bound[worst]:.3e} (lane {worst}: error "
              f"{err[worst]:.3e}, cond {cond[worst]:.3e}) [{card}]",
              flush=True)
        if not (err <= bound).all():
            raise RuntimeError(f"K1 {rule} on DFF Jacobians: lane {worst} "
                               f"error {err[worst]:.3e} > {bound[worst]:.3e}")
        out[rule] = float(err.max())
    print(f"K1 fused rule entries launched {rule_launches} times (one per "
          f"rule) [{card}]", flush=True)
    if rule_launches != 2:
        raise RuntimeError(f"K1 rules on DFF Jacobians: {rule_launches} "
                           f"fused entry launches, want 2")
    out["rule_launches"] = rule_launches
    return out


def run_dff(card):
    """Phase 4: the DFF transient on the card through tran(), through K1."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    g = np.load(os.path.join(GOLDENS, "dff.npz"))
    out = {}
    for label in ("cold",):
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
        counts = (int(st.naccept), int(st.nreject), nnewton)
        if counts != DFF_TRAN_COUNTS or op_iters != DFF_DC_ITERS:
            raise RuntimeError(f"DFF {label}: counts {counts} and DC "
                               f"{op_iters}, want {DFF_TRAN_COUNTS} and "
                               f"{DFF_DC_ITERS}")
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
        out[label] = dict(launches=launches, wall=wall,
                          ms=wall / (nnewton + op_iters) * 1e3)
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
    # the linear models: node voltages and branch currents at random
    for name, model, key, lo, hi in (
            ("inductor", dv.INDUCTOR, "l", 1e-9, 1e-3),
            ("mutual", dv.MUTUAL, "m", -1e-6, 1e-6),
            ("vcvs", dv.VCVS, "gain", -10.0, 10.0),
            ("vccs", dv.VCCS, "gm", -1e-2, 1e-2),
            ("cccs", dv.CCCS, "gain", -10.0, 10.0),
            ("ccvs", dv.CCVS, "r", -1e3, 1e3)):
        p = base(model)
        p[key] = rng.uniform(lo, hi, I)
        u = rng.uniform(-5, 5, (I, model.n_local))
        out[name] = (model, u, u, p, None)
    # npn and pnp, a finite Early voltage on half (its qb clamp at 0.1
    # included), junction voltages past the exponential's clamps at +-80
    # thermal voltages and on both sides of the charge's fc knee
    p = base(dv.BJT)
    ty = np.where(rng.random(I) < 0.5, 1.0, -1.0)
    early = rng.random(I) < 0.5
    p.update(type=ty, bf=rng.uniform(50, 200, I), br=rng.uniform(0.5, 5, I),
             nf=rng.uniform(1.0, 1.2, I), nr=rng.uniform(1.0, 1.2, I),
             vaf=np.where(early, rng.uniform(2, 100, I), 1e12),
             var=np.where(early, rng.uniform(2, 50, I), 1e12),
             cje=rng.uniform(1e-12, 1e-11, I),
             cjc=rng.uniform(1e-12, 5e-12, I),
             vje=rng.uniform(0.6, 0.9, I), vjc=rng.uniform(0.6, 0.9, I),
             mje=rng.uniform(0.3, 0.5, I), mjc=rng.uniform(0.3, 0.5, I),
             tf=rng.uniform(1e-10, 1e-9, I), tr=rng.uniform(1e-9, 1e-8, I),
             area=rng.uniform(0.5, 2.0, I),
             **{"is": rng.uniform(1e-16, 1e-14, I)})
    u = rng.uniform(-3.0, 3.0, (I, 3))
    out["bjt"] = (dv.BJT, u, far(u, 1.0), p, None)
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


def k2_bound(S, nnewton):
    """The least time of one K2 transient: its inputs read once and its
    save grid written once, or the operations of one LU solve per Newton
    iteration this run took (the device functions and the step control
    not counted), whichever is larger."""
    from cadnip_tpu_torch.ops import vmem_tran as vt

    _, t = vt._kernel_args(S)
    ins = ("gdesc", "conn", "par", "wkind", "wcoef", "bp", "x0", "q0",
           "qdot0", "atol", "diff", "vmask", "fq_ptr", "fq_idx", "jc_ptr",
           "jc_idx")
    n = S.cc.n
    bytes_ = sum(t[k].numel() * t[k].element_size() for k in ins) \
        + 8 * (S.n_save * n + 3 * n)
    return roofline(bytes_, nnewton * solve_flops(n, 1), 8)


def span_bound(cc, tspan, dt, sol):
    """k2_bound of a vmem_tran() run, its set-up rebuilt from the run's
    operating point (the first save row: no second DC solve)."""
    from cadnip_tpu_torch.ops import vmem_tran as vt
    return k2_bound(vt.prepare(cc, tspan, dt=dt, x0=sol.xs[0]),
                    int(sol.stats.nnewton))


def phase_shares(cyc, nnewton):
    """K2's clock64 cycles per phase of a Newton iteration, as shares."""
    total = sum(cyc.values())
    per_it = total / max(int(nnewton), 1)
    return (f"{per_it:.0f} cycles per Newton iteration: " + ", ".join(
        f"{k} {v / total * 100:.1f} %" for k, v in cyc.items()))


def rc_ladder(sections):
    """A netlist of an RC ladder driven by a pulse: n = sections + 2."""
    lines = [f"rc ladder of {sections} sections",
             "vs n0 0 dc 0 pulse 0 1 1u 0.1u 0.1u 5u 12u"]
    for i in range(sections):
        lines += [f"r{i} n{i} n{i + 1} 100", f"c{i} n{i + 1} 0 1n"]
    return "\n".join(lines + [".end", ""])


def k2_layout(vt, S):
    """Which side of K2's two size selections a set-up takes: the Newton
    solve in one warp (n <= WARP_SOLVE_MAX) or the block, and the
    per-instance locals in shared or device memory."""
    n = S.cc.n
    in_smem = vt.smem_bytes(n) + vt.locals_bytes(n, vt.pack(S)) <= vt.SMEM_MAX
    return ("warp" if n <= vt.WARP_SOLVE_MAX else "block",
            "shared" if in_smem else "device")


def host_setup(S):
    """A K2 set-up's fields without its circuit and parameters, as numpy:
    what the CPU worker needs to run the twin from the card's operating
    point."""
    import dataclasses
    return {f.name: (getattr(S, f.name).cpu().numpy()
                     if hasattr(getattr(S, f.name), "cpu")
                     else getattr(S, f.name))
            for f in dataclasses.fields(S)
            if f.name not in ("cc", "params", "va")}


def cpu_k2_twin(net, setup):
    """Phase 6's twin on the host CPU (in a worker): K2's plain twin on a
    CPU circuit of `net`, from the card's set-up `setup` (host_setup)."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops import vmem_tran as vt

    cc = ct.parse_spice(net, device="cpu")
    S = vt.Setup(cc=cc, params=cc.params0(), **{
        k: torch.as_tensor(v) if isinstance(v, np.ndarray) and k != "bp"
        else v for k, v in setup.items()})
    t = time.perf_counter()
    r = vt.integrate_plain(S)
    return dict(xs=r.xs.numpy(), stats=tuple(int(v) for v in r.stats),
                ms=(time.perf_counter() - t) * 1e3, where="on the host CPU")


def k2_vs_twin(card):
    """Phase 6: one K2 launch per case on the card. The ladder is the
    largest circuit K2 takes (n = 127): it runs the block solve with its
    locals in device memory, the other cases the warp solve with them in
    shared memory. The darlington (BJTs) and the L/K/E/G/F/H deck run the
    BJT and linear-model device functions. Each case's twin runs on the
    host CPU in a worker, from the card's own set-up (host_setup), except
    those of TWIN_ON_CARD, which run here; twin_check holds the two against
    each other in the summary phase."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.vacask import DARLINGTON, GRAETZ, RC_NETLIST
    from cadnip_tpu_torch.ops import vmem_tran as vt

    cases = [("rc", RC_NETLIST, (0, 4e-3), 8e-6, ("2", None), 1.0,
              ("warp", "shared")),
             ("dff", ct.dff_netlist(), (0, 6e-8), 3.333e-10, ("q", None),
              5.0, ("warp", "shared")),
             ("graetz", GRAETZ, (0, 2e-2), 1e-4, ("outp", "outn"), 20.0,
              ("warp", "shared")),
             ("ladder", rc_ladder(125), (0, 5e-6), 2e-7, ("n125", None), 1.0,
              ("block", "device")),
             # the ON half-period of the darlington and its falling edge
             ("darlington", DARLINGTON, (0, 1e-6), 2e-9, ("coll", None), 5.0,
              ("warp", "shared")),
             # the pulse's rise (10-15 ns) and fall (215-220 ns)
             ("lkefgh", LKEFGH, (0, 2.5e-7), 2e-9, ("b", None), 2.0,
              ("warp", "shared"))]
    out = {}
    for name, net, span, dt, (na, nb), scale, layout in cases:
        cc = ct.parse_spice(net, device="cuda")
        S = vt.prepare(cc, span, dt=dt)
        if k2_layout(vt, S) != layout:
            raise RuntimeError(f"K2 vs twin {name} (n = {cc.n}): takes "
                               f"{k2_layout(vt, S)}, want {layout}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rk = vt.integrate(S)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        stats = tuple(int(v) for v in rk.stats)
        bound = k2_bound(S, stats[2])
        print(f"K2 {name} {span[1]:g} s (n = {cc.n}, {layout[0]} solve, "
              f"locals in {layout[1]} memory): kernel {ms:.3f} ms, accepted,"
              f" rejected, newton {stats[:3]}; bound "
              f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}) "
              f"[{card}]", flush=True)
        print(f"   K2 phases: {phase_shares(rk.phases, stats[2])}",
              flush=True)
        solve_cyc = rk.phases["equilibration + solve"] / max(stats[2], 1)
        if layout[0] == "block":
            print(f"   K2 block solve (K1's blocked form): {solve_cyc:.0f} "
                  f"cycles per Newton iteration, {solve_cyc / cc.n:.0f} per "
                  f"pivot (n = {cc.n})", flush=True)
        if stats[3]:
            raise RuntimeError(f"K2 {name}: the integrator failed")
        out[name] = dict(ms=ms, net=net, setup=host_setup(S),
                         xs=rk.xs.cpu().numpy(), stats=stats, scale=scale,
                         cols=[cc.index_of(k) for k in (na, nb) if k],
                         cycles_per_iteration=sum(rk.phases.values())
                         / max(stats[2], 1),
                         solve_cycles_per_pivot=solve_cyc / cc.n, **bound)
        if name in TWIN_ON_CARD:
            t = time.perf_counter()
            rp = vt.integrate_plain(S)
            torch.cuda.synchronize()
            out[name]["twin"] = dict(
                xs=rp.xs.cpu().numpy(), where="on the card",
                stats=tuple(int(v) for v in rp.stats),
                ms=(time.perf_counter() - t) * 1e3)
    return out


def twin_check(card, cases, jobs):
    """The summary phase's half of phase 6: each K2 run against its twin
    (`jobs`: the worker's cpu_k2_twin by case; TWIN_ON_CARD's twins ran in
    phase 6). The bar holds
    while both take the same steps. Last-bit differences (dual-number
    against reverse-mode derivatives, summation order, FMA, the card's
    against the host's libm), amplified by an ill-conditioned system
    (graetz: c0*C near 10 S beside 1e-12 S), can flip one step decision;
    from there the two are two step sequences of one integrator, held to
    its reltol. Counts within 2 %, and at least one count apart (2 % of
    the 5 rejects of rc is a tenth of a step)."""
    for name, case in cases.items():
        t = time.perf_counter()
        rp = case["twin"] if name in TWIN_ON_CARD else jobs[name].result()
        waited = time.perf_counter() - t

        def wave(xs):
            v = xs[:, case["cols"][0]]
            return v if len(case["cols"]) == 1 else v - xs[:, case["cols"][1]]

        rk_stats, rp_stats = case["stats"][:3], rp["stats"][:3]
        rmse = float(np.sqrt(np.mean((wave(case["xs"]) - wave(rp["xs"]))
                                     ** 2))) / case["scale"]
        err = float(np.abs(case["xs"] - rp["xs"]).max())
        counts_ok = all(abs(a - b) <= max(1.0, TWIN_COUNT_TOL * b)
                        for a, b in zip(rk_stats, rp_stats))
        print(f"K2 vs twin {name}: kernel {case['ms']:.3f} ms, twin "
              f"{rp['where']} {rp['ms']:.1f} ms (read after a wait of "
              f"{waited:.3f} s); kernel / twin accepted, rejected, newton "
              f"{rk_stats} / {rp_stats}; waveform RMSE/scale {rmse:.2e}, max "
              f"|dx| {err:.2e} [{card}]", flush=True)
        if rp["stats"][3]:
            raise RuntimeError(f"K2 vs twin {name}: the twin failed")
        tol = TWIN_RMSE_TOL if rk_stats == rp_stats else TWIN_FLIP_TOL
        if not rmse <= tol:
            raise RuntimeError(f"K2 vs twin {name}: RMSE {rmse:.3e} > "
                               f"{tol:.0e}")
        if not counts_ok:
            raise RuntimeError(f"K2 vs twin {name}: counts {rk_stats} vs "
                               f"{rp_stats} differ by more than 2 %")
        case.update(plain_ms=rp["ms"], max_abs_err=err)


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
        counts = (int(st.naccept), int(st.nreject), nnewton)
        if rc == 2048 and counts != DFF_K2_COUNTS:
            raise RuntimeError(f"DFF K2 {label}: counts {counts}, want "
                               f"{DFF_K2_COUNTS}")
        if k2 != 1 or k1 < op_iters or op_iters == 0:
            raise RuntimeError(f"DFF K2 {label}: {k2} K2 launches (want 1), "
                               f"{k1} K1 launches for {op_iters} DC Newton "
                               f"iterations")
        tm = sol.timings
        bound = span_bound(cc, (0, 6e-7), 3.333e-10, sol)
        print(f"DFF vmem_tran() {label} (rows_per_chunk {rc}): wall "
              f"{wall:.3f} s (operating point {tm['prepare']:.3f} s, K2 "
              f"{tm['integrate']:.3f} s), accepted {int(st.naccept)}, "
              f"rejected {int(st.nreject)}, newton {nnewton} + DC "
              f"{op_iters}, {nnewton / tm['integrate']:.0f} transient Newton"
              f" it/s, {(nnewton + op_iters) / wall:.1f} Newton it/s overall,"
              f" K2 launches {k2}, K1 launches {k1}, q rel RMSE {rmse:.3e}; "
              f"bound {bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}:"
              f" {bound['bytes']} bytes, {bound['flops']} FLOP) [{card}]",
              flush=True)
        print(f"   K2 phases: {phase_shares(sol.phase_cycles, nnewton)}",
              flush=True)
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
    bound = span_bound(cc, (0, 1.0), 1e-6, sol)
    print(f"graetz vmem_tran() 0-1 s at 1 us ({v.shape[0]} rows): wall "
          f"{wall:.3f} s (operating point {tm['prepare']:.3f} s, K2 "
          f"{tm['integrate']:.3f} s), accepted {int(st.naccept)}, rejected "
          f"{int(st.nreject)}, newton {int(st.nnewton)}, K2 launches "
          f"{ct.vmem_tran.launches}, v(outp,outn) after 0.06 s in "
          f"[{v[late].min():.4f}, {v[late].max():.4f}] V, golden rel RMSE "
          f"{rmse:.3e}; bound {bound['bound_ms'] * 1e3:.2f} us "
          f"({bound['bound_by']}: {bound['bytes']} bytes, {bound['flops']} "
          f"FLOP) [{card}]", flush=True)
    print(f"   K2 phases: {phase_shares(sol.phase_cycles, st.nnewton)}",
          flush=True)
    if not bool(sol.converged) or not np.isfinite(v).all():
        raise RuntimeError("graetz K2: transient failed")
    if not (ripple_ok and rmse <= GRAETZ_TOL):
        raise RuntimeError(f"graetz K2: ripple in range {ripple_ok}, golden"
                           f" RMSE {rmse:.3e} (gate {GRAETZ_TOL:.0e})")
    if ct.vmem_tran.launches != 1:
        raise RuntimeError(f"graetz K2: {ct.vmem_tran.launches} launches")
    # v(outp, outn) at the golden's instants, for phase 13
    gts = np.load(os.path.join(GOLDENS, "graetz.npz"))["ts"]
    return np.interp(gts, np.asarray(sol.ts), v)


def k2_darlington(card):
    """Phase 8b: the full VACASK darlington span (bench.py's `tran 2n 1m`,
    500,001 save rows) through vmem_tran() in one K2 launch, within
    bench.py's physics gate, and its first DARL_REF_SPAN (one period of
    the pulse: the ON half and the falling edge at 1 us) against tran()
    on the card at the edge-masked bar."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.vacask import DARLINGTON

    cc = ct.parse_spice(DARLINGTON, device="cuda")
    torch.cuda.synchronize()
    ct.vmem_tran.launches = 0
    t = time.perf_counter()
    sol = ct.vmem_tran(cc, (0, 1e-3), dt=2e-9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ct.vmem_tran.launches
    st = sol.stats
    nn = int(st.nnewton)
    ts = np.asarray(sol.ts)
    vc = sol["coll"].cpu().numpy()
    late = ts > 0.9e-3
    physics = bool(vc[late].min() < 1.0 and vc[late].max() > 4.5)
    tm = sol.timings
    k2_ms = tm["integrate"] * 1e3
    bound = span_bound(cc, (0, 1e-3), 2e-9, sol)
    cyc = sum(sol.phase_cycles.values()) / max(nn, 1)
    print(f"darlington vmem_tran() 0-1 ms at 2 ns ({vc.shape[0]} rows, n = "
          f"{cc.n}): wall {wall:.3f} s (operating point "
          f"{tm['prepare']:.3f} s, K2 {k2_ms:.1f} ms), accepted "
          f"{int(st.naccept)}, rejected {int(st.nreject)}, newton {nn}, "
          f"{k2_ms * 1e3 / max(nn, 1):.2f} us and {cyc:.0f} cycles per Newton"
          f" iteration, K2 launches {launches}; v(coll) after 0.9 ms in "
          f"[{vc[late].min():.4f}, {vc[late].max():.4f}] V; bound "
          f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}: "
          f"{bound['bytes']} bytes, {bound['flops']} FLOP) [{card}]",
          flush=True)
    print(f"   K2 phases: {phase_shares(sol.phase_cycles, nn)}", flush=True)
    if not (bool(sol.converged) and np.isfinite(vc).all()
            and vc.shape == (500001,)):
        raise RuntimeError("darlington K2: transient failed")
    if not physics:
        raise RuntimeError(f"darlington K2: v(coll) after 0.9 ms in "
                           f"[{vc[late].min()}, {vc[late].max()}], want min"
                           f" < 1.0 V and max > 4.5 V")
    if launches != 1:
        raise RuntimeError(f"darlington K2: {launches} launches (want 1)")
    return dict(launches=launches, ms=k2_ms, wall=wall, nnewton=nn, ts=ts,
                coll=vc, **bound)


def cpu_darlington_ref():
    """Phase 8b's reference on the host CPU (in a worker): tran() of the
    darlington over DARL_REF_SPAN, its collector waveform."""
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.vacask import DARLINGTON

    cc = ct.parse_spice(DARLINGTON, device="cpu")
    t = time.perf_counter()
    ref = ct.tran(cc, (0, DARL_REF_SPAN), dt=2e-9)
    return dict(coll=ref["coll"].numpy(), converged=bool(ref.converged),
                nnewton=int(ref.stats.nnewton), wall=time.perf_counter() - t)


def darlington_ref_check(card, dar, job):
    """The summary phase's half of phase 8b: K2's first DARL_REF_SPAN (one
    period of the pulse: the ON half and the falling edge at 1 us) against
    tran() on the host CPU (`job`, the worker's cpu_darlington_ref()) at
    the edge-masked bar."""
    t = time.perf_counter()
    ref = job.result()
    waited = time.perf_counter() - t
    rows = ref["coll"].shape[0]
    q99, mx = edge_masked(dar["ts"][:rows], dar["coll"][:rows], ref["coll"])
    print(f"darlington K2 against tran() 0-{DARL_REF_SPAN * 1e6:g} us on the "
          f"host CPU ({ref['wall']:.1f} s in the worker, newton "
          f"{ref['nnewton']}; read after a wait of {waited:.3f} s) away from "
          f"the edges: 99th percentile {q99:.3e} V, max {mx:.3e} V [{card}]",
          flush=True)
    if not ref["converged"]:
        raise RuntimeError("darlington tran() reference failed")
    if not (q99 < EDGE_Q99_TOL and mx < EDGE_MAX_TOL):
        raise RuntimeError(f"darlington K2 against tran(): {q99:.3e} / "
                           f"{mx:.3e} V over {EDGE_Q99_TOL} / {EDGE_MAX_TOL}")


def ac_noise(card):
    """Phase 8c: AC and noise sweeps of 801 frequencies on the card, each
    one K1 launch, against the same calls on a CPU circuit: the DFF's
    supply rejection (acmag = 1 on vvdd, output q), its output noise at q
    referred to vvdd, and the AC of a darlington biased ON (vs at DC 3 V,
    acmag = 1, output coll). Beside each sweep's wall, the time of its K1
    launch alone on the same system (CUDA events)."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.analyses.ac import linearize
    from cadnip_tpu_torch.mna.assemble import make_ac_rhs, make_assembler
    from cadnip_tpu_torch.mna.spec import MODE_AC
    from cadnip_tpu_torch.models.vacask import DARLINGTON
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    freqs = ct.acdec(*AC_FREQS)
    runs = [("DFF PSRR (ac, q / vvdd)", ct.dff_netlist(),
             {"vvdd.acmag": 1.0}, "ac", "q"),
            ("DFF output noise (noise, q, input vvdd)", ct.dff_netlist(), {},
             "noise", "q"),
            ("darlington ON (ac, coll / vs at 3 V)", DARLINGTON,
             {"vs.dc": 3.0, "vs.acmag": 1.0}, "ac", "coll")]
    out, circuits = {}, {}
    for label, net, alter, kind, node in runs:
        res = {}
        for dev in ("cuda", "cpu"):
            # the DFF's PSRR and noise share a circuit and its operating
            # point: acmag does not move the DC solution
            at_dc = {k: v for k, v in alter.items()
                     if not k.endswith(".acmag")}
            key = (net, dev, tuple(sorted(at_dc.items())))
            if key not in circuits:
                cc = ct.parse_spice(net, device=dev)
                circuits[key] = (cc, ct.dc(cc, cc.alter(cc.params0(),
                                                        **at_dc)))
            cc, op = circuits[key]
            p = cc.alter(cc.params0(), **alter)
            if dev == "cuda":
                torch.cuda.synchronize()
            gj_solve.launches = 0
            t = time.perf_counter()
            if kind == "ac":
                y = (ct.ac(cc, freqs, p, op_x=op.x)[node],)
            else:
                r = ct.noise(cc, node, freqs, p, input="vvdd", op_x=op.x)
                y = (r.onoise_psd, r.inoise_psd)
            wall = time.perf_counter() - t
            res[dev] = (y, wall, gj_solve.launches, bool(op.converged))
            if dev == "cuda":
                # the sweep's K1 launch alone: its [801, 2n, 2n] system
                G, C = linearize(cc, make_assembler(cc), op.x, p,
                                 cc.spec.dyn(cc.device, mode=MODE_AC))
                if kind == "noise":
                    G, C = G.T, C.T
                w = torch.as_tensor(2 * np.pi * freqs, dtype=torch.float64,
                                    device="cuda")[:, None, None]
                Gb, Cb = G.expand(len(freqs), -1, -1), w * C
                A = torch.cat([torch.cat([Gb, -Cb], -1),
                               torch.cat([Cb, Gb], -1)], -2).contiguous()
                b = torch.zeros(A.shape[:2], dtype=torch.float64,
                                device="cuda")
                b[:, :cc.n] = make_ac_rhs(cc)(p)[0]
                k1_ms = cuda_time_ms(lambda: gj_solve(A, b), 5)
        (yg, wall, launches, conv), (yc, cpu_wall, _, cconv) = \
            res["cuda"], res["cpu"]
        if kind == "ac":
            err = float(np.abs(yg[0] - yc[0]).max() / np.abs(yc[0]).max())
            what = (f"|H| {np.abs(yg[0]).min():.4e}-"
                    f"{np.abs(yg[0]).max():.4e}")
        else:
            err = max(float((np.abs(a - c) / np.abs(c)).max())
                      for a, c in zip(yg, yc))
            what = (f"output PSD {yg[0].min():.4e}-{yg[0].max():.4e} V^2/Hz,"
                    f" input-referred {yg[1].min():.4e}-{yg[1].max():.4e}")
        print(f"{label}, {len(freqs)} frequencies {freqs[0]:g}-"
              f"{freqs[-1]:g} Hz: {what}; card against CPU {err:.3e}; K1 "
              f"launches {launches}; wall {wall * 1e3:.1f} ms (CPU "
              f"{cpu_wall * 1e3:.1f} ms), its K1 launch alone "
              f"{k1_ms * 1e3:.1f} us [{card}]", flush=True)
        if not (conv and cconv):
            raise RuntimeError(f"{label}: operating point did not converge")
        if launches != 1:
            raise RuntimeError(f"{label}: {launches} K1 launches (want 1)")
        if not err <= AC_TOL or not all(np.isfinite(v).all() for v in yg):
            raise RuntimeError(f"{label}: card against CPU {err:.3e} > "
                               f"{AC_TOL:.0e}")
        out[label] = dict(wall=wall, k1_ms=k1_ms, err=err, y=yg)
    out["ladder"] = ladder_ac(card)
    return out


#: phase 8c's 125-section RC ladder (n = 127; K2's largest circuit): its
#: input source and output node for the AC sweep
LADDER_SECTIONS, LADDER_OUT = 125, "n125"


def ladder_ac(card, device="cuda"):
    """The 125-section ladder's AC sweep (acmag 1 on vs, output n125) over
    801 frequencies: one K1 launch of [801, 254, 255], the grid variant on
    the card. On "cpu" (in a worker) the CPU port's same call, held against
    the card's in phase 14 (ladder_ac_check). On the card the K1 launch's
    operands and result are kept (`k1`: A, b, X) for phase 14's witness."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops import linalg
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    cc = ct.parse_spice(rc_ladder(LADDER_SECTIONS), device=device)
    op = ct.dc(cc)
    p = cc.alter(cc.params0(), **{"vs.acmag": 1.0})
    if device == "cuda":
        torch.cuda.synchronize()
    seen = []

    def kept(A, b):
        X = gj_solve(A, b)
        seen.append((A, b, X))
        return X

    gj_solve.launches = 0
    linalg.gj_solve = kept if device == "cuda" else gj_solve
    try:
        t = time.perf_counter()
        y = ct.ac(cc, ct.acdec(*AC_FREQS), p, op_x=op.x)[LADDER_OUT]
        y = np.asarray(y)
        wall = time.perf_counter() - t
    finally:
        linalg.gj_solve = gj_solve
    res = dict(y=y, wall=wall, launches=gj_solve.launches, n=cc.n,
               out=cc.index_of(LADDER_OUT), converged=bool(op.converged),
               k1=seen[0] if len(seen) == 1 else None)
    if device == "cuda":
        print(f"ladder AC (ac, {LADDER_OUT} / vs, n = {cc.n}), {len(y)} "
              f"frequencies: |H| {np.abs(y).min():.4e}-{np.abs(y).max():.4e};"
              f" K1 launches {res['launches']} (grid variant, [{len(y)}, "
              f"{2 * cc.n}, {2 * cc.n + 1}]); wall {wall * 1e3:.1f} ms; the "
              f"CPU port's run in a worker is compared in phase 14 [{card}]",
              flush=True)
        if not res["converged"] or res["launches"] != 1:
            raise RuntimeError(f"ladder AC: operating point converged "
                               f"{res['converged']}, {res['launches']} K1 "
                               f"launches (want 1)")
        if not np.isfinite(y).all():
            raise RuntimeError("ladder AC: non-finite response")
    return res


def cpu_ladder_ac():
    """Phase 8c's ladder AC on the host CPU (in a worker)."""
    return ladder_ac(None, device="cpu")


def ladder_ac_check(card, lad, job):
    """Phase 14's half of the ladder AC: the card's response against the
    CPU port's, within AC_TOL of max |H|. Then a witness of where the
    difference comes from, at the frequency where it is largest: the card's
    system there, solved on the CPU by K1's blocked twin (the grid
    variant's algorithm; on the same operands as the card's kernel, so the
    kernel against the twin is the solve's share) and by the unblocked twin
    (the spread of two summation orders), the blocked twin against the CPU
    port (the operands' share, with the batch's), and the system's
    condition number."""
    import torch
    from cadnip_tpu_torch.ops.gj_solve import (gj_solve_blocked_plain,
                                               gj_solve_plain)

    t = time.perf_counter()
    ref = job.result()
    waited = time.perf_counter() - t
    scale = np.abs(ref["y"]).max()
    per_f = np.abs(lad["y"] - ref["y"]) / scale
    err = float(per_f.max())
    print(f"ladder AC on the card against the CPU port ({ref['wall']:.1f} s "
          f"in the worker, read after a wait of {waited:.3f} s): "
          f"{err:.3e} of max |H| (bar {AC_TOL:.0e}) [{card}]", flush=True)
    if not (ref["converged"] and err <= AC_TOL):
        raise RuntimeError(f"ladder AC: card against CPU {err:.3e} > "
                           f"{AC_TOL:.0e}")
    f = int(per_f.argmax())
    A, b, X = (v[f].cpu()[None] for v in lad["k1"])
    b = b if b.ndim == 3 else b[..., None]
    n, i = lad["n"], lad["out"]

    def h(x):
        return complex(float(x[0, i, 0]), float(x[0, n + i, 0]))

    hk, hb = h(X if X.ndim == 3 else X[..., None]), \
        h(gj_solve_blocked_plain(A, b))
    hu = h(gj_solve_plain(A, b))
    cond = float(np.linalg.cond(A[0].numpy()))
    wit = dict(freq_index=f, freqs_above_1e_12=int((per_f > 1e-12).sum()),
               median=float(np.median(per_f)),
               kernel_vs_blocked_twin=abs(hk - hb) / scale,
               blocked_twin_vs_cpu_port=abs(hb - ref["y"][f]) / scale,
               blocked_vs_unblocked_twin=abs(hb - hu) / scale, cond=cond)
    print(f"ladder AC witness at frequency {f} of {len(per_f)} (the largest "
          f"difference; {wit['freqs_above_1e_12']} above 1e-12, median "
          f"{wit['median']:.3e}), of max |H|: the card's kernel against the "
          f"blocked twin on its operands {wit['kernel_vs_blocked_twin']:.3e}, "
          f"that twin against the CPU port {wit['blocked_twin_vs_cpu_port']:.3e}"
          f", blocked against unblocked twin "
          f"{wit['blocked_vs_unblocked_twin']:.3e}; cond(A) {cond:.3e} "
          f"[{card}]", flush=True)
    lad["k1"] = None
    return err, wit


def dff_montecarlo(card, serial_wall, cpu):
    """Phase 9: bench.py's 4096-way DFF Monte Carlo through transweep(),
    on a fresh circuit; its check lanes are held against the host CPU,
    replayed by the CPU worker `cpu` while the card runs."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    # one run: a second ("warm") one repeated it bit for bit in every run
    # of PR 3, and the script's time goes to the other phases
    cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
    tab = ct.montecarlo_table(cc, MC_SPREADS, MC_LANES, seed=42)
    lanes_job = cpu.submit(cpu_mc_lanes,
                           {k: v[MC_CHECK] for k, v in tab.items()})
    torch.cuda.synchronize()
    gj_solve.launches = 0
    t = time.perf_counter()
    sol = ct.transweep(cc, tab, (0, 6e-7), **MC_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = gj_solve.launches
    st = sol.stats
    op_iters, nnewton = sol.op_iters.cpu(), st.nnewton.cpu()
    tran_passes = sol.host_syncs - 1   # the last pass only reads the mask
    op_passes = launches - tran_passes  # one K1 launch per Newton pass
    q = sol["q"].cpu().numpy()
    ts = np.asarray(sol.ts)
    latch = ((q[:, np.argmin(np.abs(ts - 350e-9))] < 1.0)
             & (q[:, np.argmin(np.abs(ts - 550e-9))] > 4.0))
    newton_sum = int(op_iters.sum()) + int(nnewton.sum())
    tm = sol.timings
    print(f"DFF Monte Carlo {MC_LANES} lanes, transweep() 0-600 ns: "
          f"wall {wall:.3f} s (operating point {tm['op']:.3f} s, "
          f"transient {tm['transient']:.3f} s), "
          f"{wall / MC_LANES * 1e3:.3f} ms per circuit (serial DFF "
          f"tran() {serial_wall:.3f} s); K1 launches {launches} "
          f"(operating point {op_passes}, transient {tran_passes}); "
          f"transient host syncs {sol.host_syncs}; Newton iterations "
          f"over lanes {newton_sum} (DC {int(op_iters.sum())}), "
          f"{newton_sum / wall:.0f} per s; per lane DC "
          f"{int(op_iters.min())}-{int(op_iters.max())}, transient "
          f"{int(nnewton.min())}-{int(nnewton.max())}, accepted "
          f"{int(st.naccept.min())}-{int(st.naccept.max())}, rejected "
          f"{int(st.nreject.min())}-{int(st.nreject.max())}; latched "
          f"{latch.mean():.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]",
          flush=True)
    if sol.xs.shape != (MC_LANES, MC_KW["n_save"], cc.n) or \
            not bool(torch.isfinite(sol.xs).all()):
        raise RuntimeError(f"DFF Monte Carlo: bad xs {tuple(sol.xs.shape)}")
    if not bool(sol.op_converged.all()) or bool(st.fail.any()):
        raise RuntimeError(
            f"DFF Monte Carlo: {int((~sol.op_converged).sum())} "
            f"operating points failed, {int(st.fail.sum())} transients "
            f"failed")
    if launches < int(op_iters.max()) + tran_passes:
        raise RuntimeError(f"DFF Monte Carlo: {launches} K1 launches < "
                           f"{int(op_iters.max())} DC + {tran_passes} "
                           f"transient passes")
    # the check lanes again on the host CPU, as one B = 4 transweep
    t = time.perf_counter()
    ref = lanes_job.result()
    waited = time.perf_counter() - t
    xs = sol.xs[MC_CHECK].cpu().numpy()
    for j, lane in enumerate(MC_CHECK):
        got = tuple(int(v[lane]) for v in st[:3])
        want = tuple(int(v[j]) for v in ref["stats"])
        dx = xs[j] - ref["xs"][j]
        err = float(np.abs(dx).max()) / 5.0
        line = (f"DFF Monte Carlo lane {lane}: card / CPU accepted, rejected,"
                f" newton {got} / {want}, max |dx| / 5 V {err:.3e}")
        if got == want:
            print(line, flush=True)
            if not err <= MC_TOL:
                raise RuntimeError(f"{line} > {MC_TOL:.0e}")
            continue
        # a flipped step decision: report where the two part, then hold the
        # lane to the integrator's reltol (as phase 6 holds graetz)
        apart = np.abs(dx).max(-1) > MC_TOL * 5.0
        rmse = float(np.sqrt(np.mean(dx ** 2))) / 5.0
        print(f"{line}; counts differ, waveforms first part at "
              f"{ts[int(np.argmax(apart))]:.4e} s, RMSE / 5 V "
              f"{rmse:.3e}", flush=True)
        if not rmse <= TWIN_FLIP_TOL:
            raise RuntimeError(f"{line}: RMSE {rmse:.3e} > "
                               f"{TWIN_FLIP_TOL:.0e}")
    print(f"DFF Monte Carlo check lanes {MC_CHECK} on the host CPU (CPU "
          f"worker, beside the card): {ref['wall']:.3f} s, of which the "
          f"card's side waited {waited:.3f} s", flush=True)
    return dict(wall=wall, launches=launches, tab=tab, sol=sol, cc=cc)


def profile_montecarlo(card, tab, full):
    """Phase 9b: the 4096-lane operating point again, which must repeat
    phase 9's (the t = 0 row) bit for bit; then torch.profiler over the
    first 10 ns of the transient from it (the full run's maximum step,
    12 ns, kept), whose 10 ns row must agree with phase 9's within MC_TOL
    (the shorter span rounds the steps before it differently). The
    profiled window is the transient's first 10 ns only: the profiler's
    stop and `key_averages` cost about 1 ms of host time per kernel
    launch recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.analyses.sweeps import batch_params
    from cadnip_tpu_torch.mna.spec import MODE_TRANOP

    cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
    params = batch_params(cc, tab)
    torch.cuda.synchronize()
    t = time.perf_counter()
    op = ct.dc(cc, params, mode=MODE_TRANOP, time=0.0, rescue=False)
    torch.cuda.synchronize()
    op_wall = time.perf_counter() - t
    op_equal = torch.equal(op.x, full.xs[:, 0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sol = ct.transweep(cc, tab, (0, 1e-8), dt=3.333e-10, n_save=2,
                           dtmax=6e-7 / 50, x0=op.x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    t = time.perf_counter()
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n_launch = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    print(f"DFF Monte Carlo {MC_LANES} lanes: operating point again "
          f"{op_wall:.3f} s; profiled transient 0-10 ns from it: wall "
          f"{wall:.3f} s (host syncs {sol.host_syncs}), device busy "
          f"{busy:.3f} s = {busy / wall * 100:.1f} %, cudaLaunchKernel "
          f"{n_launch}; profiler processing "
          f"{time.perf_counter() - t:.1f} s after the stop [{card}]",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"   {e.key[:60]:60s} count {e.count:7d} device "
              f"{e.self_device_time_total / 1e3:10.3f} ms", flush=True)
    err = float((sol.xs[:, 1] - full.xs[:, 1]).abs().max()) / 5.0
    print(f"against phase 9's run: operating points of {MC_LANES} lanes bit"
          f" for bit {op_equal}; row at 10 ns max |dx| / 5 V {err:.3e}",
          flush=True)
    if not (op_equal and err <= MC_TOL):
        raise RuntimeError(f"DFF Monte Carlo repeat: operating points equal "
                           f"{op_equal}, row at 10 ns {err:.3e} > "
                           f"{MC_TOL:.0e}")


def dc_sweep_rescue(card):
    """Phase 10: dcsweep()'s neighbour-seeded rescue on the card."""
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.analyses.sweeps import batch_params

    spec = ct.SimSpec(max_newton_iters=5, gmin_steps=2, src_steps=2)
    vals = np.linspace(0.0, 100.0, 21)
    res = {}
    for dev in ("cuda", "cpu"):
        cc = ct.parse_spice(DIODE_CHAIN, spec=spec, device=dev)
        t = time.perf_counter()
        cold = ct.dc(cc, batch_params(cc, {"vs.dc": vals}), rescue=False)
        sol = ct.dcsweep(cc, {"vs.dc": vals})
        res[dev] = (cold.converged.cpu(), sol.converged.cpu(), sol.x.cpu(),
                    time.perf_counter() - t)
    cold, conv, x, wall = res["cuda"]
    err = float(((x - res["cpu"][2]).abs()
                 / res["cpu"][2].abs().clamp(min=1e-12)).max())
    print(f"dcsweep() 5-diode chain, 21 lanes to 100 V: cold chain "
          f"converged {int(cold.sum())}/21, after the neighbour rescue "
          f"{int(conv.sum())}/21; max relative |card - CPU| {err:.3e}; "
          f"{wall:.3f} s [{card}]", flush=True)
    if not (cold.any() and not cold.all() and conv.all()):
        raise RuntimeError("dcsweep rescue: the cold solve must fail some "
                           "lanes and the rescue converge all")
    if not bool((cold == res["cpu"][0]).all()) or not err <= CPU_TOL:
        raise RuntimeError(f"dcsweep rescue: card differs from CPU ({err})")


#: phase 11: the DFF parameters of dc_sensitivity(). A capacitor does not
#: move the operating point: cq.c's column is exactly zero, and the other
#: two carry the comparison
SENS_NAMES = ["mno1.w", "cq.c", "vvdd.dc"]


def dff_sensitivity(dev):
    """dc_sensitivity() of the DFF operating point w.r.t. SENS_NAMES on
    `dev`, as numpy arrays, and K1's launches in it."""
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    cc = ct.parse_spice(ct.dff_netlist(), device=dev)
    sol = ct.dc(cc)
    gj_solve.launches = 0
    sens = ct.dc_sensitivity(cc, SENS_NAMES, sol=sol)
    return ({k: v.cpu().numpy() for k, v in sens.items()},
            gj_solve.launches)


def count_rule_calls():
    """Wrap GJSolve's rules and its apply with counters: (counts, undo)."""
    from cadnip_tpu_torch.ops.gj_solve import GJSolve

    counts = {"jvp": 0, "backward": 0, "vmap": 0, "apply": 0}
    saved = {name: GJSolve.__dict__[name] for name in counts}

    def counted(name, fn):
        def run(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return run

    for name in ("jvp", "backward", "vmap"):
        setattr(GJSolve, name, staticmethod(counted(name,
                                                    getattr(GJSolve, name))))
    apply = GJSolve.apply.__func__
    GJSolve.apply = classmethod(counted("apply", apply))

    def undo():
        for name, v in saved.items():
            setattr(GJSolve, name, v)
    return counts, undo


def rc_jacfwd(dev):
    """torch.func.jacfwd through tran() of an RC on `dev`: dv(out, 1 ms)/dR,
    K1's launches in it, its wall and its rule calls and crossings of
    GJSolve.apply."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    cir = ct.Circuit("sens")
    cir.V("vs", "in", "0", wave=ct.Pulse(0.0, 1.0, tr=1e-9))
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-6)
    cc = cir.compile(device=dev)

    def vout(r):
        p = cc.alter(cc.params0(), **{"r1.r": r})
        sol = ct.tran(cc, (0, 1e-3), params=p, dt=1e-5, n_save=11)
        return sol.xs[-1, cc.index_of("out")]

    calls, undo = count_rule_calls()
    gj_solve.launches = 0
    t = time.perf_counter()
    try:
        d = float(torch.func.jacfwd(vout)(
            torch.tensor(1e3, dtype=torch.float64, device=dev)))
    finally:
        undo()
    return d, gj_solve.launches, time.perf_counter() - t, calls


def cpu_derivatives():
    """Phase 11's CPU side, in the CPU worker."""
    return dff_sensitivity("cpu")[0], rc_jacfwd("cpu")[0]


def derivatives(card, cpu_job):
    """Phase 11: dc_sensitivity() and torch.func.jacfwd through tran() on
    the card, through K1, against the same on the CPU (`cpu_job`, the CPU
    worker's cpu_derivatives())."""
    sens, launches = dff_sensitivity("cuda")
    d, jlaunches, wall, calls = rc_jacfwd("cuda")
    sens_cpu, d_cpu = cpu_job.result()

    errs = {k: rel_err(sens[k], sens_cpu[k]) for k in SENS_NAMES}
    peak = {k: float(np.abs(sens[k]).max()) for k in SENS_NAMES}
    print(f"dc_sensitivity() DFF w.r.t. {', '.join(SENS_NAMES)}: max |dx/dp| "
          f"{', '.join(f'{v:.4e}' for v in peak.values())}; relative |card "
          f"- CPU| {', '.join(f'{e:.3e}' for e in errs.values())}; K1 "
          f"launches {launches} [{card}]", flush=True)
    if launches != 1 or not max(errs.values()) <= CPU_TOL:
        raise RuntimeError(f"dc_sensitivity: {launches} K1 launches (want "
                           f"1), errors {errs}")
    if not (peak["cq.c"] == 0.0 and peak["mno1.w"] > 0.0
            and peak["vvdd.dc"] > 0.0):
        raise RuntimeError(f"dc_sensitivity: columns {peak}: want cq.c "
                           f"zero and the others non-zero")
    exact = -1e-3 / (1e3 ** 2 * 1e-6) * np.exp(-1.0)
    err = abs(d - d_cpu) / abs(d_cpu)
    print(f"jacfwd through tran() RC, dv(out, 1 ms)/dR: card {d:.10e}, CPU "
          f"{d_cpu:.10e}, analytic {exact:.10e}; relative |card - CPU| "
          f"{err:.3e}; K1 launches {jlaunches}, wall {wall:.3f} s; rule "
          f"calls: jvp {calls['jvp']}, vmap {calls['vmap']}, crossings of "
          f"GJSolve.apply {calls['apply']} [{card}]", flush=True)
    if not (jlaunches > 0 and err <= CPU_TOL
            and abs(d - exact) <= 5e-2 * abs(exact)):
        raise RuntimeError("jacfwd through tran: card result off")
    return dict(jacfwd_wall=wall, jacfwd_launches=jlaunches,
                jacfwd_calls=calls)


def _ekv_group_ms(cc, x, reps):
    """Host milliseconds of one evaluation of the EKV group alone (its
    residual, charge and local Jacobians, as the assembler computes them)
    at the state x, averaged over `reps` calls after one warm-up."""
    import torch
    from cadnip_tpu_torch.mna.assemble import make_assembler, pad_state
    from cadnip_tpu_torch.mna.spec import MODE_TRAN

    asm = make_assembler(cc)
    gi = next(i for i, g in enumerate(cc.groups)
              if g.model.name == "va:ekv26")
    xp = pad_state(x.reshape(1, -1))
    args = (gi, xp, asm.init_lim(xp), cc.params0()[gi],
            cc.spec.dyn(cc.device, mode=MODE_TRAN))
    asm.eval_group(*args)
    if cc.device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        asm.eval_group(*args)
    if cc.device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def va_ekv(card, tran_job, cpu):
    """Phase 12: the Verilog-A path. The EKV model (models/ekv.py)
    compiled by the port; the DFF on ekv26 instances, loaded by `.hdl`,
    through dc() and tran() on the card over EKV_SPAN, every Newton solve
    a K1 launch, held against the CPU port over the same span (`tran_job`:
    the CPU worker's cpu_ekv_tran()); its noise at the DC operating point
    (q referred to vvdd, EKV_KF on both cards) in one K1 launch, against
    the CPU worker's; the host time of one evaluation of the EKV group on
    the card and on the CPU; and the ten-diode `$limit` chain at DC
    against the CPU."""
    import torch
    from torch.func import vmap
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.mna.assemble import pad_state
    from cadnip_tpu_torch.mna.spec import MODE_AC, MODE_TRANOP
    from cadnip_tpu_torch.models.ekv import EKV_VA
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    t = time.perf_counter()
    ct.compile_va(EKV_VA)
    compile_s = time.perf_counter() - t
    cc, kg = ekv_circuit("cuda"), ekv_circuit("cuda", kf=EKV_KF)
    print(f"EKV compile (ekv26, compile_va) {compile_s * 1e3:.1f} ms; DFF "
          f"on ekv26: n = {cc.n}, groups "
          f"{[(g.model.name, g.n_inst) for g in cc.groups]}", flush=True)

    # the operating point and the transient on the card
    torch.cuda.synchronize()
    gj_solve.launches = 0
    t = time.perf_counter()
    op = ct.dc(cc, mode=MODE_TRANOP, time=0.0)
    torch.cuda.synchronize()
    op_wall = time.perf_counter() - t
    sol = ct.tran(cc, (0, EKV_SPAN), dt=EKV_DT, x0=op.x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = gj_solve.launches
    st = sol.stats
    nnewton, op_iters = int(st.nnewton), int(op.iters)
    ts, q = np.asarray(sol.ts), sol["q"].cpu().numpy()
    lo = float(q[np.argmin(np.abs(ts - EKV_LOW_AT))])
    print(f"EKV DFF dc() + tran() 0-{EKV_SPAN * 1e9:.0f} ns on the card: "
          f"wall {wall:.3f} s (operating point {op_wall:.3f} s), accepted "
          f"{int(st.naccept)}, rejected {int(st.nreject)}, newton {nnewton}"
          f" + DC {op_iters}, K1 launches {launches}; q {lo:.4f} V at "
          f"{EKV_LOW_AT * 1e9:.0f} ns [{card}]", flush=True)
    if not (bool(op.converged) and bool(sol.converged)
            and np.isfinite(sol.xs.cpu().numpy()).all()):
        raise RuntimeError("EKV DFF: the operating point or the transient "
                           "failed")
    if not lo < 1.0:
        raise RuntimeError(f"EKV DFF: q {lo} V at {EKV_LOW_AT} s, want < 1 V")
    if launches < op_iters + nnewton:
        raise RuntimeError(f"EKV DFF: {launches} K1 launches < {op_iters} DC"
                           f" + {nnewton} transient Newton iterations")

    # noise at the DC operating point (kf moves no DC current), found from
    # the transient's: its sources start at their DC values
    nop = ct.dc(kg, x0=op.x)
    noise_job = cpu.submit(cpu_ekv_noise, nop.x.cpu().numpy())
    freqs = ct.acdec(*AC_FREQS)
    torch.cuda.synchronize()
    gj_solve.launches = 0
    t = time.perf_counter()
    ng = ct.noise(kg, "q", freqs, input="vvdd", op_x=nop.x)
    nwall = time.perf_counter() - t
    nlaunch = gj_solve.launches
    gi = next(i for i, g in enumerate(kg.groups)
              if g.model.name == "va:ekv26")
    g = kg.groups[gi]
    u = pad_state(nop.x)[torch.as_tensor(g.conn, device="cuda")]
    p, dyn = kg.params0()[gi], kg.spec.dyn("cuda", mode=MODE_AC)
    white = vmap(g.model.noise, in_dims=(0, 0, None))(u, p, dyn)
    flick = vmap(g.model.flicker, in_dims=(0, 0, None))(u, p, dyn)[0]

    # the card against the CPU port over the same span
    ref = tran_job.result()
    got = tuple(int(v) for v in st[:3]) + (op_iters,)
    dx = sol.xs.cpu().numpy() - ref["xs"]
    err = float(np.abs(dx).max()) / 5.0
    line = (f"EKV DFF 0-{EKV_SPAN * 1e9:.0f} ns, card / CPU accepted, "
            f"rejected, newton, DC {got} / {ref['counts']}, max |dx| / 5 V "
            f"{err:.3e}; CPU wall {ref['wall']:.3f} s (CPU worker) [{card}]")
    if not ref["converged"]:
        raise RuntimeError(f"{line}: the CPU transient failed")
    if got == ref["counts"]:
        print(line, flush=True)
        if not err <= MC_TOL:
            raise RuntimeError(f"{line} > {MC_TOL:.0e}")
    else:
        # a flipped step decision: held to the integrator's reltol, as
        # phase 9 holds a Monte Carlo lane
        apart = np.abs(dx).max(-1) > MC_TOL * 5.0
        rmse = float(np.sqrt(np.mean(dx ** 2))) / 5.0
        print(f"{line}; counts differ, waveforms first part at "
              f"{ts[int(np.argmax(apart))]:.4e} s, RMSE / 5 V {rmse:.3e}",
              flush=True)
        if not rmse <= TWIN_FLIP_TOL:
            raise RuntimeError(f"{line}: RMSE {rmse:.3e} > "
                               f"{TWIN_FLIP_TOL:.0e}")

    nc = noise_job.result()
    nerr = max(float((np.abs(a - c) / np.abs(c)).max()) for a, c in
               zip((ng.onoise_psd, ng.inoise_psd), nc))
    print(f"EKV DFF noise (q, input vvdd, kf {EKV_KF:g}), {len(freqs)} "
          f"frequencies: output PSD {ng.onoise_psd.min():.4e}-"
          f"{ng.onoise_psd.max():.4e} V^2/Hz; EKV thermal PSD sum "
          f"{float(white.sum()):.4e} A^2/Hz, flicker numerator sum "
          f"{float(flick.sum()):.4e}; card against CPU {nerr:.3e}; K1 "
          f"launches {nlaunch}; wall {nwall * 1e3:.1f} ms (operating point "
          f"DC {int(nop.iters)} iterations from the transient's) [{card}]",
          flush=True)
    if not (bool(nop.converged) and nlaunch == 1 and nerr <= AC_TOL
            and np.isfinite(ng.onoise_psd).all()):
        raise RuntimeError(f"EKV DFF noise: {nlaunch} K1 launches, card "
                           f"against CPU {nerr:.3e}")
    if not (float(white.sum()) > 0 and float(flick.sum()) > 0):
        raise RuntimeError("EKV DFF noise: a VA noise channel is zero")

    # host time of the interpreter: one evaluation of the EKV group, with
    # the CPU worker idle
    ms_card = _ekv_group_ms(cc, sol.xs[-1], 20)
    ms_cpu = _ekv_group_ms(ekv_circuit("cpu"), sol.xs[-1].cpu(), 20)
    print(f"EKV group (26 instances): {ms_card:.1f} ms of host time per "
          f"evaluation on the card, {ms_cpu:.1f} ms on the CPU; "
          f"{wall / max(op_iters + nnewton, 1) * 1e3:.1f} ms of wall per "
          f"Newton iteration on the card [{card}]", flush=True)

    # the ten-diode $limit chain at DC
    chain = {}
    for dev in ("cuda", "cpu"):
        model = ct.compile_va(VA_LIMIT_DIODE)["vadiode_lim"]
        cir = ct.Circuit("valim")
        cir.V("v1", "in", "0", dc=30.0)
        prev = "in"
        for k in range(10):
            cir.add(model, f"d{k}", (prev, f"n{k}"))
            prev = f"n{k}"
        cir.R("rl", prev, "0", 10.0)
        chain[dev] = cir.compile(device=dev)
    torch.cuda.synchronize()
    gj_solve.launches = 0
    dg = ct.dc(chain["cuda"])
    torch.cuda.synchronize()
    llaunch = gj_solve.launches
    dcpu = ct.dc(chain["cpu"])
    derr = float(((dg.x.cpu() - dcpu.x).abs() / dcpu.x.abs().clamp(
        min=1e-300)).max())
    print(f"$limit diode chain (10 x vadiode_lim, 30 V, 10 ohm) dc: n4 "
          f"{float(dg['n4']):.6f} V, card / CPU Newton {int(dg.iters)} / "
          f"{int(dcpu.iters)}, max relative difference {derr:.3e}, K1 "
          f"launches {llaunch} [{card}]", flush=True)
    if not (bool(dg.converged) and bool(dcpu.converged)
            and int(dg.iters) == int(dcpu.iters) and derr <= VA_DC_TOL):
        raise RuntimeError("$limit diode chain: card against CPU off")
    if llaunch < int(dg.iters):
        raise RuntimeError(f"$limit diode chain: {llaunch} K1 launches < "
                           f"{int(dg.iters)} Newton iterations")
    return dict(launches={"VA EKV DFF dc + tran (phase 12)": launches,
                          "VA EKV DFF noise (phase 12)": nlaunch,
                          "VA $limit diode chain dc (phase 12)": llaunch},
                wall=wall, ms_card=ms_card, ms_cpu=ms_cpu)


def ekv_k2(card):
    """Phase 12b: the EKV DFF through K2, its 26 ekv26 instances evaluated
    by the device function that va/cuda.py emits. First that function
    (`eval_group`: the `vmem_eval_group` entry of the circuit's library)
    interpreter) on the circuit's own group, at its operating point and at
    seeded bias points around it, to EVAL_TOL (f to the scale of the
    currents it sums); then one K2 launch per span
    of EKV_K2_SPANS (K2's launch count reset before and read after), q low
    at EKV_LOW_AT and, on the whole span, high at EKV_HIGH_AT. Returns the
    runs as phase 6's cases: their twins run on the host CPU in a worker,
    and twin_check holds them to K2 in phase 14."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.mna.assemble import pad_state
    from cadnip_tpu_torch.ops import vmem_tran as vt

    net = ekv_dff_netlist(EKV_VA_FILE)
    setups = {}
    for name, tstop in sorted(EKV_K2_SPANS.items(), key=lambda kv: -kv[1]):
        cc = ct.parse_spice(net, device="cuda")
        x0 = next(iter(setups.values())).x0 if setups else None
        setups[name] = vt.prepare(cc, (0, tstop), dt=EKV_DT, x0=x0)
    S = setups[max(EKV_K2_SPANS, key=EKV_K2_SPANS.get)]
    if S.va is None or S.va.lib is None:
        raise RuntimeError("EKV DFF on K2: no library of emitted models")

    # the emitted device function on the circuit's own group
    gi = next(i for i, g in enumerate(S.cc.groups)
              if g.model.name == "va:ekv26")
    g = S.cc.groups[gi]
    u0 = pad_state(S.x0)[torch.as_tensor(g.conn, device="cuda")]
    rng = np.random.default_rng(12)
    us = [u0] + [u0 + torch.as_tensor(rng.normal(0.0, 1.0, u0.shape),
                                      device="cuda") for _ in range(3)]
    worst = [0.0] * 5
    for u in us:
        args = (u, u, S.params[gi], None, S.dyn(0.0))
        got = vt.eval_group(g.model, *args)
        ref = vt.eval_group_plain(g.model, *args)
        # f against the currents it sums, max|J| max|u|: at the operating
        # point they cancel (max |f| about 1e-17 A from channel currents
        # near 1e-4 A), and f's last bits there are their rounding
        scales = [max(ref[0].abs().max(), ref[2].abs().max() * u.abs().max())
                  ] + [b.abs().max() for b in ref[1:]]
        worst = [max(w, float((a - b).abs().max() / max(float(sc), 1e-300)))
                 for w, a, b, sc in zip(worst, got, ref, scales)]
    print(f"K2 device eval ekv26 (emitted, the DFF's {g.n_inst} instances "
          f"at the operating point and 3 seeded points around it): max "
          f"relative error (f to max|J| max|u|, q, J, C, u_eval) "
          + ", ".join(f"{e:.2e}" for e in worst) + f" [{card}]", flush=True)
    worst = max(worst)
    if not worst <= EVAL_TOL:
        raise RuntimeError(f"K2 device eval ekv26: {worst:.3e} > "
                           f"{EVAL_TOL:.0e}")

    out = {}
    for name, tstop in EKV_K2_SPANS.items():
        S = setups[name]
        cc = S.cc
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ct.vmem_tran.launches = 0
        start.record()
        rk = vt.integrate(S)
        end.record()
        torch.cuda.synchronize()
        ms, launches = start.elapsed_time(end), ct.vmem_tran.launches
        stats = tuple(int(v) for v in rk.stats)
        ts = np.linspace(0.0, tstop, S.n_save)
        q = rk.xs[:, cc.index_of("q")].cpu().numpy()
        lo = float(q[np.argmin(np.abs(ts - min(EKV_LOW_AT, tstop)))])
        hi = (float(q[np.argmin(np.abs(ts - EKV_HIGH_AT))])
              if tstop > EKV_HIGH_AT else None)
        print(f"K2 {name} (n = {cc.n}, emitted ekv26): kernel {ms:.3f} ms, "
              f"accepted, rejected, newton {stats[:3]}, K2 launches "
              f"{launches}; ekv26 group {rk.group_cycles / max(stats[2], 1):.0f}"
              f" cycles per Newton iteration; q {lo:.4f} V at "
              f"{min(EKV_LOW_AT, tstop) * 1e9:.0f} ns"
              + ("" if hi is None else
                 f", {hi:.4f} V at {EKV_HIGH_AT * 1e9:.0f} ns")
              + f" [{card}]", flush=True)
        print(f"   K2 phases: {phase_shares(rk.phases, stats[2])}",
              flush=True)
        if stats[3] or launches != 1:
            raise RuntimeError(f"K2 {name}: failed {stats[3]}, {launches} "
                               f"K2 launches (want 1)")
        if not (lo < 1.0 and (hi is None or hi > 4.0)):
            raise RuntimeError(f"K2 {name}: q {lo} V before the latching "
                               f"edge, {hi} V after it")
        out[name] = dict(ms=ms, net=net, setup=host_setup(S),
                         xs=rk.xs.cpu().numpy(), stats=stats, scale=5.0,
                         cols=[cc.index_of("q")],
                         group_cycles=rk.group_cycles)
    return out


def cpu_pit(name, x0, xseed):
    """Phase 13's CPU side (in a worker): the CPU port's tran_pit of
    PIT_RUNS[name] over PIT_CPU_SPAN from the card's operating point x0
    and window-0 seed xseed; its first two windows' rows are returned."""
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models import vacask

    net, _, dt, kw, _, _ = PIT_RUNS[name]
    cc = ct.parse_spice(getattr(vacask, net), device="cpu")
    t = time.perf_counter()
    sol = ct.tran_pit(cc, (0, PIT_CPU_SPAN[name]), dt, x0=x0, xseed=xseed,
                      **kw)
    return dict(xs=sol.xs[:2 * sol.window + 1].numpy(),
                window_iters=sol.window_iters, window=sol.window,
                fail=bool(sol.stats.fail), wall=time.perf_counter() - t)


def cpu_mul_witness():
    """Phase 13's witness for mul (in a worker): serial_trap over MUL_SPAN
    on the host CPU, the same trapezoidal recursion one step at a time."""
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.analyses.tran_pit import serial_trap
    from cadnip_tpu_torch.mna.devices import CLASS_V
    from cadnip_tpu_torch.models.vacask import MUL

    cc = ct.parse_spice(MUL, device="cpu")
    t = time.perf_counter()
    xs, ok = serial_trap(cc, (0, MUL_SPAN), PIT_RUNS["mul"][2])
    return dict(xs=xs.numpy(), ok=ok, is_v=cc.classes == CLASS_V,
                wall=time.perf_counter() - t)


def power_grid_netlist(side=PG_SIDE):
    """The phase-15 mesh as SPICE text (see PG_SIDE)."""
    lines = [f"power-delivery mesh {side} x {side}",
             ".model dl d is=1e-14",
             "vs n0_0 0 PULSE(1 2 1n 1n 1n 20n 40n)"]
    for i in range(side):
        for j in range(side):
            if i + 1 < side:
                lines.append(f"rx{i}_{j} n{i}_{j} n{i + 1}_{j} 1k")
            if j + 1 < side:
                lines.append(f"ry{i}_{j} n{i}_{j} n{i}_{j + 1} 1k")
            lines.append(f"c{i}_{j} n{i}_{j} 0 1p")
            if i % 3 == 0 and j % 3 == 0:
                lines.append(f"d{i}_{j} n{i}_{j} 0 dl")
    lines.append(f"rl n{side - 1}_{side - 1} 0 1k")
    return "\n".join(lines + [".end", ""])


def _record_bbd_solves(fn):
    """Run fn() with the BBD solver's dense solves recorded: returns
    (fn's result, [(A, B), ...] in launch order)."""
    from cadnip_tpu_torch.ops import bbd
    seen, solve = [], bbd.dense_solve

    def record(A, B, method=None):
        seen.append((A.clone(), B.clone()))
        return solve(A, B, method)

    bbd.dense_solve = record
    try:
        return fn(), seen
    finally:
        bbd.dense_solve = solve


def power_grid(card):
    """Phase 15: the PG_SIDE x PG_SIDE power-delivery mesh through
    parse_spice (which selects the BBD backend), dc and tran over PG_SPAN
    on the card, every block solve and Schur solve a K1 launch: two per
    Newton iteration (three with the nested level), gated per window. Its
    witness is the same mesh compiled dense and solved with the explicit
    `lu64` method (torch.linalg), operating point and transient. Where the
    border stays below the nested threshold, one Newton Jacobian of the
    operating point is also solved through the nested Schur level and held
    to the single level. The K1 systems of one BBD solve are kept for
    phase 14, which times them once the phase-13 process has ended."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.mna.assemble import pad_state
    from cadnip_tpu_torch.mna.bbd_assemble import nested_border_partition
    from cadnip_tpu_torch.mna.devices import CLASS_V
    from cadnip_tpu_torch.mna.newton import (make_dc_solver,
                                              make_system_assembler)
    from cadnip_tpu_torch.mna.spec import MODE_DCOP, MODE_TRANOP
    from cadnip_tpu_torch.ops.bbd import make_bbd_solver
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    net = power_grid_netlist()
    t = time.perf_counter()
    cc = ct.parse_spice(net, device="cuda")
    parse_s = time.perf_counter() - t
    part, p2 = cc.bbd, cc.bbd_nested
    if part is None:
        raise RuntimeError(f"power grid (n = {cc.n}): parse_spice did not "
                           f"select the BBD backend")
    # the block solves and the Schur solve; with the nested level the
    # Schur solve is the level-2 block solves and level-2 Schur solve
    per_it = 3 if p2 is not None else 2
    print(f"power grid {PG_SIDE} x {PG_SIDE} through parse_spice: n = "
          f"{cc.n}, BBD K = {part.K}, bs = {part.bs}, nb = {part.nb}, nbl = "
          f"{part.nbl}; nested level "
          f"{'on, nb2 = %d' % p2.nb if p2 is not None else 'off'} (parse, "
          f"elaborate and partition {parse_s:.2f} s) [{card}]", flush=True)

    def window(fn):
        torch.cuda.synchronize()
        gj_solve.launches = 0
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, gj_solve.launches, time.perf_counter() - t

    op, dc_l, dc_s = window(lambda: ct.dc(cc))
    it = int(op.iters)
    print(f"   dc: converged {bool(op.converged)}, {it} Newton iterations, "
          f"K1 launches {dc_l} ({per_it} per iteration), wall {dc_s:.3f} s "
          f"({dc_s / max(it, 1) * 1e3:.1f} ms per iteration)", flush=True)
    if not bool(op.converged) or dc_l != per_it * it:
        raise RuntimeError(f"power grid dc: converged {bool(op.converged)}, "
                           f"{dc_l} K1 launches for {it} iterations")
    sol, tr_l, tr_s = window(lambda: ct.tran(cc, (0, PG_SPAN), dt=PG_DT))
    counts = tuple(int(v) for v in sol.stats[:3])
    op_it = int(sol.op_iters)
    xs = sol.xs.cpu().numpy()
    v_drive = float(xs[-1, cc.index_of("n0_0")])
    far = f"n{PG_SIDE - 1}_{PG_SIDE - 1}"
    print(f"   tran 0-{PG_SPAN * 1e9:g} ns at {PG_DT * 1e12:g} ps: "
          f"converged {bool(sol.converged)}, accepted, rejected, newton "
          f"{counts}, operating point {op_it} iterations; K1 launches "
          f"{tr_l}; wall {tr_s:.3f} s ({tr_s / max(counts[2] + op_it, 1) * 1e3:.1f}"
          f" ms per Newton iteration); v(n0_0) at the end {v_drive:.6f} V, "
          f"v({far}) {float(xs[-1, cc.index_of(far)]):.6f} V", flush=True)
    if not bool(sol.converged) or not np.isfinite(xs).all():
        raise RuntimeError("power grid tran: failed")
    if tr_l != per_it * (counts[2] + op_it):
        raise RuntimeError(f"power grid tran: {tr_l} K1 launches for "
                           f"{counts[2]} + {op_it} Newton iterations")
    if abs(v_drive - 2.0) > 1e-9:
        raise RuntimeError(f"power grid tran: v(n0_0) {v_drive} V at the "
                           f"span's end, the source drives 2 V")

    # one Newton Jacobian of the operating point through both Schur forms;
    # the single level's K1 systems are kept for phase 14's timings
    asm = make_system_assembler(cc)
    xp = pad_state(op.x[None])
    F, _, G, _, _ = asm(xp, asm.init_lim(xp), cc.params0(),
                        cc.spec.dyn("cuda"))
    single = make_bbd_solver(part, "cuda")
    (dx1, l1, _), systems = _record_bbd_solves(
        lambda: window(lambda: single(*G, -F)))
    nested = {}
    if p2 is None:
        q = nested_border_partition(cc, part)
        (dx2, l2, _), nested_systems = _record_bbd_solves(
            lambda: window(lambda: make_bbd_solver(
                part, "cuda", nested=q)(*G, -F)))
        # the nested level's own K1 systems: its block solves and its Schur
        systems = systems + nested_systems[1:]
        rel = rel_err(dx2, dx1)
        print(f"   nested Schur level (K2 = {q.K}, bs2 = {q.bs}, nb2 = "
              f"{q.nb}, nbl2 = {q.nbl}) on one Newton Jacobian of the "
              f"operating point: K1 launches {l2} (single level {l1}); dx "
              f"against the single level {rel:.3e} (bar "
              f"{PG_NESTED_TOL:.0e})", flush=True)
        if l1 != 2 or l2 != 3 or not rel <= PG_NESTED_TOL:
            raise RuntimeError(f"power grid nested Schur: {rel:.3e}, "
                               f"launches {l1} / {l2}")
        nested = dict(K2=q.K, bs2=q.bs, nb2=q.nb, nbl2=q.nbl, rel=rel)

    # the witness: dense, lu64
    t = time.perf_counter()
    ccd = ct.parse_spice(net, compile=False).compile(solver="dense",
                                                     device="cuda")
    dcs = make_dc_solver(ccd, method="lu64")
    z = torch.zeros((1, ccd.n), dtype=torch.float64, device="cuda")
    pd = ccd.params0()
    wop, w_l, _ = window(lambda: dcs(z, pd, ccd.spec.dyn("cuda",
                                                         mode=MODE_DCOP)))
    wop0 = dcs(z, pd, ccd.spec.dyn("cuda", mode=MODE_TRANOP, time=0.0))
    wsol, wt_l, wt_s = window(lambda: ct.tran(
        ccd, (0, PG_SPAN), dt=PG_DT, method="lu64", x0=wop0.x[0]))
    w_s = time.perf_counter() - t
    # the bars are in volts, on the node voltages; the source's branch
    # current (up to about 1e19 A: the diode across the driven corner at
    # 2 V) is held relative to its size
    v = cc.classes == CLASS_V
    dc_err = float((op.x - wop.x[0])[v].abs().max())
    wcounts = tuple(int(c) for c in wsol.stats[:3])
    wxs = wsol.xs.cpu().numpy()
    tr_err = float(np.abs(xs - wxs)[:, v].max())
    i_err = max(rel_err(op.x[~v], wop.x[0][~v]),
                rel_err(xs[:, ~v], wxs[:, ~v]))
    tr_tol = PG_TRAN_SAME_TOL if wcounts == counts else PG_TRAN_TOL
    print(f"   dense witness (lu64, torch.linalg; {w_s:.1f} s with its "
          f"build): dc {int(wop.iters)} iterations, node voltages max "
          f"|x - x_bbd| {dc_err:.3e} V (bar {PG_DC_TOL:.0e}); tran accepted,"
          f" rejected, newton {wcounts} (BBD {counts}), node voltages max "
          f"|dx| {tr_err:.3e} V (bar {tr_tol:.0e}); the branch current "
          f"{i_err:.3e} of its size (bar {PG_CURRENT_TOL:.0e}); K1 launches "
          f"{w_l + wt_l}", flush=True)
    if not (bool(wop.converged.all()) and bool(wsol.converged)):
        raise RuntimeError("power grid witness: did not converge")
    if (not (dc_err <= PG_DC_TOL and tr_err <= tr_tol
             and i_err <= PG_CURRENT_TOL) or w_l + wt_l):
        raise RuntimeError(f"power grid against the dense witness: dc "
                           f"{dc_err:.3e} V, tran {tr_err:.3e} V, current "
                           f"{i_err:.3e}, K1 launches {w_l + wt_l} (want 0)")
    return dict(launches=dc_l + tr_l, dc=dict(iters=it, wall=dc_s),
                newton_ms=tr_s / max(counts[2] + op_it, 1) * 1e3,
                tran=dict(counts=counts, op_iters=op_it, wall=tr_s),
                n=cc.n, K=part.K, bs=part.bs, nb=part.nb, nbl=part.nbl,
                nested=nested, systems=systems, witness_s=w_s,
                dc_err=dc_err, tran_err=tr_err, xs=xs, is_v=v)


def bbd_k1_rows(card, pg):
    """Phase 14's half of phase 15: K1 at the power grid's BBD shapes (the
    recorded systems of one Newton solve: the block and Schur solves, and
    where the nested level ran its block and Schur solves), against its
    plain twin, torch.linalg.solve_ex and its bound; timed after the
    phase-13 process has left the card. Then the BBD Newton iteration of
    phase 15's transient split into the Schur launch, the block solves'
    launch and the rest (host-side assembly and dispatch)."""
    import torch
    from cadnip_tpu_torch.ops.gj_solve import gj_solve, plain_twin, variant

    rows = {}
    names = ("block solves", "Schur solve", "nested block solves",
             "nested Schur solve")
    for what, (A, B) in zip(names, pg["systems"]):
        b, n, _ = A.shape
        k = B.shape[-1] if B.ndim == 3 else 1
        B3 = B if B.ndim == 3 else B[..., None].contiguous()
        X, Xp = gj_solve(A, B3), plain_twin(A, B3)
        err = rel_err(X, Xp)
        reps = 5 if n > 500 else 50
        ms = cuda_time_ms(lambda: gj_solve(A, B3), reps)
        plain_ms = cuda_time_ms(lambda: plain_twin(A, B3), 3)
        library_ms = cuda_time_ms(lambda: torch.linalg.solve_ex(A, B3), reps)
        bound = roofline(8 * b * (n * n + 2 * n * k), b * solve_flops(n, k),
                         8)
        shape = f"f64 n={n} k={k} b={b}"
        print(f"K1 at the power grid's {what} {shape} "
              f"({variant(n, k, 8, b)}): |kernel - plain| / max {err:.3e}; "
              f"kernel "
              f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
              f"torch.linalg.solve_ex {library_ms * 1e3:.1f} us; bound "
              f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}) "
              f"[{card}]", flush=True)
        if not err <= 1e-10:
            raise RuntimeError(f"K1 at {shape}: {err:.3e} from the twin")
        rows[what] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, max_abs_err=err, **bound)
    it_ms = pg["newton_ms"]
    k1_ms = rows["Schur solve"]["ms"] + rows["block solves"]["ms"]
    print(f"power grid BBD Newton iteration (phase 15's tran) {it_ms:.2f} ms:"
          f" Schur launch {rows['Schur solve']['ms']:.3f} ms, block solves' "
          f"launch {rows['block solves']['ms']:.3f} ms, the rest (host-side "
          f"assembly and dispatch) {it_ms - k1_ms:.2f} ms [{card}]",
          flush=True)
    return rows


def pit_child(which, log_path, graetz_k2, dar_coll, phase4, results):
    """Phase 13 (`which` "13") or 13b ("13b") in a process of its own on
    the same card, started before phase 9 so that its host-bound loops
    overlap phases 9-12 and 15-18. Phase 13: rc through tran_linear, then
    graetz and mul through pit_engines with two CPU workers of its own
    (mul's witness, then mul's replay; graetz's replay), so that the
    replays do not queue behind the witness. Phase 13b: the darlington
    through pit_engines, then phase 18's DFF runs under the
    mixed-precision methods (mixed_dff). Its output goes to `log_path`;
    its results, or the traceback of its failure, to the queue
    `results`."""
    import contextlib
    import traceback
    _exit_with_parent()
    sys.path.insert(0, ROOT)
    workers = []
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        try:
            card = nvidia_smi("name,power.limit")
            from cadnip_tpu_torch.ops.gj_solve import load_library
            load_library()
            walls = {}
            t = time.perf_counter()
            if which == "13":
                workers = [cpu_worker(), cpu_worker()]
                witness_job = workers[0].submit(cpu_mul_witness)
                lin = rc_linear(card)
                walls["13 rc tran_linear"] = time.perf_counter() - t
                t = time.perf_counter()
                pit = pit_engines(card, {"mul": workers[0],
                                         "graetz": workers[1]}, graetz_k2,
                                  None, witness_job, ("graetz", "mul"))
                walls["13 tran_pit"] = time.perf_counter() - t
                res = dict(lin=lin, pit=pit, walls=walls)
            else:
                pit = pit_engines(card, None, None, {"coll": dar_coll},
                                  None, ("darlington",))
                walls["13b tran_pit"] = time.perf_counter() - t
                t = time.perf_counter()
                mixed = mixed_dff(card, phase4)
                walls["18a DFF gjpl32ir, lu32ir"] = time.perf_counter() - t
                res = dict(pit=pit, mixed=mixed, walls=walls)
            results.put(("ok", res))
        except Exception:
            results.put(("failed", traceback.format_exc()))
        finally:
            for w in workers:
                w.shutdown(wait=True, cancel_futures=True)


def start_pit_child(which, graetz_k2, dar, phase4=None):
    """Start pit_child(which, ...) (spawned) and return (process, queue,
    log path, which). The card must be in the Default compute mode, where
    several processes share it."""
    import multiprocessing
    import tempfile
    mode = nvidia_smi("compute_mode")
    print(f"compute mode: {mode}", flush=True)
    if mode != "Default":
        raise RuntimeError(f"compute mode {mode!r}: phase {which}'s process "
                           f"needs the card shared (Default)")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    fd, log_path = tempfile.mkstemp(prefix=f"chip_smoke_{which}_",
                                    suffix=".log")
    os.close(fd)
    proc = ctx.Process(target=pit_child,
                       args=(which, log_path, graetz_k2,
                             np.asarray(dar["coll"]), phase4, q))
    proc.start()
    return proc, q, log_path, which


def join_pit_child(child):
    """Wait for phase 13's or 13b's process, print its output, and return
    its results; its failure fails the run."""
    import queue
    proc, q, log_path, which = child
    t = time.perf_counter()
    while True:
        try:
            status, payload = q.get(timeout=5)
            break
        except queue.Empty:
            if not proc.is_alive():
                status, payload = "failed", (f"its process ended with exit "
                                             f"code {proc.exitcode}")
                break
    proc.join(timeout=60)
    waited = time.perf_counter() - t
    with open(log_path) as fh:
        text = fh.read()
    os.unlink(log_path)
    print(f"---- phase {which} (its own process, read after a wait of "
          f"{waited:.1f} s) ----\n{text.rstrip()}\n---- end of phase {which} "
          f"----", flush=True)
    if status != "ok":
        raise RuntimeError(f"phase {which} failed:\n{payload}")
    return payload


def rc_linear(card):
    """Phase 13, rc: bench.py's bench_rc through tran_linear on the card,
    1,000,001 points, against the closed form of the first pulse."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models.vacask import RC_NETLIST
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    cc = ct.parse_spice(RC_NETLIST, device="cuda")
    torch.cuda.synchronize()
    gj_solve.launches = 0
    t = time.perf_counter()
    sol = ct.tran_linear(cc, RC_SPAN, RC_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = gj_solve.launches
    v2, ts = sol["2"].cpu().numpy(), np.asarray(sol.ts)
    seg = (ts >= 5e-6) & (ts <= 9e-4)
    tau, tr = 1e-3, 1e-6
    v_ramp_end = 1.0 - tau / tr * (1 - np.exp(-tr / tau))
    v_exact = 1.0 + (v_ramp_end - 1.0) * np.exp(-(ts[seg] - 2e-6) / tau)
    rmse = float(np.sqrt(np.mean((v2[seg] - v_exact) ** 2)))
    print(f"rc tran_linear() 0-1 s at 1 us ({v2.shape[0]} points): wall "
          f"{wall:.3f} s (operating point {sol.timings['op']:.3f} s), K1 "
          f"launches {launches}; closed-form RMSE on [5 us, 0.9 ms] "
          f"{rmse:.3e} [{card}]", flush=True)
    if v2.shape[0] != 1_000_001 or not np.isfinite(v2).all():
        raise RuntimeError(f"rc tran_linear: bad waveform {v2.shape}")
    if not rmse < RC_TOL:
        raise RuntimeError(f"rc tran_linear: RMSE {rmse:.3e} >= {RC_TOL}")
    if launches < 1:
        raise RuntimeError("rc tran_linear: no K1 launch")
    return dict(launches=launches, wall=wall)


def pit_k1(card, cc, X, dt):
    """K1 at a tran_pit path's shape: the [W, n, n + 1] systems of one
    trapezoidal window iteration at the window's own solution X [W, n]
    (rows scaled as `_window_dx` scales them), against the plain twin and
    torch.linalg.solve_ex on the same tensors, beside the bound."""
    import torch
    from cadnip_tpu_torch.mna.assemble import make_assembler, pad_state
    from cadnip_tpu_torch.mna.spec import MODE_TRAN
    from cadnip_tpu_torch.ops.gj_solve import gj_solve, gj_solve_plain

    asm = make_assembler(cc)
    W, n = X.shape
    xp = pad_state(X)
    tw = dt * (1.0 + torch.arange(W, dtype=torch.float64, device=cc.device))
    F, _, G, C, _ = asm(xp, asm.init_lim(xp), cc.params0(),
                        cc.spec.dyn(cc.device, mode=MODE_TRAN, time=tw))
    D = G + (2.0 / dt) * C
    L = torch.cat([torch.zeros_like(D[:1]), G[:-1] - (2.0 / dt) * C[:-1]])
    rinv = 1.0 / torch.clamp(D.abs().amax(2, keepdim=True), min=1e-30)
    A = (D * rinv).contiguous()
    B = torch.cat([L * rinv, F[..., None] * rinv], -1).contiguous()
    Xp = gj_solve_plain(A, B)
    # the kernel rounds a - f*b as one FMA and the twin does not; on the
    # path's own systems (the off-state diodes' rows leave cond(A) far
    # above phase 3's random ones) each system is held, as phase 9c holds
    # the Jacobians, to JAC_DERIV_FACTOR * n * cond(A) * eps of its size
    rel = ((gj_solve(A, B) - Xp).abs().amax((1, 2))
           / Xp.abs().amax((1, 2)).clamp(min=1e-300)).cpu().numpy()
    cond = np.linalg.cond(A.cpu().numpy())
    ratio = rel / (JAC_DERIV_FACTOR * n * cond * np.finfo(np.float64).eps)
    err, tol = float(rel.max()), float(ratio.max())
    ms = cuda_time_ms(lambda: gj_solve(A, B), 20)
    plain_ms = cuda_time_ms(lambda: gj_solve_plain(A, B), 3)
    library_ms = cuda_time_ms(lambda: torch.linalg.solve_ex(A, B), 20)
    bound = roofline(8 * W * (n * n + 2 * n * (n + 1)),
                     W * solve_flops(n, n + 1), 8)
    shape = f"f64 n={n} k={n + 1} b={W}"
    print(f"K1 at the tran_pit shape {shape}: max |kernel - plain| "
          f"relative {err:.3e}, cond(A) {cond.min():.2e}-{cond.max():.2e},"
          f" worst error / bound {tol:.3e}; kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} "
          f"us, torch.linalg.solve_ex {library_ms * 1e3:.1f} us; "
          f"{bound['bytes']} bytes, {bound['flops']} FLOP, bound "
          f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}) [{card}]",
          flush=True)
    if not tol <= 1.0:
        raise RuntimeError(f"K1 at {shape}: |kernel - plain| over its "
                           f"bound by {tol:.3e}")
    return dict(shape=shape, max_rel_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound)


def pit_against_cpu(card, name, head, window_iters, window, scale, job):
    """The card's first two windows of PIT_RUNS[name] (`head`, a host copy
    of their rows) against the CPU port's run of them from the card's
    operating point and seed (`job`, the worker's cpu_pit), with both runs'
    window-Newton iterations over those windows: equal, and then within
    PIT_CPU_TOL of the scale; or a flipped decision, and then within
    TWIN_FLIP_TOL; the RMSE within PIT_CPU_RMSE_TOL."""
    t = time.perf_counter()
    ref = job.result()
    waited = time.perf_counter() - t
    rows = head.shape[0]
    end = 2 * ref["window"]
    card_it = sum(i for o, i in window_iters if o < end)
    cpu_it = sum(i for o, i in ref["window_iters"] if o < end)
    dx = head - ref["xs"][:rows]
    err = float(np.abs(dx).max()) / scale
    rmse = float(np.sqrt(np.mean(dx ** 2))) / scale
    tol = PIT_CPU_TOL[name] if card_it == cpu_it else TWIN_FLIP_TOL
    line = (f"tran_pit {name} on the card against the CPU port's first two "
            f"windows from the card's operating point and seed ({rows - 1} "
            f"steps; {ref['wall']:.1f} s in the worker, read after a wait of "
            f"{waited:.3f} s): window-Newton iterations {card_it} / {cpu_it},"
            f" max |dx| / scale {err:.3e} (bar {tol:.0e}), RMSE / scale "
            f"{rmse:.3e} (bar {PIT_CPU_RMSE_TOL:.0e}) [{card}]")
    print(line, flush=True)
    if ref["fail"] or ref["window"] != window:
        raise RuntimeError(f"{line}: the CPU run failed or took another "
                           f"window")
    if ref["xs"].shape[0] != rows or not (err <= tol
                                          and rmse <= PIT_CPU_RMSE_TOL):
        raise RuntimeError(f"{line}: over a bar")
    return dict(card_it=card_it, cpu_it=cpu_it, err=err, wall=ref["wall"])


def pit_engines(card, cpus, graetz_k2, dar, witness_job, names):
    """Phase 13: `names` of graetz, mul and the darlington (phase 13b's
    process runs the darlington, phase 13's the others) through tran_pit
    on the card at bench.py's settings (PIT_RUNS), each window iteration one K1
    launch of [W, n, n + 1]: wall, the periodic seed's serial tran(), the
    windows, iterations, ms per window iteration, K1 launches per part,
    peak device memory; bench.py's gates; graetz against phase 8's K2
    waveform, mul against serial_trap on the CPU (`witness_job`) and the
    golden over its span, the darlington against phase 8b's; K1 at each
    path's shape. The first two windows of graetz and mul are replayed by
    the CPU port in the worker `cpus[name]` from the card's operating point
    and seed while the card runs on, and compared at the end."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.models import vacask
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    out, replays = {}, {}
    for name in names:
        net, span, dt, kw, (na, nb), scale = PIT_RUNS[name]
        cc = ct.parse_spice(getattr(vacask, net), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gj_solve.launches = 0
        t = time.perf_counter()
        sol = ct.tran_pit(cc, span, dt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = gj_solve.launches
        peak = torch.cuda.max_memory_allocated()
        nn = int(sol.stats.nnewton)
        tm, k1l = sol.timings, sol.k1_launches
        if name in PIT_CPU_SPAN:
            head = sol.xs[:2 * sol.window + 1].cpu().numpy()
            replays[name] = (head, sol.window_iters, sol.window, scale,
                             cpus[name].submit(cpu_pit, name, head[0],
                                         sol.xseed.cpu().numpy()))
        ts = np.asarray(sol.ts)
        v = sol[na].cpu().numpy()
        if nb is not None:
            v = v - sol[nb].cpu().numpy()
        print(f"{name} tran_pit() {span[1]:g} s at {dt:g} s ({v.shape[0]} "
              f"rows, n = {cc.n}, window {sol.window}): wall {wall:.3f} s = "
              f"operating point {tm['op']:.3f} s + periodic seed (serial "
              f"tran) {tm['seed']:.3f} s ({tm['seed'] / wall * 100:.1f} %) + "
              f"windows {tm['windows']:.3f} s; window-Newton iterations {nn},"
              f" {tm['windows'] / max(nn, 1) * 1e3:.2f} ms each; K1 launches "
              f"{launches} (operating point {k1l['op']}, seed {k1l['seed']}, "
              f"windows {k1l['windows']}); host syncs {sol.host_syncs}; peak "
              f"device memory {peak / 2**20:.0f} MiB [{card}]", flush=True)
        print(f"   first pieces (step offset, iterations): "
              f"{sol.window_iters[:8]}", flush=True)
        if bool(sol.stats.fail) or not np.isfinite(v).all():
            raise RuntimeError(f"{name} tran_pit: failed")
        if k1l["windows"] != nn or sum(k1l.values()) != launches:
            raise RuntimeError(f"{name} tran_pit: K1 launches {k1l} (of "
                               f"{launches}) against {nn} window-Newton "
                               f"iterations")
        k1 = pit_k1(card, cc, sol.xs[1:sol.window + 1].contiguous(), dt)
        if name == "graetz":
            late = ts > 0.06
            ripple_ok = 16.0 < v[late].min() < v[late].max() < 19.5
            rmse = golden_rmse(sol, "graetz", "outp", "outn", scale=20.0)
            g = np.load(os.path.join(GOLDENS, "graetz.npz"))
            k2 = float(np.sqrt(np.mean((np.interp(g["ts"], ts, v)
                                        - graetz_k2) ** 2))) / 20.0
            print(f"   graetz: v(outp,outn) after 0.06 s in "
                  f"[{v[late].min():.4f}, {v[late].max():.4f}] V, golden rel "
                  f"RMSE {rmse:.3e} (gate {GRAETZ_TOL:.0e}); against phase "
                  f"8's K2 at the golden's instants {k2:.3e}", flush=True)
            if not (ripple_ok and rmse <= GRAETZ_TOL):
                raise RuntimeError(f"graetz tran_pit: ripple in range "
                                   f"{ripple_ok}, golden RMSE {rmse:.3e}")
        elif name == "mul":
            v20 = float(v[-1])
            g = np.load(os.path.join(GOLDENS, "mul.npz"))
            m = g["ts"] <= span[1]
            rmse = float(np.sqrt(np.mean((np.interp(g["ts"][m], ts, v)
                                          - g["20"][m]) ** 2))) / 50.0
            tw = time.perf_counter()
            ref = witness_job.result()
            waited = time.perf_counter() - tw
            xs = sol.xs.cpu().numpy()
            wit = float(np.abs(xs - ref["xs"])[:, ref["is_v"]].max()) / 50.0
            print(f"   mul: v(20) at {span[1] * 1e6:g} us {v20:.3f} V "
                  f"(golden {np.interp(span[1], g['ts'], g['20']):.3f} V), "
                  f"golden rel RMSE over the span {rmse:.3e} (gate "
                  f"{MUL_GOLDEN_TOL:.1e}); against serial_trap on the host "
                  f"CPU ({ref['wall']:.1f} s in the worker, read after a wait"
                  f" of {waited:.3f} s) max |dv| / 50 V {wit:.3e} (gate "
                  f"{MUL_WITNESS_TOL:.0e})", flush=True)
            if not (v20 > 40.0 and rmse <= MUL_GOLDEN_TOL and ref["ok"]
                    and wit <= MUL_WITNESS_TOL):
                raise RuntimeError(f"mul tran_pit: v(20) {v20} V at the "
                                   f"span's end, golden RMSE {rmse:.3e}, "
                                   f"witness converged {ref['ok']}, "
                                   f"{wit:.3e} from it")
        else:
            last = ts > span[1] - 2e-6
            switch = bool(v[last].min() < 1.0 and v[last].max() > 4.5)
            rows = v.shape[0]
            q99, mx = edge_masked(ts, v, dar["coll"][:rows])
            print(f"   darlington: v(coll) over the last period in "
                  f"[{v[last].min():.4f}, {v[last].max():.4f}] V; against "
                  f"phase 8b's K2 away from the edges: 99th percentile "
                  f"{q99:.3e} V, max {mx:.3e} V", flush=True)
            if not switch:
                raise RuntimeError("darlington tran_pit: no switching over "
                                   "the last period")
            if not (q99 < EDGE_Q99_TOL and mx < EDGE_MAX_TOL):
                raise RuntimeError(f"darlington tran_pit against K2: "
                                   f"{q99:.3e} / {mx:.3e} V")
        out[name] = dict(launches=k1l, nnewton=nn, wall=wall,
                         seed=tm["seed"], peak=peak,
                         ms_per_it=tm["windows"] / max(nn, 1) * 1e3, k1=k1)
    for name, args in replays.items():
        out[name]["cpu"] = pit_against_cpu(card, name, *args)
    return out



#: phase 16: Verilog-A absdelay, behavioral B-sources and simulate(). The
#: delay modules and decks of tests/test_delay.py (`{va}` is the path of
#: DELAY_VA written to a temporary directory), their gates, and the decks
#: of tests/test_frontend.py's meas, simulate and B-source cases
DELAY_VA = """
`include "disciplines.vams"
module dline(a, y);
  inout a, y;
  electrical a, y;
  parameter real td = 5u from (0:inf);
  analog V(y) <+ absdelay(V(a), td);
endmodule

module dmix(a, y);
  inout a, y;
  electrical a, y;
  parameter real td = 4u;
  parameter real k = 0.5;
  analog V(y) <+ V(a) + k * absdelay(V(a), td);
endmodule
"""
DELAY_DECKS = {
    "dline": """delay line
.hdl "{va}"
v1 in 0 dc 0 pulse 0 1 2u 1u 1u 10u 40u
x1 in out dline td=5u
r1 out 0 1k
""",
    "dmix": """delay mix
.hdl "{va}"
v1 in 0 dc 0 pulse 0 1 1u 0.5u 0.5u 20u 50u
x1 in out dmix td=4u k=0.5
r1 out 0 1k
""",
    "dline ac": """delay ac
.hdl "{va}"
v1 in 0 dc 1 ac 1
x1 in out dline td=5u
r1 out 0 1k
"""}
DLINE_TD, DLINE_SPAN, DMIX_SPAN, DELAY_DT = 5e-6, 30e-6, 12e-6, 0.1e-6
#: dline's gates: max |out(t) - in(t - td)|, and the plateaus (time, volts)
DLINE_SHIFT_TOL, DLINE_PLATEAUS = 0.03, ((12e-6, 1.0), (25e-6, 0.0),
                                         (5e-6, 0.0))
DMIX_GATES = ((3e-6, 1.0), (9e-6, 1.5))    # within 1e-3
DELAY_AC_FREQS = (400, 1e3, 1e5)           # acdec: 801 points
#: dmix's trace, card against CPU: the violation column (max |dx| over
#: its tolerance) of a converged pass is at the rounding floor of dx, where
#: K1's sums and the twin's part; the other columns are held to 1e-12
TRACE_VIOL_TOL = 1e-6
SIM_DECKS = {
    "meas": """meas test
vs in 0 dc 0 pulse 0 1 1u 1n 1n 4u 10u
r1 in out 1k
c1 out 0 1n
.tran 0.05u 8u
.meas tran vmax max v(out) from=0 to=8u
.meas tran vend find v(out) at=4u
.meas tran tcross when v(out)=0.5 rise=1
.meas tran tdel trig v(in) val=0.5 rise=1 targ v(out) val=0.5 rise=1
.meas tran vsq param = vmax*vmax
""",
    "cards": """auto
v1 in 0 dc 5 ac 1
r1 in out 1k
c1 out 0 1u
.op
.ac dec 5 10 10k
.tran 10u 1m
""",
    "bsource": """bsrc
v1 in 0 2
r1 in 0 1k
bsq out 0 v={v(in)*v(in) + 1}
rl out 0 1k
.op
"""}


def delay_sim_runs(device):
    """Phase 16's runs on `device` (the card in the main process, "cpu" in
    a worker): dline through tran() over DLINE_SPAN and dmix over
    DMIX_SPAN with trace=True, dline's AC over DELAY_AC_FREQS, and
    simulate() on SIM_DECKS. Each run's K1 launches (0 on the CPU), wall
    and, for the transients, the host time of the delay probe; the
    results as numpy."""
    import tempfile
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.mna import assemble as asm
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    probe, probe_s = asm.DelayMeta.probe, [0.0]

    def timed_probe(self, *args):
        t = time.perf_counter()
        try:
            return probe(self, *args)
        finally:
            probe_s[0] += time.perf_counter() - t

    def host(v):
        return v.detach().cpu().numpy()

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dline.va")
        with open(path, "w") as fh:
            fh.write(DELAY_VA)
        decks = {k: v.format(va=path) for k, v in DELAY_DECKS.items()}
        ccs = {k: ct.parse_spice(v, device=device) for k, v in decks.items()}
    asm.DelayMeta.probe = timed_probe
    try:
        for name, span, kw in (("dline", DLINE_SPAN, {}),
                               ("dmix", DMIX_SPAN, {"trace": True})):
            sync()
            gj_solve.launches, probe_s[0] = 0, 0.0
            t = time.perf_counter()
            sol = ct.tran(ccs[name], (0, span), dt=DELAY_DT, **kw)
            sync()
            out[name] = dict(
                wall=time.perf_counter() - t, launches=gj_solve.launches,
                probe_s=probe_s[0], converged=bool(sol.converged),
                counts=tuple(int(v) for v in sol.stats[:3]),
                op_iters=int(sol.op_iters), ts=np.asarray(sol.ts),
                xs=host(sol.xs), vin=host(sol["in"]), vout=host(sol["out"]),
                trace=None if sol.trace is None else
                (host(sol.trace[0]), int(sol.trace[1])))
    finally:
        asm.DelayMeta.probe = probe
    cc = ccs["dline ac"]
    op = ct.dc(cc)
    freqs = ct.acdec(*DELAY_AC_FREQS)
    sync()
    gj_solve.launches = 0
    t = time.perf_counter()
    h = ct.ac(cc, freqs, op_x=op.x)["out"]
    sync()
    out["ac"] = dict(freqs=freqs, h=h, wall=time.perf_counter() - t,
                     launches=gj_solve.launches,
                     converged=bool(op.converged))
    for name, deck in SIM_DECKS.items():
        sync()
        gj_solve.launches = 0
        t = time.perf_counter()
        res = ct.simulate(deck, device=device)
        sync()
        r = dict(wall=time.perf_counter() - t, launches=gj_solve.launches,
                 meas=res.get("meas", {}))
        if "op" in res:
            r["op"] = host(res["op"].x)
            r["op_out"] = float(res["op"]["out"])
            r["op_converged"] = bool(res["op"].converged)
        if "ac" in res:
            r["ac"] = res["ac"]["out"]
        if "tran" in res:
            r["tran_counts"] = tuple(int(v) for v in res["tran"].stats[:3])
            r["tran_xs"] = host(res["tran"].xs)
            r["tran_converged"] = bool(res["tran"].converged)
        out[f"simulate {name}"] = r
    return out


def cpu_delay_sim():
    """Phase 16's CPU side (a worker)."""
    return delay_sim_runs("cpu")


def delays_simulate(card, job):
    """Phase 16: Verilog-A absdelay, B-sources and simulate() on the card.
    dline over DLINE_SPAN within test_delay.py's gates (the shift, the
    plateaus), dmix over DMIX_SPAN with the solver trace within its gates,
    and dline's delayed AC sweep (|H| = 1, phase -ωτ, one K1 launch), each
    against the CPU port (`job`: the worker's cpu_delay_sim()) with equal
    step counts, voltages within 1e-9 V, the trace's rows at equal
    indices and AC within AC_TOL of max |H|; the transients' K1 launches
    at least their Newton passes. Then simulate() on the card on the
    meas, cards and B-source decks of SIM_DECKS against the CPU port."""
    got = delay_sim_runs("cuda")
    t = time.perf_counter()
    ref = job.result()
    waited = time.perf_counter() - t
    print(f"phase 16's CPU side read after a wait of {waited:.3f} s",
          flush=True)
    launches = {}
    for name, span in (("dline", DLINE_SPAN), ("dmix", DMIX_SPAN)):
        g, r = got[name], ref[name]
        passes = g["counts"][2] + g["op_iters"]
        dx = float(np.abs(g["xs"] - r["xs"]).max())
        line = (f"{name} tran() 0-{span * 1e6:.0f} us on the card: wall "
                f"{g['wall']:.3f} s, Newton passes {g['counts'][2]} + DC "
                f"{g['op_iters']}, {g['wall'] / passes * 1e3:.2f} ms per "
                f"pass, delay probe {g['probe_s'] * 1e3 / g['counts'][0]:.3f}"
                f" ms of host time per accepted step; accepted, rejected, "
                f"newton card / CPU {g['counts']} / {r['counts']}, max |dx| "
                f"{dx:.3e} V, K1 launches {g['launches']} [{card}]")
        print(line, flush=True)
        if not (g["converged"] and r["converged"]):
            raise RuntimeError(f"{line}: a transient failed")
        if g["counts"] != r["counts"] or not dx <= CPU_TOL:
            raise RuntimeError(f"{line}: card against CPU off")
        if g["launches"] < passes:
            raise RuntimeError(f"{line}: fewer K1 launches than Newton "
                               f"passes")
        launches[f"{name} tran (phase 16)"] = g["launches"]
    g = got["dline"]
    ts = g["ts"]
    shift = int(round(DLINE_TD / (ts[1] - ts[0])))
    err = float(np.abs(g["vout"][shift:] - g["vin"][:-shift]).max())
    plat = [float(g["vout"][np.argmin(np.abs(ts - t0))] - v)
            for t0, v in DLINE_PLATEAUS]
    print(f"dline gates: max |out(t) - in(t - td)| {err:.4f} (gate "
          f"{DLINE_SHIFT_TOL}), plateaus off by {plat}", flush=True)
    if not (err < DLINE_SHIFT_TOL and max(map(abs, plat)) <= 1e-6):
        raise RuntimeError("dline: the delayed waveform misses its gates")
    g, r = got["dmix"], ref["dmix"]
    vals = [float(g["vout"][np.argmin(np.abs(g["ts"] - t0))])
            for t0, _ in DMIX_GATES]
    (ring, ti), (rring, rti) = g["trace"], r["trace"]
    k = min(ti, ring.shape[0])
    a, b = ring[:k], rring[:k]
    rel = float((np.abs(a[:, :2] - b[:, :2])
                 / np.abs(b[:, :2]).clip(1e-300)).max())
    viol = float(np.abs(a[:, 4] - b[:, 4]).max())
    same = bool((a[:, [2, 3, 5]] == b[:, [2, 3, 5]]).all())
    print(f"dmix: out {vals} at {[t0 for t0, _ in DMIX_GATES]} s; trace "
          f"rows {ti} card / {rti} CPU, t and h within {rel:.3e} "
          f"relative, iteration / converged / accepted columns equal "
          f"{same}, violation within {viol:.3e} [{card}]", flush=True)
    if not all(abs(v - w) <= 1e-3 for v, (_, w) in zip(vals, DMIX_GATES)):
        raise RuntimeError("dmix: the mixed delay misses its gates")
    if not (ti == rti and same and rel <= 1e-12 and viol <= TRACE_VIOL_TOL):
        raise RuntimeError("dmix: the card's trace parts from the CPU's")
    g, r = got["ac"], ref["ac"]
    w = 2 * np.pi * g["freqs"]
    mag = float(np.abs(np.abs(g["h"]) - 1.0).max())
    phase = float(np.abs(np.angle(g["h"] * np.exp(1j * w * DLINE_TD))).max())
    aerr = float(np.abs(g["h"] - r["h"]).max() / np.abs(r["h"]).max())
    print(f"dline delayed AC, {len(w)} frequencies "
          f"{g['freqs'][0]:.0f}-{g['freqs'][-1]:.0f} Hz: ||H| - 1| "
          f"{mag:.3e}, phase against -wt {phase:.3e} rad, card against CPU "
          f"{aerr:.3e} of max |H|, K1 launches {g['launches']}, wall "
          f"{g['wall'] * 1e3:.1f} ms [{card}]", flush=True)
    if not (g["converged"] and mag <= 1e-6 and phase <= 1e-6
            and aerr <= AC_TOL and g["launches"] == 1):
        raise RuntimeError("dline delayed AC: a gate failed")
    launches["delayed AC sweep (phase 16)"] = g["launches"]
    sim_launches = 0
    for name in SIM_DECKS:
        g, r = got[f"simulate {name}"], ref[f"simulate {name}"]
        errs = {}
        if g["meas"] or r["meas"]:
            if set(g["meas"]) != set(r["meas"]):
                raise RuntimeError(f"simulate {name}: .meas results "
                                   f"{sorted(g['meas'])} / {sorted(r['meas'])}")
            errs["meas"] = max(abs(g["meas"][k] - v) / max(abs(v), 1e-300)
                               for k, v in r["meas"].items())
        if "op" in r:
            if not (g["op_converged"] and r["op_converged"]):
                raise RuntimeError(f"simulate {name}: .op failed")
            errs["op"] = float(np.abs(g["op"] - r["op"]).max()
                               / np.abs(r["op"]).max())
        if "ac" in r:
            errs["ac"] = float(np.abs(g["ac"] - r["ac"]).max()
                               / np.abs(r["ac"]).max())
        if "tran_xs" in r:
            if g["tran_counts"] != r["tran_counts"] or not (
                    g["tran_converged"] and r["tran_converged"]):
                raise RuntimeError(f"simulate {name}: .tran counts "
                                   f"{g['tran_counts']} / {r['tran_counts']}")
            errs["tran"] = float(np.abs(g["tran_xs"] - r["tran_xs"]).max()
                                 / np.abs(r["tran_xs"]).max())
        print(f"simulate() {name} deck on the card: wall {g['wall']:.3f} s, "
              f"K1 launches {g['launches']}; card against CPU, relative: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + (f"; .meas {g['meas']}" if g["meas"] else "")
              + f" [{card}]", flush=True)
        if not all(v <= CPU_TOL for v in errs.values()) or not g["launches"]:
            raise RuntimeError(f"simulate {name}: card against CPU off")
        sim_launches += g["launches"]
    vout = got["simulate bsource"]["op_out"]
    print(f"B-source deck (bsq out 0 v={{v(in)*v(in) + 1}}, v(in) = 2 V): "
          f"out {vout!r} V on the card", flush=True)
    if not abs(vout - 5.0) <= 5.0 * 1e-8:
        raise RuntimeError(f"B-source deck: out {vout} V, want 5 V")
    launches["simulate() decks (phase 16)"] = sim_launches
    return dict(launches=launches)



#: phase 17: the Spectre dialect. The decks of tests/test_spectre.py, each
#: given a `dc` statement where it had none so that simulate() runs it
#: (`{lib}` is the path of SPECTRE_LIB written to a temporary directory),
#: and per deck the JAX test's expectation: a node and its value at each
#: analysis point (within 1e-9 relative), or a gate of its own
SPECTRE_LIB = """
library mylib
section tt
parameters rv=1K
endsection
section ss
parameters rv=3K
endsection
endlibrary
"""
SPECTRE_DECKS = {
    "divider": """
simulator lang=spectre
v1 (in 0) vsource dc=5
r1 (in out) resistor r=1K
r2 (out 0) resistor r=1K
o1 dc
""",
    "parameters and subckt": """
simulator lang=spectre
parameters rr=2K vv=6
subckt halver (a b)
  parameters r0=1K
  rt (a mid) resistor r=r0
  rb (mid b) resistor r=r0
ends halver
v1 (in 0) vsource dc=vv
x1 (in 0) halver r0=rr
o1 dc
""",
    "model card": """
simulator lang=spectre
model dmod d is=1e-14
v1 (in 0) vsource dc=5
r1 (in a) resistor r=1K
d1 (a 0) dmod
o1 dc
""",
    "controlled sources": """
simulator lang=spectre
v1 (in 0) vsource dc=0.5
e1 (out 0 in 0) vcvs gain=4
rl (out 0) resistor r=1K
o1 dc
""",
    "if/else": """
simulator lang=spectre
parameters mode=2
v1 (in 0) vsource dc=6
if (mode == 1) {
  r1 (in out) resistor r=1K
  r2 (out 0) resistor r=1K
} else if (mode == 2) {
  r1 (in out) resistor r=2K
  r2 (out 0) resistor r=1K
} else {
  r1 (in out) resistor r=5K
  r2 (out 0) resistor r=1K
}
o1 dc
""",
    "user function": """
simulator lang=spectre
real rpar(real a, real b) {
    return a*b/(a+b);
}
parameters rload=rpar(2K, 2K)
v1 (in 0) vsource dc=3
r1 (in out) resistor r=1K
r2 (out 0) resistor r=rload
o1 dc
""",
    "library sections": """
simulator lang=spectre
include "{lib}" section=ss
v1 (in 0) vsource dc=4
r1 (in out) resistor r=rv
r2 (out 0) resistor r=1K
o1 dc
""",
    "string parameters, no-op statements": """
simulator lang=spectre
myopts options reltol=1e-4 rawfmt="psfbin"
c1 check windows=yes
s1 set dc=1
sh shell cmd="ls"
v1 (in 0) vsource dc=2
r1 (in 0) resistor r=1K
o1 dc
""",
    "vector PWL tran": """
simulator lang=spectre
v1 (in 0) vsource type=pwl wave=[0 0 1m 1 2m 1]
r1 (in out) resistor r=1
tr tran stop=2m step=10u
""",
    "inline subckt": """
simulator lang=spectre
inline subckt pair (a b)
  ra (a m) resistor r=1K
  rb (m b) resistor r=1K
ends pair
v1 (in 0) vsource dc=2
x1 (in 0) pair
o1 dc
""",
    "device-parameter sweep": """
simulator lang=spectre
v1 (in 0) vsource dc=6
r1 (in out) resistor r=2K
r2 (out 0) resistor r=1K
sw sweep dev=r1 param=r values=[1K 2K 5K] {
  o1 dc
}
""",
    "netlist-parameter sweep": """
simulator lang=spectre
parameters rtop=1K
v1 (in 0) vsource dc=4
r1 (in out) resistor r=rtop
r2 (out 0) resistor r=1K
sw sweep param=rtop start=1K stop=3K step=1K {
  o1 dc
}
""",
    "montecarlo": """
simulator lang=spectre
parameters rv=agauss(1K, 100, 1)
v1 (in 0) vsource dc=2
r1 (in out) resistor r=rv
r2 (out 0) resistor r=1K
mc montecarlo numruns=8 seed=7 {
  o1 dc
}
"""}
SPECTRE_WANT = {
    "divider": ("out", [2.5]),
    "parameters and subckt": ("x1.mid", [3.0]),
    "controlled sources": ("out", [2.0]),
    "if/else": ("out", [2.0]),
    "user function": ("out", [1.5]),
    "library sections": ("out", [1.0]),
    "string parameters, no-op statements": ("in", [2.0]),
    "inline subckt": ("x1.m", [1.0]),
    "device-parameter sweep": ("out", [3.0, 2.0, 1.0]),
    "netlist-parameter sweep": ("out", [2.0, 4.0 / 3.0, 1.0])}
#: the Verilog-A export: a network of R, C, V, E and G written by
#: to_veriloga with ports (in, out), driven and loaded outside the module,
#: against the same elements built in; AC over 801 frequencies
VA_EXPORT_FREQS = (100, 1e2, 1e10)


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def spectre_dff(device):
    """The DFF written by to_spectre, parsed back on `device`: the text,
    the dialect the parser sniffed, summary() and op_table() of its
    operating point (host text), the circuit and the operating point."""
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.frontend.elaborate import elaborate_netlist
    from cadnip_tpu_torch.frontend.writer import to_spectre
    text = to_spectre(ct.parse_spice(ct.dff_netlist(), compile=False))
    cc = ct.parse_spice(text, device=device)
    op = ct.dc(cc)
    return dict(text=text, dialect=elaborate_netlist(text)[1].dialect,
                summary=ct.summary(cc), op_table=ct.op_table(op), cc=cc,
                op=op)


def _analysis_points(res):
    """Every analysis point of a simulate() result in order (a container's
    runs unrolled), as host numpy."""
    pts = []
    rows = []
    for kind, sol in res["all"]:
        if kind in ("sweep", "montecarlo"):
            rows += [(k, s) for run in sol["runs"] for k, s in run.items()]
        else:
            rows.append((kind, sol))
    for kind, sol in rows:
        pt = dict(kind=kind, names=dict(sol.cc.names),
                  converged=bool(sol.converged),
                  device=sol.cc.device.type)
        if kind == "tran":
            pt.update(ts=np.asarray(sol.ts), xs=_host(sol.xs),
                      counts=tuple(int(v) for v in sol.stats[:3]))
        else:
            pt["x"] = _host(sol.x)
        pts.append(pt)
    return pts


def spectre_deck_runs(device):
    """simulate() of every SPECTRE_DECKS deck on `device`: its wall, K1
    launches (0 on the CPU) and analysis points."""
    import tempfile
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "corners.scs")
        with open(lib, "w") as fh:
            fh.write(SPECTRE_LIB)
        for name, deck in SPECTRE_DECKS.items():
            sync()
            gj_solve.launches = 0
            t = time.perf_counter()
            res = ct.simulate(deck.replace("{lib}", lib), device=device)
            sync()
            out[name] = dict(wall=time.perf_counter() - t,
                             launches=gj_solve.launches,
                             points=_analysis_points(res))
    return out


def cpu_spectre():
    """Phase 17's CPU side (a worker): the Spectre DFF's text, summary and
    operating-point table, and the decks."""
    d = spectre_dff("cpu")
    return dict(dff={k: d[k] for k in ("text", "dialect", "summary",
                                       "op_table")},
                decks=spectre_deck_runs("cpu"))


def spectre_gate(name, pts):
    """The JAX test's expectation for one deck (tests/test_spectre.py):
    (the gated values, whether they pass)."""
    def val(pt, node):
        return float(pt["x"][pt["names"][node]])

    if name == "vector PWL tran":
        pt = pts[0]
        out = pt["xs"][:, pt["names"]["out"]]
        got = [float(out[np.argmin(np.abs(pt["ts"] - 0.5e-3))]),
               float(out[-1])]
        return got, abs(got[0] - 0.5) <= 0.02 and abs(got[1] - 1.0) <= 1e-6
    if name == "montecarlo":
        outs = np.array([val(pt, "out") for pt in pts])
        got = [len(outs), float(outs.mean()), float(outs.std())]
        return got, len(outs) == 8 and got[2] > 1e-3 and \
            abs(got[1] - 1.0) < 0.2
    if name == "model card":
        got = [val(pts[0], "a")]
        return got, 0.5 < got[0] < 0.8
    node, want = SPECTRE_WANT[name]
    got = [val(pt, node) for pt in pts]
    return got, len(got) == len(want) and all(
        abs(g - w) <= 1e-9 * abs(w) for g, w in zip(got, want))


def spectre_phase(card, job):
    """Phase 17: the Spectre dialect on the card.

    1. The DFF written by to_spectre (text equal to the CPU worker's),
       sniffed as Spectre by parse_spice on "cuda": its summary() and
       op_table() equal to the CPU's, then tran() over 0-300 ns
       (SPECTRE_DFF_SPAN) at phase 4's settings and step limit (DFF_DTMAX)
       within the golden's bar (RMSE_TOL) on its rows up to 300 ns, with K1
       launches at least its Newton iterations, its counts printed (the
       two circuits differ by an ulp in five parameters), and
       TranSolution.save / load of it.
    2. simulate() of SPECTRE_DECKS on the card against the CPU port (the
       worker's): DC within CPU_TOL relative, transients at equal step
       counts within CPU_TOL V, every sweep and Monte Carlo point (each
       point's circuit compiled on the card), the JAX tests' expectations,
       and K1 launches at least one per analysis point.
    3. A network exported by to_veriloga and compiled by compile_va,
       against the same elements built in: DC within CPU_TOL of max |x|,
       AC over 801 frequencies in exactly one K1 launch within AC_TOL of
       max |H|."""
    import tempfile
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.ops.gj_solve import gj_solve

    launches = {}
    d = spectre_dff("cuda")
    t = time.perf_counter()
    ref = job.result()
    print(f"phase 17's CPU side read after a wait of "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    r = ref["dff"]
    same = {k: d[k] == r[k] for k in ("text", "summary", "op_table")}
    print(f"Spectre DFF: to_spectre text {len(d['text'])} characters, "
          f"sniffed as {d['dialect']!r}; equal to the CPU's: {same}\n"
          f"{d['summary']}\n{d['op_table']}", flush=True)
    if not (all(same.values()) and d["dialect"] == r["dialect"]
            == "spectre" and bool(d["op"].converged)):
        raise RuntimeError(f"Spectre DFF: text, dialect or operating point "
                           f"parts from the CPU's {same}")
    cc = d["cc"]
    torch.cuda.synchronize()
    gj_solve.launches = 0
    t = time.perf_counter()
    sol = ct.tran(cc, (0, SPECTRE_DFF_SPAN), dt=3.333e-10, dtmax=DFF_DTMAX,
                  max_steps=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k1 = gj_solve.launches
    counts = tuple(int(v) for v in sol.stats[:3])
    passes = counts[2] + int(sol.op_iters)
    rmse = golden_rmse(sol, "dff", "q", scale=5.0, upto=SPECTRE_DFF_SPAN)
    line = (f"Spectre DFF tran() 0-{SPECTRE_DFF_SPAN * 1e9:g} ns on the "
            f"card: wall {wall:.3f} s, accepted, rejected, newton {counts} + "
            f"DC {int(sol.op_iters)}, {wall / passes * 1e3:.2f} ms per "
            f"Newton pass, K1 launches {k1}, q rel RMSE {rmse:.3e} against "
            f"the golden's rows up to {SPECTRE_DFF_SPAN * 1e9:g} ns [{card}]")
    print(line, flush=True)
    if not (bool(sol.converged) and rmse <= RMSE_TOL):
        raise RuntimeError(f"{line}: misses the golden's bar {RMSE_TOL}")
    if k1 < passes:
        raise RuntimeError(f"{line}: fewer K1 launches than Newton passes")
    launches["Spectre DFF tran (phase 17)"] = k1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dff.npz")
        sol.save(path)
        ts, waves = ct.TranSolution.load(path)
    names = sorted(cc.names, key=cc.names.get)
    xs = _host(sol.xs)
    if not (np.array_equal(ts, np.asarray(sol.ts)) and list(waves) == names
            and all(np.array_equal(waves[nm], xs[..., cc.names[nm]])
                    for nm in names)):
        raise RuntimeError("Spectre DFF: TranSolution.load gives other "
                           "arrays or names than were saved")
    print(f"Spectre DFF TranSolution.save / load: {len(ts)} rows x "
          f"{len(names)} names, equal", flush=True)

    got = spectre_deck_runs("cuda")
    deck_launches = 0
    for name, g in got.items():
        rr = ref["decks"][name]
        gp, rp = g["points"], rr["points"]
        errs = []
        if len(gp) != len(rp) or not gp:
            raise RuntimeError(f"Spectre deck {name}: {len(gp)} analysis "
                               f"points on the card, {len(rp)} on the CPU")
        for a, b in zip(gp, rp):
            if not (a["kind"] == b["kind"] and a["names"] == b["names"]
                    and a["converged"] and b["converged"]
                    and a["device"] == "cuda"):
                raise RuntimeError(f"Spectre deck {name}: a point failed, "
                                   f"ran off the card or parts in kind")
            if a["kind"] == "tran":
                if a["counts"] != b["counts"]:
                    raise RuntimeError(f"Spectre deck {name}: counts "
                                       f"{a['counts']} / {b['counts']}")
                errs.append(float(np.abs(a["xs"] - b["xs"]).max()))
            else:
                errs.append(float(np.abs(a["x"] - b["x"]).max()
                                  / np.abs(b["x"]).max()))
        vals, ok = spectre_gate(name, gp)
        print(f"Spectre deck {name!r} through simulate() on the card: wall "
              f"{g['wall']:.3f} s, {len(gp)} analysis points, K1 launches "
              f"{g['launches']}, card against CPU at most {max(errs):.3e} "
              f"({'V' if gp[0]['kind'] == 'tran' else 'relative'}), "
              f"gated {vals} [{card}]", flush=True)
        if not (max(errs) <= CPU_TOL and ok):
            raise RuntimeError(f"Spectre deck {name}: off the CPU port or "
                               f"the JAX test's expectation")
        if g["launches"] < len(gp):
            raise RuntimeError(f"Spectre deck {name}: fewer K1 launches "
                               f"than analysis points")
        deck_launches += g["launches"]
    launches["Spectre decks through simulate() (phase 17)"] = deck_launches
    launches["to_veriloga export dc + AC (phase 17)"] = va_export(card)
    return dict(launches=launches)


def _export_net(ct, cir):
    """The network phase 17 exports: R, C, V, E and G."""
    cir.V("vb", "b", "0", dc=1.0)
    cir.R("r1", "in", "mid", 1e3)
    cir.R("r2", "b", "mid", 2e3)
    cir.C("c1", "mid", "0", 1e-9)
    cir.add(ct.VCCS, "g1", ("gp", "0", "mid", "0"), gm=1e-3)
    cir.R("rg", "gp", "0", 1e3)
    cir.C("cg", "gp", "0", 1e-10)
    cir.add(ct.VCVS, "e1", ("out", "0", "gp", "0"), gain=2.0)
    return cir


def va_export(card):
    """Phase 17's Verilog-A export: the network written by to_veriloga
    (ports in and out), compiled by compile_va and instantiated between a
    driven source and a load on the card, against the same elements built
    in: DC within CPU_TOL of max |x|, AC within AC_TOL of max |H| in one
    K1 launch. Returns the export's K1 launches (dc + AC)."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.frontend.writer import to_veriloga
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    va = to_veriloga(_export_net(ct, ct.Circuit("rcnet")),
                     module_name="rcnet", ports=["in", "out"])
    model = ct.compile_va(va)["rcnet"]
    ccs = {}
    for what in ("export", "built in"):
        cir = ct.Circuit(f"{what}")
        cir.V("v1", "in", "0", dc=1.0, acmag=1.0)
        if what == "export":
            cir.add(model, "x1", ("in", "out"))
        else:
            _export_net(ct, cir)
        cir.R("rl", "out", "0", 1e3)
        ccs[what] = cir.compile(device="cuda")
    freqs = ct.acdec(*VA_EXPORT_FREQS)
    res = {}
    for what, cc in ccs.items():
        torch.cuda.synchronize()
        gj_solve.launches = 0
        op = ct.dc(cc)
        torch.cuda.synchronize()
        dc_launches = gj_solve.launches
        gj_solve.launches = 0
        h = ct.ac(cc, freqs, op_x=op.x)["out"]
        torch.cuda.synchronize()
        res[what] = dict(op=op, h=h, dc_launches=dc_launches,
                         ac_launches=gj_solve.launches)
    e, b = res["export"], res["built in"]
    nodes = {"in": "in", "out": "out", "x1#mid": "mid", "x1#gp": "gp",
             "x1#b": "b"}
    xe = np.array([float(e["op"][k]) for k in nodes])
    xb = np.array([float(b["op"][v]) for v in nodes.values()])
    dc_err = float(np.abs(xe - xb).max() / np.abs(xb).max())
    ac_err = float(np.abs(e["h"] - b["h"]).max() / np.abs(b["h"]).max())
    print(f"to_veriloga export ({len(va.splitlines())} lines, module rcnet,"
          f" {len(ccs['export'].names)} unknowns) on the card: DC against "
          f"the built-in elements {dc_err:.3e} of max |x| (out "
          f"{xe[1]:.6g} V), AC over {len(freqs)} frequencies {ac_err:.3e} of "
          f"max |H|, K1 launches dc {e['dc_launches']} + AC "
          f"{e['ac_launches']} [{card}]", flush=True)
    if not (bool(e["op"].converged) and bool(b["op"].converged)
            and dc_err <= CPU_TOL and ac_err <= AC_TOL):
        raise RuntimeError("to_veriloga export: off the built-in circuit")
    if e["ac_launches"] != 1 or e["dc_launches"] < 1:
        raise RuntimeError(f"to_veriloga export: {e['ac_launches']} K1 "
                           f"launches for the AC sweep, want 1")
    return e["dc_launches"] + e["ac_launches"]


#: phase 18: the JAX package's accelerator solve methods on the card:
#: "gjpl32ir" (K1 in f32 on the equilibrated matrix, one launch per
#: factorization for its inverse, then two f64 refinement steps per solve)
#: and "lu32ir" (torch.linalg's f32 LU of it, the same refinement). The
#: DFF's q on the card against the CPU port under gjpl32ir at equal counts
#: (V): the test file holds the CPU port to the JAX package at 7.4e-15 V
MIXED_CPU_TOL = 1e-9 * 5.0
#: the power grid under gjpl32ir against phase 15's gauss run, node
#: voltages: at equal counts, else at the BBD-against-dense bar
PG_MIXED_SAME_TOL, PG_MIXED_TOL = 1e-8, 1e-3


def _full_fp32():
    """The f32 products of the mixed-precision methods run at full FP32:
    TF32 off, as torch's defaults have it."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    if tf32 or prec != "highest":
        raise RuntimeError(f"f32 matmuls not at full FP32: allow_tf32 "
                           f"{tf32}, float32 matmul precision {prec!r}")
    return f"TF32 off (allow_tf32 {tf32}, precision {prec!r})"


def _k1_window(fn):
    """fn() on the card with K1's counts set to 0 just before: (its
    result, K1 launches, of them in f32, wall seconds)."""
    import torch
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    torch.cuda.synchronize()
    gj_solve.launches = gj_solve.f32_launches = 0
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, gj_solve.launches, gj_solve.f32_launches, \
        time.perf_counter() - t


def mixed_dff(card, phase4):
    """Phase 18a (in phase 13b's process): the DFF through
    tran(method="gjpl32ir") over 0-600 ns at phase 4's settings, gated on
    phase 4's counts, the golden's bar and at least one f32 K1 launch per
    transient Newton pass (the operating point takes the default chain,
    K1 in f64), its wall and ms per pass beside phase 4's; then
    tran(method="lu32ir") over 0-100 ns at phase 4's step limit, gated on
    the golden's rows up to 100 ns. The CPU port's gjpl32ir run (worker B)
    is compared in main (mixed_check)."""
    import cadnip_tpu_torch as ct
    fp32 = _full_fp32()
    cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
    sol, k1, f32, wall = _k1_window(lambda: ct.tran(
        cc, (0, 6e-7), dt=3.333e-10, max_steps=100000, method="gjpl32ir"))
    counts = tuple(int(v) for v in sol.stats[:3])
    op_iters = int(sol.op_iters)
    q = sol["q"].cpu().numpy()
    rmse = golden_rmse(sol, "dff", "q", scale=5.0)
    ms = wall / (counts[2] + op_iters) * 1e3
    line = (f"DFF tran(method='gjpl32ir') 0-600 ns on the card: wall "
            f"{wall:.3f} s, {ms:.2f} ms per Newton pass (phase 4's gauss "
            f"run: {phase4['wall']:.3f} s, {phase4['ms']:.2f} ms); accepted, "
            f"rejected, newton {counts} + DC {op_iters}; K1 launches {k1}, "
            f"{f32} of them f32 (the transient's inverses; the operating "
            f"point's K1 runs in f64); q rel RMSE {rmse:.3e} against the "
            f"golden; {fp32} [{card}]")
    print(line, flush=True)
    if not (bool(sol.converged) and np.isfinite(q).all()
            and counts == DFF_TRAN_COUNTS and op_iters == DFF_DC_ITERS
            and rmse <= RMSE_TOL):
        raise RuntimeError(f"{line}: want counts {DFF_TRAN_COUNTS} + DC "
                           f"{DFF_DC_ITERS} within {RMSE_TOL:.0e}")
    if f32 < counts[2]:
        raise RuntimeError(f"{line}: fewer f32 K1 launches than Newton "
                           f"passes")
    sol2, k1b, f32b, wall2 = _k1_window(lambda: ct.tran(
        cc, (0, LU32_SPAN), dt=3.333e-10, dtmax=DFF_DTMAX, max_steps=100000,
        method="lu32ir"))
    counts2 = tuple(int(v) for v in sol2.stats[:3])
    rmse2 = golden_rmse(sol2, "dff", "q", scale=5.0, upto=LU32_SPAN)
    line2 = (f"DFF tran(method='lu32ir') 0-{LU32_SPAN * 1e9:g} ns on the "
             f"card: wall {wall2:.3f} s, accepted, rejected, newton "
             f"{counts2} + DC {int(sol2.op_iters)}; K1 launches {k1b} (the "
             f"operating point's; the transient's factorizations are "
             f"torch.linalg's f32 LU), f32 {f32b}; q rel RMSE {rmse2:.3e} "
             f"against the golden's rows up to {LU32_SPAN * 1e9:g} ns "
             f"[{card}]")
    print(line2, flush=True)
    if not (bool(sol2.converged) and rmse2 <= RMSE_TOL and f32b == 0):
        raise RuntimeError(f"{line2}: misses the golden's bar {RMSE_TOL}")
    return dict(counts=counts, op_iters=op_iters, q=q, wall=wall, ms=ms,
                launches=k1, f32=f32, rmse=rmse,
                lu32=dict(counts=counts2, wall=wall2, rmse=rmse2,
                          launches=k1b))


def cpu_mixed_dff():
    """Phase 18a's CPU side (worker B): the CPU port's DFF through
    tran(method="gjpl32ir") over the card's whole span."""
    import cadnip_tpu_torch as ct
    cc = ct.parse_spice(ct.dff_netlist(), device="cpu")
    t = time.perf_counter()
    sol = ct.tran(cc, (0, 6e-7), dt=3.333e-10, max_steps=100000,
                  method="gjpl32ir")
    return dict(counts=tuple(int(v) for v in sol.stats[:3]),
                op_iters=int(sol.op_iters), q=sol["q"].numpy(),
                wall=time.perf_counter() - t)


def mixed_check(card, mixed, job):
    """Phase 18a's comparison (main, after phase 13b's process): the
    card's gjpl32ir DFF against the CPU port's, equal counts and
    MIXED_CPU_TOL on q."""
    t = time.perf_counter()
    ref = job.result()
    waited = time.perf_counter() - t
    got = (mixed["counts"], mixed["op_iters"])
    want = (ref["counts"], ref["op_iters"])
    err = float(np.abs(mixed["q"] - ref["q"]).max())
    line = (f"DFF gjpl32ir, card against the CPU port (worker B, "
            f"{ref['wall']:.1f} s there, read after a wait of {waited:.3f} "
            f"s): counts + DC {got} / {want}, max |dq| {err:.3e} V (bar "
            f"{MIXED_CPU_TOL:.0e}) [{card}]")
    print(line, flush=True)
    if got != want or not err <= MIXED_CPU_TOL:
        raise RuntimeError(line)
    return err


def mixed_ac_noise(card, ac):
    """Phase 18c: the DFF's supply rejection and output noise through
    make_ac_sweep / make_noise_sweep(method="gjpl32ir") over the 801
    frequencies, each one f32 K1 launch of [801, 38, 76] (the inverses of
    the equilibrated 2n forms), against phase 8c's gauss runs on the card:
    AC_TOL of max |H|, AC_TOL relative on both PSDs."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.analyses.ac import make_ac_sweep
    from cadnip_tpu_torch.analyses.noise import make_noise_sweep
    from cadnip_tpu_torch.mna.spec import MODE_AC
    fp32 = _full_fp32()
    cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
    op = ct.dc(cc)
    freqs = ct.acdec(*AC_FREQS)
    om = torch.as_tensor(2 * np.pi * freqs, dtype=torch.float64,
                         device="cuda")
    dyn = cc.spec.dyn("cuda", mode=MODE_AC)
    iq = cc.index_of("q")
    p = cc.alter(cc.params0(), **{"vvdd.acmag": 1.0})
    sweep = make_ac_sweep(cc, "gjpl32ir")
    (xr, xi), k1, f32, wall = _k1_window(lambda: sweep(op.x, p, dyn, om))
    h = (xr[:, iq] + 1j * xi[:, iq]).cpu().numpy()
    ref = ac["DFF PSRR (ac, q / vvdd)"]["y"][0]
    err = float(np.abs(h - ref).max() / np.abs(ref).max())
    print(f"DFF PSRR through make_ac_sweep(method='gjpl32ir'), {len(freqs)} "
          f"frequencies: K1 launches {k1} ({f32} f32), wall "
          f"{wall * 1e3:.1f} ms; against phase 8c's gauss run {err:.3e} of "
          f"max |H| (bar {AC_TOL:.0e}); {fp32} [{card}]", flush=True)
    if not (k1 == f32 == 1 and err <= AC_TOL and np.isfinite(h).all()):
        raise RuntimeError(f"DFF PSRR gjpl32ir: {k1} launches ({f32} f32), "
                           f"{err:.3e} from gauss")
    e_out = torch.zeros(cc.n, dtype=torch.float64, device="cuda")
    e_out[iq] = 1.0
    gi, slot = cc.inst_group["vvdd"]
    grp = cc.groups[gi]
    b = np.zeros(cc.n + 1)
    for local, sign in grp.model.ac_rhs:
        b[grp.conn[slot, local]] += sign
    b_in = torch.as_tensor(b[:cc.n], dtype=torch.float64, device="cuda")
    nsweep, _ = make_noise_sweep(cc, "gjpl32ir")
    (on, inn, _), k1n, f32n, walln = _k1_window(
        lambda: nsweep(op.x, cc.params0(), dyn, om, e_out, b_in))
    ys = (on.cpu().numpy(), inn.cpu().numpy())
    refn = ac["DFF output noise (noise, q, input vvdd)"]["y"]
    errn = max(float((np.abs(a - c) / np.abs(c)).max())
               for a, c in zip(ys, refn))
    print(f"DFF output noise through make_noise_sweep(method='gjpl32ir'): "
          f"K1 launches {k1n} ({f32n} f32), wall {walln * 1e3:.1f} ms; "
          f"against phase 8c's gauss run {errn:.3e} relative on the output "
          f"and input-referred PSDs (bar {AC_TOL:.0e}) [{card}]", flush=True)
    if not (k1n == f32n == 1 and errn <= AC_TOL
            and all(np.isfinite(y).all() for y in ys)):
        raise RuntimeError(f"DFF noise gjpl32ir: {k1n} launches ({f32n} "
                           f"f32), {errn:.3e} from gauss")
    return dict(launches=k1 + k1n, err=err, errn=errn)


def mixed_power_grid(card, pg):
    """Phase 18d: phase 15's power grid through tran(method="gjpl32ir")
    over 0-3 ns: per transient Newton iteration two f32 K1 launches, the
    block inverses [159, 32, 64] (warp) and the Schur inverse [1, 973,
    1946] (grid); the operating point takes the default chain (K1 in
    f64). Node voltages against phase 15's gauss run within
    PG_MIXED_SAME_TOL at equal counts, else PG_MIXED_TOL."""
    import cadnip_tpu_torch as ct
    _full_fp32()
    cc = ct.parse_spice(power_grid_netlist(), device="cuda")
    per_it = 3 if cc.bbd_nested is not None else 2
    sol, k1, f32, wall = _k1_window(lambda: ct.tran(
        cc, (0, PG_SPAN), dt=PG_DT, method="gjpl32ir"))
    counts = tuple(int(v) for v in sol.stats[:3])
    op_it = int(sol.op_iters)
    xs = sol.xs.cpu().numpy()
    same = (counts == pg["tran"]["counts"]
            and op_it == pg["tran"]["op_iters"])
    err = float(np.abs(xs - pg["xs"])[:, pg["is_v"]].max())
    tol = PG_MIXED_SAME_TOL if same else PG_MIXED_TOL
    ms = wall / max(counts[2] + op_it, 1) * 1e3
    line = (f"power grid tran(method='gjpl32ir') 0-{PG_SPAN * 1e9:g} ns: "
            f"accepted, rejected, newton {counts} + DC {op_it} (phase 15's "
            f"gauss: {pg['tran']['counts']} + DC {pg['tran']['op_iters']}); "
            f"K1 launches {k1}, {f32} of them f32 ({per_it} per transient "
            f"Newton iteration); wall {wall:.3f} s, {ms:.1f} ms per Newton "
            f"iteration (gauss: {pg['newton_ms']:.1f} ms); node voltages "
            f"against the gauss run {err:.3e} V (bar {tol:.0e}: counts "
            f"{'equal' if same else 'differ'}) [{card}]")
    print(line, flush=True)
    if not (bool(sol.converged) and np.isfinite(xs).all()):
        raise RuntimeError(f"{line}: failed")
    if f32 != per_it * counts[2] or k1 != per_it * (counts[2] + op_it):
        raise RuntimeError(f"{line}: K1 launches off the per-iteration "
                           f"count")
    if not err <= tol:
        raise RuntimeError(line)
    return dict(launches=k1, f32=f32, counts=counts, same=same, err=err,
                ms=ms)


def _batch_witness(card, cc, shards):
    """Where the sharded lanes part from the local ones in the last bits:
    the transient's batched operations outside the DC chain (which is
    bit-equal) evaluated at the Monte Carlo's shapes on the whole batch and
    on its shards, bit-equality printed: the charge correction's batched
    matrix-vector product (the dense `matvec`), and K1 and the residual
    assembly's sorted-scatter sum for comparison."""
    import torch
    from cadnip_tpu_torch.mna.assemble import make_assembler, pad_state
    from cadnip_tpu_torch.ops.gj_solve import gj_solve
    g = torch.Generator(device="cuda").manual_seed(0)
    n, B = cc.n, MESH_LANES
    M = torch.randn((B, n, n), dtype=torch.float64, device="cuda",
                    generator=g)
    v = torch.randn((B, n), dtype=torch.float64, device="cuda", generator=g)
    parts = [slice(i * B // shards, (i + 1) * B // shards)
             for i in range(shards)]

    def split_equal(fn, *args):
        whole = fn(*args)
        return all(torch.equal(whole[p], fn(*(a[p] for a in args)))
                   for p in parts)

    asm = make_assembler(cc)
    xp = pad_state(3.3 * torch.rand((B, n), dtype=torch.float64,
                                    device="cuda", generator=g))
    p0 = cc.params0()
    res = {"matvec (M @ v[..., None])": split_equal(
               lambda a, b: (a @ b[..., None])[..., 0], M, v),
           "K1 [B, n, n + 1]": split_equal(
               lambda a, b: gj_solve(a + 4 * torch.eye(n, device="cuda",
                                                       dtype=a.dtype), b),
               M, v),
           "assembly F (sorted scatter)": split_equal(
               lambda x: asm(x, asm.init_lim(x), p0,
                             cc.spec.dyn("cuda"))[0], xp)}
    print(f"mesh: the transient's batched operations, {B} lanes against "
          f"{shards} shards, bit-equal: {res} [{card}]", flush=True)


def mesh_phase(card):
    """Phase 18e: the sweep mesh on the one card. tests/test_sharded_dff.py's
    workload at full width (MESH_LANES lanes, MC_SPREADS, seed MESH_SEED,
    0-100 ns) through sharded_transweep over MESH_SHARDS shards of
    "cuda:0" against the local transweep: every lane's counts equal and
    its waveform within MC_TOL x 5 V (bit-equality printed), all finite,
    max q after 90 ns < 0.5 (the JAX test's gates); then sharded_dcsweep
    of the same table against the plain DC chain on the whole table.
    Overlap across cards is not measured: the machine has one."""
    import torch
    import cadnip_tpu_torch as ct
    from cadnip_tpu_torch.analyses.dc import _get_dc_solver
    from cadnip_tpu_torch.analyses.sweeps import batch_params
    from cadnip_tpu_torch.parallel.mesh import (sharded_dcsweep,
                                                sharded_transweep,
                                                sweep_mesh)
    cc = ct.parse_spice(ct.dff_netlist(), device="cuda")
    tab = ct.montecarlo_table(cc, MC_SPREADS, MESH_LANES, seed=MESH_SEED)
    mesh = sweep_mesh(("cuda:0",) * MESH_SHARDS)
    span = (0, MESH_SPAN)
    loc, k1l, _, wl = _k1_window(lambda: ct.transweep(cc, tab, span,
                                                      **MESH_KW))
    sh, k1s, _, ws = _k1_window(lambda: sharded_transweep(
        cc, tab, span, mesh=mesh, **MESH_KW))
    same_counts = all(torch.equal(getattr(sh.stats, f),
                                  getattr(loc.stats, f))
                      for f in ("naccept", "nreject", "nnewton", "fail"))
    bit = torch.equal(sh.xs, loc.xs)
    err = float((sh.xs - loc.xs).abs().max())
    q = sh["q"].cpu().numpy()
    ql = loc["q"].cpu().numpy()
    late = np.asarray(sh.ts) > 9e-8
    qmax = max(float(q[:, late].max()), float(ql[:, late].max()))
    finite = bool(torch.isfinite(sh.xs).all() and torch.isfinite(loc.xs)
                  .all())
    line = (f"mesh: sharded_transweep of {MESH_LANES} DFF lanes over "
            f"{len(mesh)} shards on {mesh[0]} (torch.cuda.device_count() "
            f"{torch.cuda.device_count()}) against the local transweep, "
            f"0-{MESH_SPAN * 1e9:g} ns: wall {ws:.3f} s sharded, {wl:.3f} s "
            f"local; K1 launches {k1s} / {k1l}; counts equal per lane "
            f"{same_counts}; bit-equal {bit}, max |dx| {err:.3e} V (bar "
            f"{MC_TOL * 5.0:.0e}); all finite {finite}; max q after 90 ns "
            f"{qmax:.3e} V (gate 0.5); overlap across cards is not measured "
            f"(one card) [{card}]")
    print(line, flush=True)
    if not (sh.xs.shape == loc.xs.shape and same_counts and finite
            and err <= MC_TOL * 5.0 and qmax < 0.5
            and sh.xs.device == loc.xs.device):
        raise RuntimeError(line)
    if not bit:
        _batch_witness(card, cc, len(mesh))
    dsol, k1d, _, wd = _k1_window(lambda: sharded_dcsweep(cc, tab,
                                                          mesh=mesh))
    r = _get_dc_solver(cc)(
        torch.zeros((MESH_LANES, cc.n), dtype=torch.float64, device="cuda"),
        batch_params(cc, tab), cc.spec.dyn("cuda"))
    dbit = torch.equal(dsol.x, r.x) and torch.equal(dsol.iters, r.iters)
    derr = float((dsol.x - r.x).abs().max())
    line = (f"mesh: sharded_dcsweep of the same table over {len(mesh)} "
            f"shards: wall {wd:.3f} s, K1 launches {k1d}, converged "
            f"{int(dsol.converged.sum())}/{MESH_LANES}; against the plain DC "
            f"chain on the whole table: iterations equal "
            f"{torch.equal(dsol.iters, r.iters)}, bit-equal {dbit}, max "
            f"|dx| {derr:.3e} V (bar {CPU_TOL:.0e}) [{card}]")
    print(line, flush=True)
    if not (bool(dsol.converged.all()) and torch.equal(dsol.iters, r.iters)
            and derr <= CPU_TOL):
        raise RuntimeError(line)
    return dict(launches=k1l + k1s + k1d, bit=bit, dc_bit=dbit, err=err,
                wall=ws, local_wall=wl)


def main():
    t_start = time.perf_counter()
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
    from cadnip_tpu_torch.models.ekv import compile_ekv
    from cadnip_tpu_torch.va import cuda as va_cuda

    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; host CPUs (os.cpu_count()) "
          f"{os.cpu_count()}", flush=True)
    t = time.perf_counter()
    # phase 12b's K2 library, built with the emitted ekv26 beside K1 and K2
    va_build = threading.Thread(target=nvcc.build, args=(
        ["vmem_tran"], va_cuda.header([va_cuda.emit(compile_ekv())])))
    va_build.start()
    nvcc.build(["gj_solve", "vmem_tran"])
    va_build.join()
    load_k1()
    load_k2()
    print(f"K1 + K2 + K2 with ekv26 build, K1 + K2 load (parallel nvcc) "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    walls = {"build": time.perf_counter() - t}

    def phase(label, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        walls[label] = time.perf_counter() - t
        return res

    cases = phase("3 K1", kernel_cases, card)
    rules = phase("3b K1 rules", k1_derivative_cases, card)
    dff = phase("4 DFF tran", run_dff, card)
    phase("5 K2 device eval", device_eval, card)
    twin = phase("6 K2 vs twin", k2_vs_twin, card)
    k2 = phase("7 DFF vmem_tran", k2_dff, card)
    graetz_k2 = phase("8 graetz", k2_graetz, card)
    dar = phase("8b darlington", k2_darlington, card)
    ac = phase("8c AC + noise", ac_noise, card)
    # from here on, the CPU references run in two worker processes beside
    # the card's host loop, and phases 13 and 13b in processes of their own
    # on the card; they are idle until now, so that the kernel timings and
    # host-bound walls of phases 3-8c see no neighbour. Worker A: phase 9's
    # lanes, phases 11 and 12, then phase 6's twins (queued after phase
    # 12's jobs, so that phase 12 never waits); worker B: phase 8b's
    # reference, phase 8c's ladder and the CPU sides of phases 16, 17 and
    # 18a; phase 13's process has two of its own
    cpu, cpu2, children, done = cpu_worker(), cpu_worker(), [], False
    try:
        dar_job = cpu2.submit(cpu_darlington_ref)
        ladder_job = cpu2.submit(cpu_ladder_ac)
        delay_job = cpu2.submit(cpu_delay_sim)
        spectre_job = cpu2.submit(cpu_spectre)
        mixed_job = cpu2.submit(cpu_mixed_dff)
        t_child = time.perf_counter()
        children.append(start_pit_child("13", graetz_k2, dar))
        children.append(start_pit_child("13b", None, dar, dff["cold"]))
        mc = phase("9 Monte Carlo", dff_montecarlo, card, dff["cold"]["wall"],
                   cpu)
        # queued behind phase 9's lanes, done long before they are read
        deriv_job = cpu.submit(cpu_derivatives)
        ekv_job = cpu.submit(cpu_ekv_tran)
        phase("9b profile", profile_montecarlo, card, mc["tab"], mc["sol"])
        jac_rules = phase("9c K1 rules on Jacobians", k1_dff_jacobian_cases,
                          card, mc["cc"], mc["sol"], mc["tab"])
        phase("10 dcsweep", dc_sweep_rescue, card)
        deriv = phase("11 derivatives", derivatives, card, deriv_job)
        va = phase("12 VA (EKV DFF)", va_ekv, card, ekv_job, cpu)
        twin.update(phase("12b EKV DFF on K2", ekv_k2, card))
        twin_jobs = {name: cpu.submit(cpu_k2_twin, c["net"], c["setup"])
                     for name, c in twin.items() if name not in TWIN_ON_CARD}
        pg = phase("15 BBD power grid", power_grid, card)
        dly = phase("16 delays, B-sources, simulate", delays_simulate, card,
                    delay_job)
        sp = phase("17 Spectre", spectre_phase, card, spectre_job)
        ac18 = phase("18c AC + noise gjpl32ir", mixed_ac_noise, card, ac)
        pg18 = phase("18d power grid gjpl32ir", mixed_power_grid, card, pg)
        mesh = phase("18e mesh", mesh_phase, card)
        main_path = time.perf_counter() - t_child
        res13 = phase("13 (its process: the wait)", join_pit_child,
                      children[0])
        res13b = phase("13b (its process: the wait)", join_pit_child,
                       children[1])
        w13, w13b = (walls[f"{w} (its process: the wait)"]
                     for w in ("13", "13b"))
        print(f"main process's path from phase 13's start to the joins "
              f"{main_path:.1f} s (phase 17 {walls['17 Spectre']:.1f} s, "
              f"phase 18's {sum(v for k, v in walls.items() if k[:2] == '18'):.1f} "
              f"s of it); phase 13's process {main_path + w13:.1f} s to its "
              f"end, phase 13b's {main_path + w13 + w13b:.1f} s at most",
              flush=True)
        lin, pit = res13["lin"], {**res13["pit"], **res13b["pit"]}
        mixed = res13b["mixed"]
        for res in (res13, res13b):
            walls.update({f"{k} (own process)": v
                          for k, v in res["walls"].items()})
        phase("18a check", mixed_check, card, mixed, mixed_job)
        bbd_rows = phase("15 K1 rows", bbd_k1_rows, card, pg)
        phase("14 twins (6, 8b), ladder AC", lambda: (
            twin_check(card, twin, twin_jobs),
            darlington_ref_check(card, dar, dar_job),
            ladder_ac_check(card, ac["ladder"], ladder_job)))
        done = True
    finally:
        for child in children:
            if child[0].is_alive():
                child[0].terminate()
                child[0].join()
        # after a failure nothing waits for a worker's running job: the
        # workers end with this process (_exit_with_parent)
        cpu.shutdown(wait=done, cancel_futures=True)
        cpu2.shutdown(wait=done, cancel_futures=True)
    print("wall per phase (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    k1, k2d = cases["f64 n=19 k=1 b=4096"], twin["dff"]
    k1ac, k1pit, k1grid = cases[AC_DFF_ROW], pit["graetz"]["k1"], \
        cases[GRID_ROW]
    by_path = {"Monte Carlo (phase 9)": mc["launches"], **va["launches"],
               "rc tran_linear (phase 13)": lin["launches"],
               **{f"{name} tran_pit {part} (phase "
                  f"{'13b' if name == 'darlington' else '13'})": r["launches"][k]
                  for name, r in pit.items()
                  for k, part in (("op", "operating point"),
                                  ("seed", "periodic seed"),
                                  ("windows", "windows"))},
               "ladder AC (phase 8c)": ac["ladder"]["launches"],
               "power grid BBD dc + tran (phase 15)": pg["launches"],
               **dly["launches"], **sp["launches"]}
    by_path_f32 = {"DFF tran gjpl32ir (phase 18a)": mixed["f32"],
                   "DFF AC + noise gjpl32ir (phase 18c)": ac18["launches"],
                   "power grid tran gjpl32ir (phase 18d)": pg18["f32"]}
    by_path.update({"DFF tran gjpl32ir (phase 18a)": mixed["launches"],
                    "DFF tran lu32ir, its operating point (phase 18a)":
                        mixed["lu32"]["launches"],
                    "DFF AC + noise gjpl32ir (phase 18c)": ac18["launches"],
                    "power grid tran gjpl32ir (phase 18d)": pg18["launches"],
                    "mesh transweep, sharded_transweep, sharded_dcsweep "
                    "(phase 18e)": mesh["launches"]})
    f32 = cases[next(iter(F32_ROWS))]
    kernels = [{"name": "K1 gj_solve (warp, block and grid variants; jvp, "
                        "vjp)",
                "route": "cuda",
                "source": "cadnip_tpu_torch/ops/csrc/gj_solve.cu",
                "replaces": "cadnip_tpu/ops/pallas_solve.py:35",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
                "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
                "bound_us": k1["bound_ms"] * 1e3,
                "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
                "ac_shape": AC_DFF_ROW, "ac_ms": k1ac["ms"],
                "ac_bound_ms": k1ac["bound_ms"],
                "ac_library_ms": k1ac["library_ms"],
                "pit_shape": k1pit["shape"], "pit_ms": k1pit["ms"],
                "pit_bound_ms": k1pit["bound_ms"],
                "pit_library_ms": k1pit["library_ms"],
                "pit_plain_ms": k1pit["plain_ms"],
                "grid_shape": GRID_ROW, "grid_ms": k1grid["ms"],
                "grid_bound_ms": k1grid["bound_ms"],
                "grid_library_ms": k1grid["library_ms"],
                "grid_plain_ms": k1grid["plain_ms"],
                "ladder_shape": AC_LADDER_ROW,
                "ladder_ms": cases[AC_LADDER_ROW]["ms"],
                "ladder_library_ms": cases[AC_LADDER_ROW]["library_ms"],
                "block_rows": {row: {k: cases[row][k] for k in (
                    "ms", "block_ms", "grid_ms", "library_ms", "plain_ms",
                    "bound_ms", "bound_by", "max_abs_err")}
                    for row in BLOCK_ROWS},
                "bbd": {what: {k: r[k] for k in ("shape", "ms", "bound_ms",
                                                 "library_ms", "plain_ms")}
                        for what, r in bbd_rows.items()},
                "bbd_newton_iteration_ms": pg["newton_ms"],
                "va_export_ac": {k: cases[VA_EXPORT_ROW][k] for k in (
                    "ms", "library_ms", "plain_ms", "bound_ms",
                    "max_abs_err")}},
               {"name": "K1 gj_solve in f32 (the gjpl32ir inverses: warp, "
                        "block and grid variants)",
                "route": "cuda",
                "source": "cadnip_tpu_torch/ops/csrc/gj_solve.cu",
                "replaces": "cadnip_tpu/ops/pallas_solve.py:35",
                "launches": sum(by_path_f32.values()),
                "launches_by_path": by_path_f32,
                "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
                "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "bound_us": f32["bound_ms"] * 1e3,
                "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
                "row": next(iter(F32_ROWS)),
                "rows": {row: {k: cases[row][k] for k in (
                    "ms", "block_ms", "graph_ms", "library_ms", "plain_ms",
                    "bound_ms", "bound_by", "max_abs_err")}
                    for row in F32_ROWS},
                "mixed_dff_ms_per_pass": mixed["ms"],
                "mixed_power_grid_ms_per_iteration": pg18["ms"]},
               {"name": "K1 rules (fused tangent and adjoint entries, "
                        "gj_rule_*; under torch.func)",
                "route": "cuda",
                "source": "cadnip_tpu_torch/ops/csrc/gj_solve.cu",
                "replaces": "cadnip_tpu/ops/pallas_solve.py:35",
                "launches": jac_rules["rule_launches"],
                "max_abs_err": max(r["entry_abs_err"]
                                   for r in rules.values()),
                "ms": rules[RULE_ROW]["ms"],
                "plain_ms": rules[RULE_ROW]["plain_ms"],
                "bound_ms": rules[RULE_ROW]["bound_ms"],
                "bound_us": rules[RULE_ROW]["bound_ms"] * 1e3,
                "bound_by": rules[RULE_ROW]["bound_by"],
                "library_ms": rules[RULE_ROW]["library_ms"],
                "row": RULE_ROW,
                "rows": {row: {k: r[k] for k in (
                    "ms", "library_ms", "plain_ms", "entry_ms",
                    "entry_device_ms", "solve_device_ms", "door_ms",
                    "bound_ms", "max_rel_err", "entry_rel_err")}
                    for row, r in rules.items()},
                "jacfwd_wall_s": deriv["jacfwd_wall"],
                "jacfwd_launches": deriv["jacfwd_launches"],
                "jacfwd_rule_calls": deriv["jacfwd_calls"]},
               {"name": "K2 vmem_tran", "route": "cuda",
                "source": "cadnip_tpu_torch/ops/csrc/vmem_tran.cu",
                "replaces": "archive/pallas_tran.py:372",
                "launches": k2["cold"]["k2"] + dar["launches"],
                "max_abs_err": k2d["max_abs_err"], "ms": k2d["ms"],
                "plain_ms": k2d["plain_ms"], "bound_ms": k2d["bound_ms"],
                "bound_us": k2d["bound_ms"] * 1e3,
                "bound_by": k2d["bound_by"], "library_ms": None,
                "ladder_cycles_per_iteration":
                    twin["ladder"]["cycles_per_iteration"],
                "ladder_solve_cycles_per_pivot":
                    twin["ladder"]["solve_cycles_per_pivot"]}]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        # end at once: the interpreter's exit would wait for the workers'
        # running jobs, which end themselves once this process is gone
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
