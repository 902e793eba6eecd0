"""cadnip_tpu_torch — the PyTorch/CUDA port of the cadnip_tpu circuit
simulator, for NVIDIA Hopper.

It runs the main path of the JAX package `cadnip_tpu`, which stays the
reference: SPICE text -> parse and elaborate -> the built-in devices (R,
C, L, mutual K, V, I, the controlled sources E/G/F/H, the diode with or
without series rs, the BJT, the level-1 MOSFET) -> gather /
torch.func.jacrev / scatter assembly -> dense Gauss-Jordan solve (kernel
K1, hand-written CUDA for sm_90a on a CUDA device) inside Newton -> DC
operating point through the gmin/source homotopy -> adaptive trapezoidal
transient. `vmem_tran` runs the whole transient of a small circuit
(n <= 127) in one launch of kernel K2 instead.

Two fixed-step transients save every step: `tran_linear` runs a linear
circuit as blocked prefix products (K^-1 one K1 launch, the rest f64
matmuls), and `tran_pit` a nonlinear one as windows of W timepoints
Newton-iterated at once, each window iteration one K1 launch over the
window's [W, n, n + 1] systems and a prefix scan:

    sol = tran_linear(parse_spice(RC_NETLIST), (0, 1.0), 1e-6)
    sol = tran_pit(parse_spice(GRAETZ), (0, 1.0), 1e-6, window=8192,
                   windows_per_exec=16)

AC and noise linearize at the operating point and solve every frequency
of the sweep in one K1 launch (the real 2n x 2n embedding of
G + jωC, and its transpose for the noise adjoint).

Sweeps and Monte Carlo run every point as one lane of a batch: a table
{"inst.param": values} (from `Sweep` and its combinators, or
`montecarlo_table`) goes through `dcsweep` or `transweep`, and on a CUDA
circuit each Newton iteration of all lanes is one K1 launch over a grid of
B systems. K1 is differentiable, so `torch.func` transforms run through
`tran` and `dc`; `dc_sensitivity` gives DC sensitivities by the implicit
function theorem with one K1 solve.

A circuit is compiled for the card unless the caller asks for the host
(`device="cpu"`); without a card the default raises:

    cc = parse_spice(dff_netlist())                # on "cuda"
    ref = parse_spice(dff_netlist(), device="cpu")  # the plain twins
    sol = tran(cc, (0, 6e-7), dt=3.333e-10)        # host loop, K1 solves
    sol = vmem_tran(cc, (0, 6e-7), dt=3.333e-10)   # one K2 launch
    tab = montecarlo_table(cc, {"cq.c": 0.1, "mno1.w": 0.1}, 4096, seed=42)
    sol = transweep(cc, tab, (0, 6e-7), dt=3.333e-10, n_save=61)

    # supply rejection and output noise of the DFF over 1 kHz-100 GHz
    p = cc.alter(cc.params0(), **{"vvdd.acmag": 1.0})
    h = ac(cc, acdec(100, 1e3, 1e11), p)["q"]       # complex [801]
    sn = noise(cc, "q", acdec(100, 1e3, 1e11), input="vvdd")
    sn.onoise_psd, sn.inoise_psd, sn.contributions["mno1"]

Verilog-A compact models compile to DeviceModels whose residual
interprets the analog block on torch tensors (`compile_va`,
`load_va_file`; the EKV model in `models/ekv.py`); a netlist loads them
with `.hdl` and instantiates them by N/Y/X lines or `.model` cards:

    ekv = compile_ekv()                             # the inline EKV 2.6
    cir.add(ekv, "m1", ("d", "g", "0", "0"), vto=0.6, vto__given=1.0)
    cc = parse_spice(deck_with_hdl_card)            # `.hdl "ekv26.va"`

Verilog-A `absdelay` runs as a transport delay in `tran` (a history ring
per lane) and `ac` (the exact phase term e^{-jωτ}). Behavioral B-sources
and whole decks run too: `simulate` parses a netlist, runs its .op, .tran,
.ac, .dc (a source sweep or a `.data` table) and .noise cards and then its
`.meas` cards:

    res = simulate(deck)                            # on "cuda"
    res["tran"]["out"], res["meas"]["tdel"]

Spectre decks parse through the same entry points (the dialect is
sniffed), with their analysis statements and `sweep` / `montecarlo`
containers run by `simulate`; the writers turn a Circuit back into text
(`frontend/writer.py`: `to_spice`, `to_spectre`, `to_veriloga`, and the
`python -m cadnip_tpu_torch.convert` CLI); `summary`, `query`, `find` and
`op_table` describe a circuit and its operating point; `explore` opens
matplotlib sliders over a transient; `TranSolution.save` / `load` keep
waveforms in the JAX package's .npz layout:

    from cadnip_tpu_torch.frontend.writer import to_spectre
    cc = parse_spice(to_spectre(parse_spice(dff_netlist(), compile=False)))
    print(summary(cc)); print(op_table(dc(cc)))

This package imports torch and numpy, never jax or cadnip_tpu.
"""
from .mna.structure import Circuit, CompiledCircuit  # noqa: F401
from .mna.spec import SimSpec  # noqa: F401
from .mna import devices  # noqa: F401
from .mna.devices import (  # noqa: F401
    RESISTOR, CAPACITOR, INDUCTOR, VSOURCE, ISOURCE, VCVS, VCCS, CCCS, CCVS,
    DIODE, DIODE_RS, BJT, MOSFET1, MUTUAL, DeviceModel)
from .mna.waveforms import (  # noqa: F401
    DC as DCWave, Pulse, Sin, PWL, Exp, Sffm)
from .analyses.dc import dc, op_tran, DCSolution  # noqa: F401
from .analyses.tran import tran, TranSolution  # noqa: F401
from .analyses.tran_linear import is_linear, tran_linear  # noqa: F401
from .analyses.tran_pit import tran_pit  # noqa: F401
from .analyses.ac import (  # noqa: F401
    ac, acdec, ACSolution, subsystem, DescriptorSISO)
from .analyses.noise import noise, NoiseSolution  # noqa: F401
from .analyses.sweeps import (  # noqa: F401
    Sweep, ProductSweep, TandemSweep, SerialSweep, dcsweep, transweep,
    montecarlo_table)
from .analyses.sensitivity import dc_sensitivity  # noqa: F401
from .ops.vmem_tran import supported, vmem_tran  # noqa: F401
from .frontend.elaborate import (  # noqa: F401
    parse_spice, simulate, circuit_from_file, register_pdk)
from .frontend.netlist import alter_text  # noqa: F401
from .frontend.introspect import find, op_table, query, summary  # noqa: F401
from .frontend.explore import explore, Explorer  # noqa: F401
from .va.codegen import (  # noqa: F401
    VACompileError, compile_va, load_va_file)
from . import models  # noqa: F401
from .models.dff import dff_netlist  # noqa: F401
from .models.ekv import compile_ekv  # noqa: F401

__all__ = [
    "Circuit", "CompiledCircuit", "SimSpec", "DeviceModel", "devices",
    "RESISTOR", "CAPACITOR", "INDUCTOR", "VSOURCE", "ISOURCE", "VCVS",
    "VCCS", "CCCS", "CCVS", "DIODE", "DIODE_RS", "BJT", "MOSFET1", "MUTUAL",
    "DCWave", "Pulse", "Sin", "PWL", "Exp", "Sffm",
    "dc", "op_tran", "DCSolution", "tran", "TranSolution", "vmem_tran",
    "supported", "tran_linear", "is_linear", "tran_pit",
    "ac", "acdec", "ACSolution", "subsystem", "DescriptorSISO",
    "noise", "NoiseSolution",
    "Sweep", "ProductSweep", "TandemSweep", "SerialSweep",
    "dcsweep", "transweep", "montecarlo_table", "dc_sensitivity",
    "parse_spice", "simulate", "circuit_from_file", "register_pdk",
    "alter_text",
    "find", "op_table", "query", "summary", "explore", "Explorer",
    "models", "dff_netlist",
    "compile_va", "load_va_file", "VACompileError", "compile_ekv",
]

__version__ = "0.1.0"
