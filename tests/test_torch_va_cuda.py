"""The Verilog-A -> CUDA emitter (`va/cuda.py`) and K2's path for Verilog-A
models on the CPU: the emitted text, what it refuses, the parameter rows,
the library's key, the twin on the EKV DFF against the benchmark's plain
reference, and K2's chunk-end rows (the twin; the kernel's own in
`tests/test_torch_vmem_tran_va.py` on the card).

The emitted C++ runs only on the card; where g++ is installed, one test
compiles `devices.cuh` with the emitted header for the host (a stub
`cuda_runtime.h`) and holds it against the twin's group evaluation, on
ekv26 and on a module with conditionals.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cadnip_tpu_torch as tct
from cadnip_tpu_torch import obs
from cadnip_tpu_torch.mna.spec import MODE_TRAN, make_dynspec
from cadnip_tpu_torch.models.ekv import EKV_VA, compile_ekv
from cadnip_tpu_torch.ops import nvcc
from cadnip_tpu_torch.ops import vmem_tran as vt
from cadnip_tpu_torch.va import cuda as va_cuda
from cadnip_tpu_torch.va.codegen import compile_va

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cadnip_tpu_torch", "ops", "csrc")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the EKV DFF netlist)
from benchmark.core import check as bench_check  # noqa: E402
from benchmark.core import traffic as bench_tf  # noqa: E402
from benchmark.reference.models import ekv26 as ref_ekv26  # noqa: E402


@pytest.fixture
def ekv_dff(tmp_path):
    va = tmp_path / "ekv26.va"
    va.write_text(EKV_VA)
    return chip_smoke.ekv_dff_netlist(str(va))


def test_emitted_ekv26_is_deterministic():
    """Two compilations of the module emit the same text, so the library
    keyed by it is built once."""
    a, b = va_cuda.emit(compile_ekv()), va_cuda.emit(compile_ekv())
    assert a.body == b.body
    assert va_cuda.header([a]) == va_cuda.header([b])
    assert "struct VaModel0 {" in va_cuda.header([a])
    assert "case 14: eval_instance<VaModel0>" in va_cuda.header([a])


def test_emitted_parameter_order_is_the_compilers():
    m = compile_ekv()
    em = va_cuda.emit(m)
    assert em.params == tuple(m.va_compiler.param_order)
    assert em.n_local == 4 == m.va_compiler.n_local


def test_emitted_ekv26_has_no_noise_terms():
    """The thermal and flicker sources emit nothing: the body reads neither
    kf nor af, and no temperature (only the thermal noise uses it)."""
    em = va_cuda.emit(compile_ekv())
    kf, af = em.params.index("kf"), em.params.index("af")
    code = "\n".join(ln for ln in em.body.splitlines()
                     if not ln.strip().startswith("//"))
    assert f"p[{kf}]" not in code and f"p[{af}]" not in code
    assert "d.temp" not in code and "noise" not in code
    # ddt's charges go to q, the currents to f: f of the gate and bulk rows
    # is 0, q of every row is a charge
    assert "f[1] = T(0.0);" in code and "f[3] = T(0.0);" in code


_REFUSED = {
    "limit": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-15 * (limexp($limit(V(a, c), "pnjlim", $vt, 0.7)
                                   / $vt) - 1.0);
endmodule""", r"\$limit"),
    "absdelay": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * absdelay(V(a, c), 1n);
endmodule""", "absdelay"),
    "idt": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * idt(V(a, c), 0.0);
endmodule""", "idt"),
    "laplace": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * laplace_nd(V(a, c), {1.0}, {1.0, 1e-9});
endmodule""", "laplace"),
    "table_model": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * $table_model(V(a, c), "TABLE");
endmodule""", r"\$table_model"),
    "voltage": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog V(a, c) <+ 0.5;
endmodule""", "voltage contribution"),
    "loop": ("""
module m1(a, c); inout a, c; electrical a, c;
  real s; integer k;
  analog begin
    s = 0.0;
    for (k = 0; k < 3; k = k + 1) s = s + V(a, c);
    I(a, c) <+ 1e-3 * s;
  end
endmodule""", "loop"),
    "ddt_nonlinear": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * exp(ddt(V(a, c)));
endmodule""", "nonlinear"),
    "va_setup": (None, "host setup"),
    # functions and operators that no test holds to the twin
    "sin": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * sin(V(a, c));
endmodule""", "function 'sin'"),
    "transition": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ 1e-3 * transition(V(a, c), 0.0);
endmodule""", "function 'transition'"),
    "modulo": ("""
module m1(a, c); inout a, c; electrical a, c;
  parameter integer k = 7;
  analog I(a, c) <+ 1e-3 * (k % 3) * V(a, c);
endmodule""", "operator '%'"),
    "bitwise": ("""
module m1(a, c); inout a, c; electrical a, c;
  parameter integer k = 7;
  analog I(a, c) <+ 1e-3 * (k & 3) * V(a, c);
endmodule""", "operator '&'"),
    "simparam": ("""
module m1(a, c); inout a, c; electrical a, c;
  analog I(a, c) <+ $simparam("gmin", 1e-12) * V(a, c);
endmodule""", r"\$simparam"),
}


def _setup_heavy_module():
    """A module whose (parameter-only) setup pass has 150 statements: the
    compiler hoists it to the host (`va_setup`)."""
    body = "\n".join(f"    s{k} = {k + 1}.0 * r;" for k in range(150))
    decl = ", ".join(f"s{k}" for k in range(150))
    return f"""
module m1(a, c); inout a, c; electrical a, c;
  parameter real r = 1e3;
  real {decl};
  analog begin
{body}
    I(a, c) <+ V(a, c) / s149;
  end
endmodule"""


@pytest.mark.parametrize("name", list(_REFUSED))
def test_refused_construct_makes_k2_refuse(name, tmp_path):
    src, reason = _REFUSED[name]
    if src is None:
        src = _setup_heavy_module()
    if "TABLE" in src:
        tbl = tmp_path / "t.tbl"
        tbl.write_text("\n".join(f"{v} {v}" for v in np.linspace(-2, 2, 9)))
        src = src.replace("TABLE", str(tbl))
    model = compile_va(src)["m1"]
    assert re.search(reason, va_cuda.refusal(model)), va_cuda.refusal(model)
    with pytest.raises(va_cuda.VACompileError):
        va_cuda.emit(model)
    cir = tct.Circuit("refused")
    cir.V("v1", "a", "0", dc=1.0)
    cir.R("r1", "a", "b", 1e3)
    cir.add(model, "x1", ("b", "0"))
    cc = cir.compile(device="cpu")
    assert not vt.supported(cc)
    with pytest.raises(ValueError, match="not supported"):
        vt.prepare(cc, (0, 1e-9), dt=1e-10)


def test_supported_admits_the_ekv_dff(ekv_dff):
    cc = tct.parse_spice(ekv_dff, device="cpu")
    assert [g.model.name for g in cc.groups] == ["vsource", "va:ekv26",
                                                 "capacitor"]
    assert [g.n_inst for g in cc.groups] == [4, 26, 35] and cc.n == 19
    assert vt.supported(cc)
    assert va_cuda.refusal(cc.groups[1].model) is None


def _ekv_params(rng, I):
    """Seeded card and instance parameters of I ekv26 instances, both
    polarities, as the program's group holds them and as the reference
    takes them."""
    m = compile_ekv()
    p = {k: np.full(I, float(v)) for k, v in m.defaults.items()}
    draws = {"sign": np.where(rng.random(I) < 0.5, 1.0, -1.0),
             "vto": rng.uniform(0.3, 1.0, I), "n": rng.uniform(1.1, 1.6, I),
             "kp": rng.uniform(5e-5, 2e-4, I),
             "lambda": rng.uniform(0.0, 0.1, I),
             "w": rng.uniform(1e-7, 2e-6, I), "l": rng.uniform(3e-7, 1e-6, I),
             "cox": rng.uniform(1e-3, 5e-3, I),
             "cgso": rng.uniform(1e-15, 1e-14, I),
             "cgdo": rng.uniform(1e-15, 1e-14, I)}
    for k, v in draws.items():
        p[k], p[k + "__given"] = v, np.ones(I)
    ref = {k: p[k] for k in ref_ekv26.PARAMS}
    return m, p, ref


def test_ekv26_group_matches_the_plain_reference():
    """The twin's evaluation of an ekv26 group (the Verilog-A interpreter
    under jacrev) against the benchmark's hand-written NumPy ekv26 at
    seeded random bias points and cards: f, q, J and C to 1e-10 of each
    one's largest entry."""
    rng = np.random.default_rng(21)
    I = 64
    m, p, ref_p = _ekv_params(rng, I)
    u = rng.uniform(-1.0, 6.0, (I, 4))
    dyn = make_dynspec(gmin=vt.GMIN, mode=MODE_TRAN, device="cpu")

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    got = vt.eval_group_plain(m, t(u), t(u), {k: t(v) for k, v in p.items()},
                              None, dyn)
    want = ref_ekv26.evaluate(u, ref_p, float(dyn.vt), vt.GMIN)
    for name, a, b in zip("fqJC", got[:4], want):
        a = a.numpy()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max(), name


def test_emitted_rows_are_the_effective_parameters():
    """A row holds each parameter's effective value in the compiler's
    order: the instance's where given, else the module's default."""
    rng = np.random.default_rng(3)
    m, p, _ = _ekv_params(rng, 5)
    p["n__given"] = np.array([0.0, 1.0, 0.0, 1.0, 0.0])
    dyn = make_dynspec(gmin=vt.GMIN, mode=MODE_TRAN, device="cpu")
    rows = va_cuda.emit(m).rows(p, dyn)
    order = m.va_compiler.param_order
    assert rows.shape == (5, len(order))
    n = rows[:, order.index("n")]
    np.testing.assert_array_equal(n, np.where(p["n__given"] > 0, p["n"], 1.3))
    np.testing.assert_array_equal(rows[:, order.index("w")], p["w"])


def test_pack_takes_the_emitted_rows_and_ids(ekv_dff):
    cc = tct.parse_spice(ekv_dff, device="cpu")
    S = vt.prepare(cc, (0, 1e-9), dt=1e-10, x0=torch.zeros(cc.n,
                                                           dtype=torch.float64))
    assert S.va is not None and S.va.lib is None     # no library on the CPU
    model = cc.groups[1].model
    mid, em = S.va.models[model]
    assert mid == va_cuda.FIRST_ID
    pk = vt.pack(S)
    assert pk["gdesc"][1, 0] == mid and pk["gdesc"][1, 3] == len(em.params)
    I = cc.groups[1].n_inst
    off = pk["gdesc"][1, 5]
    rows = pk["par"][off:off + I * len(em.params)].reshape(I, -1)
    np.testing.assert_array_equal(rows, em.rows(cc.groups[1].params,
                                                S.dyn(S.t0)))
    # the timed slot: the first of the group with the most local unknowns,
    # the 26 MOSFETs (104 locals against the capacitors' 70)
    assert pk["timed_slot"] == int(np.flatnonzero(pk["slot_group"] == 1)[0])


def test_timed_slot_is_the_mosfet_group_of_the_level1_dff():
    cc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    S = vt.prepare(cc, (0, 1e-9), dt=1e-10, x0=torch.zeros(cc.n,
                                                           dtype=torch.float64))
    pk = vt.pack(S)
    g = [k for k, gr in enumerate(cc.groups) if gr.model.name == "mos1"][0]
    assert pk["timed_slot"] == int(np.flatnonzero(pk["slot_group"] == g)[0])


def test_group_cycles_slot_matches_the_kernel():
    cu = open(os.path.join(CSRC, "vmem_tran.cu")).read()
    slot = int(re.search(r"GROUP_CYCLES = (\d+);", cu).group(1))
    assert slot == vt._GROUP_CYCLES
    assert vt._PHASE0 + len(vt.PHASES) <= slot < vt._N_STATS
    cuh = open(os.path.join(CSRC, "devices.cuh")).read()
    assert re.search(r"\bBJT = %d\b" % (va_cuda.FIRST_ID - 1), cuh)
    assert int(re.search(r"MAX_NL = (\d+);", cuh).group(1)) == va_cuda.MAX_NL


def test_library_key_follows_the_header():
    """K2's library of a circuit with Verilog-A models is keyed by the
    sources and the generated text; the plain library by the sources."""
    h = va_cuda.header([va_cuda.emit(compile_ekv())])
    plain = nvcc.library_path("vmem_tran")
    a, b = nvcc.library_path("vmem_tran", h), nvcc.library_path(
        "vmem_tran", h)
    assert a == b != plain and a.name.startswith("vmem_tran_va_")
    assert nvcc.library_path("vmem_tran", h + " ") != a


def test_count_adds_a_program_counter_under_the_open_spans():
    with obs.call() as rec:
        with obs.span("integrate"):
            obs.count("group_cycles", 5)
            obs.count("group_cycles", 7)
        obs.count("top", 1)
    assert rec["integrate.group_cycles#n"] == 12 and rec["top#n"] == 1
    obs.count("outside", 3)      # no call open: nothing recorded


#: a module whose analog block takes every path of the emitter that ekv26
#: does not: nested conditionals (a variable assigned in some arms only),
#: `&&`, `||` and `!`, a ternary, ddt under a mask, min/max, sqrt, tanh,
#: pow, ln and exp
BRANCHY = """
module branchy(a, b, c);
  inout a, b, c; electrical a, b, c;
  parameter real g = 1e-3;
  parameter real vk = 0.3;
  parameter real cj = 1e-12;
  real v, i, q;
  analog begin
    v = V(a, b);
    if (v > vk) begin
      i = g * (v - vk) * (v - vk) + g * 1e-3 * v;
      q = cj * v;
    end else if (v < -vk)
      i = -g * sqrt(abs(v + vk)) + g * 1e-3 * v;
    else begin
      i = g * 1e-3 * v;
      q = 0.5 * cj * v;
    end
    I(a, b) <+ i + ddt(q);
    I(b, c) <+ max(V(b, c), 0.1) * g * 0.5 + min(tanh(V(b, c)), 0.5) * 1e-4;
    if (V(c) > 0.2 || V(c) < -0.9)
      I(c) <+ ddt(cj * V(c)) + g * exp(V(c) / $vt - 30);
    if (V(a, b) > -0.5 && !(V(b, c) > 0.5))
      I(a, b) <+ 1e-4 * V(a, b);
    I(a, c) <+ (V(a, c) > 0 ? pow(V(a, c) * V(a, c) + 1, 1.5)
                : ln(1 + V(a, c) * V(a, c))) * 1e-5;
  end
endmodule
"""


@pytest.mark.parametrize("module", ["ekv26", "branchy"])
def test_emitted_code_compiles_for_the_host_and_matches_the_twin(
        tmp_path, module):
    """devices.cuh with the emitted header, compiled for the host CPU by
    g++ (a stub cuda_runtime.h), evaluates the group as the twin does: f,
    q, J, C to 1e-12 of each one's largest entry."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emitted device function for "
                    "the host")
    (tmp_path / "cuda_runtime.h").write_text(
        "#pragma once\n#include <cmath>\nusing std::isnan;\n"
        "using std::isfinite;\n#define __device__\n#define __host__\n"
        "#define __forceinline__ inline\n")
    rng = np.random.default_rng(5)
    I = 32
    if module == "ekv26":
        m = compile_ekv()
        _, p, _ = _ekv_params(rng, I)
        u = rng.uniform(-1.0, 6.0, (I, 4))
    else:
        m = compile_va(BRANCHY)["branchy"]
        p = {k: np.full(I, float(v)) for k, v in m.defaults.items()}
        u = rng.uniform(-1.0, 1.0, (I, 3))
    L = u.shape[1]
    (tmp_path / "va_models.cuh").write_text(
        va_cuda.header([va_cuda.emit(m)]))
    (tmp_path / "harness.cpp").write_text(r"""
#include "devices.cuh"
extern "C" int eval_group(int model, int n, int nl, const double* u,
    const double* par, int npar, double temp, double gmin, double* f,
    double* q, double* J, double* C, double* ue) {
  const dev::Dyn d = dev::make_dyn(temp, gmin, 1.0);
  for (int i = 0; i < n; ++i)
    if (!dev::eval_model(model, u + i * nl, u + i * nl, par + i * npar, 0.0,
                         d, f + i * nl, q + i * nl, J + i * nl * nl,
                         C + i * nl * nl, ue + i * nl)) return 1;
  return 0;
}
""")
    so = tmp_path / "libva.so"
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", str(tmp_path), "-I", CSRC,
                    "-DCADNIP_VA_MODELS", "-o", str(so),
                    str(tmp_path / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    dyn = make_dynspec(gmin=vt.GMIN, mode=MODE_TRAN, device="cpu")
    rows = np.ascontiguousarray(va_cuda.emit(m).rows(p, dyn))
    out = [np.zeros((I, L)), np.zeros((I, L)), np.zeros((I, L, L)),
           np.zeros((I, L, L)), np.zeros((I, L))]
    P = ctypes.c_void_p
    lib.eval_group.argtypes = ([ctypes.c_int] * 3 + [P, P, ctypes.c_int]
                               + [ctypes.c_double] * 2 + [P] * 5)
    assert lib.eval_group(va_cuda.FIRST_ID, I, L, u.ctypes.data, rows.ctypes
                          .data, rows.shape[1], float(dyn.temp),
                          float(dyn.gmin), *[o.ctypes.data for o in out]) == 0

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    want = vt.eval_group_plain(m, t(u), t(u), {k: t(v) for k, v in p.items()},
                               None, dyn)
    for name, a, b in zip("fqJC", out, want):
        b = b.numpy()
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name


def test_twin_on_the_ekv_dff_meets_the_cells_limits(ekv_dff):
    """The twin (K2's algorithm on the CPU) runs the EKV DFF over 0-60 ns
    from its DC operating point, and the benchmark's plain reference holds
    it to the cell `ekv_dff_k2`'s limits: the operating point's KCL under
    the hand-written ekv26, and the waveform against the reference's own
    transient from the same state."""
    wl = bench_tf.load_json("workloads", "ekv_dff_k2")
    cfg = bench_tf.load_json("configs", wl["config"])
    cc = tct.parse_spice(ekv_dff, device="cpu")
    sol = tct.vmem_tran(cc, (0, 6e-8), dt=cfg["dt"])
    assert bool(sol.op_converged) and not bool(sol.stats.fail)
    assert sol.group_cycles is None                  # the twin counts none
    unit = {"text": ekv_dff, "names": dict(cc.names),
            "x0": sol.xs[0].numpy()[None], "final": sol.final.numpy()[None],
            "tstop": 6e-8, "sampled": np.array([0]), "ts": np.asarray(sol.ts),
            "xs": sol.xs.numpy()[None]}
    numbers = bench_check.combine([bench_check.judge(unit, cfg, wl["check"])])
    correct, rows = bench_check.verdict(numbers, wl["check"]["limits"])
    assert correct, rows


#: a PWL corner 0.005 save intervals before the last row of the first chunk
#: (8 rows of 1 us): the step that lands on it ends the chunk inside the
#: 0.01-interval window, short of that row
CHUNK_END = """rc chunk end
v1 in 0 PWL(0 0 6.995u 1 20u 1)
r1 in out 2k
c1 out 0 1n
.end
"""


def test_chunk_end_row_takes_the_accepted_state():
    """The last row of a chunk whose last step stopped 0.005 save intervals
    short of it holds the state of that step (the reference kernel left it
    at the chunk's entry state, 0 V): within the RC's motion over 5 ns of
    the same row from a run whose chunk does not end there."""
    cc = tct.parse_spice(CHUNK_END, device="cpu")
    short = tct.vmem_tran(cc, (0, 2e-5), dt=1e-6, rows_per_chunk=8)
    whole = tct.vmem_tran(cc, (0, 2e-5), dt=1e-6, rows_per_chunk=512)
    out = cc.index_of("out")
    x7 = short.xs[7].numpy()
    assert abs(x7[cc.index_of("in")] - 1.0) <= 1e-9
    assert x7[out] > 0.4 and abs(short.xs[0, out]) < 1e-12
    assert abs(x7[out] - float(whole.xs[7, out])) <= 5e-3
    # the rows around it are written by the steps, as in the whole run
    np.testing.assert_allclose(short.xs[6:9].numpy(), whole.xs[6:9].numpy(),
                               atol=5e-3)
    assert not bool(short.stats.fail)
