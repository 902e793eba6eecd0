"""Kernel K2 with device functions emitted from Verilog-A (`va/cuda.py`),
and its chunk-end rows, on the card (`gpu`; each skips without one): the
emitted ekv26 against the twin's group evaluation, K2 on the EKV DFF
against its twin over 0-60 ns and 0-600 ns (the latch included), the
group-cycle counter on both DFF decks, the library loaded once a process,
and the chunk-end row on a crafted RC and on the graetz draw that showed
the fault. No JAX: the twin and the benchmark's reference are the
yardsticks."""
import os
import sys

import numpy as np
import pytest
import torch

import cadnip_tpu_torch as tct
from cadnip_tpu_torch.mna.spec import MODE_TRAN, make_dynspec
from cadnip_tpu_torch.models.ekv import EKV_VA, compile_ekv
from cadnip_tpu_torch.ops import vmem_tran as vt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the EKV DFF netlist, the twin's bars)
from benchmark.core import traffic as bench_tf  # noqa: E402

EKV_SPAN, EKV_DT = (0, 6e-8), 3.333e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K2 has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def ekv_dff(tmp_path):
    va = tmp_path / "ekv26.va"
    va.write_text(EKV_VA)
    return chip_smoke.ekv_dff_netlist(str(va))


def _counts_close(k2, twin):
    """K2's accepted / rejected / Newton counts against the twin's: equal,
    or within TWIN_COUNT_TOL where rounding flips a step decision."""
    return all(abs(a - b) <= max(1, chip_smoke.TWIN_COUNT_TOL * b)
               for a, b in zip(k2[:3], twin[:3]))


def _rmse_ok(rk, rp, scale):
    tol = (chip_smoke.TWIN_RMSE_TOL if rk.stats[:3] == rp.stats[:3]
           else chip_smoke.TWIN_FLIP_TOL)
    return float((rk.xs.cpu() - rp.xs.cpu()).pow(2).mean().sqrt()) \
        <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_emitted_ekv26_matches_twin_on_gpu(cuda, seed):
    """The emitted ekv26 through `vmem_eval_group` against the twin's
    group evaluation at seeded bias points and cards, both polarities, at
    the bars of test_device_functions_match_twin_on_gpu."""
    rng = np.random.default_rng(seed)
    I = 64
    m = compile_ekv()
    p = {k: np.full(I, float(v)) for k, v in m.defaults.items()}
    for k, v in {"sign": np.where(rng.random(I) < 0.5, 1.0, -1.0),
                 "vto": rng.uniform(0.3, 1.0, I),
                 "kp": rng.uniform(5e-5, 2e-4, I),
                 "lambda": rng.uniform(0.0, 0.1, I),
                 "w": rng.uniform(1e-7, 2e-6, I),
                 "l": rng.uniform(3e-7, 1e-6, I),
                 "cgso": rng.uniform(1e-15, 1e-14, I)}.items():
        p[k], p[k + "__given"] = v, np.ones(I)
    u = rng.uniform(-1.0, 6.0, (I, 4))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=cuda)

    dyn = make_dynspec(gmin=vt.GMIN, mode=MODE_TRAN, device=cuda)
    args = (t(u), t(u), {k: t(v) for k, v in p.items()}, None, dyn)
    for a, b in zip(vt.eval_group(m, *args), vt.eval_group_plain(m, *args)):
        assert float((a - b).abs().max()) <= 1e-10 * max(
            float(b.abs().max()), 1e-300)


@pytest.mark.gpu
def test_k2_ekv_dff_matches_twin_on_gpu(cuda, ekv_dff):
    """The EKV DFF over 0-60 ns: one K2 launch with the emitted ekv26
    against the twin (the Verilog-A interpreter), counts and waveform."""
    S = vt.prepare(tct.parse_spice(ekv_dff, device=cuda), EKV_SPAN,
                   dt=EKV_DT)
    assert S.va is not None and S.va.lib is not None
    before = tct.vmem_tran.launches
    rk = vt.integrate(S)
    assert tct.vmem_tran.launches == before + 1
    rp = vt.integrate_plain(S)
    assert not rk.stats[3] and not rp.stats[3]
    assert rk.warp_iterations == rk.stats[2]
    assert _counts_close(rk.stats, rp.stats), (rk.stats, rp.stats)
    assert _rmse_ok(rk, rp, 5.0)


@pytest.mark.gpu
def test_k2_ekv_dff_full_span_latches_on_gpu(cuda, ekv_dff):
    """The whole 0-600 ns through `vmem_tran` on the card, against the
    twin replayed on the host CPU from the card's set-up; q is low before
    the 401 ns latching edge and high after it."""
    cc = tct.parse_spice(ekv_dff, device=cuda)
    S = vt.prepare(cc, (0, 6e-7), dt=EKV_DT)
    rk = vt.integrate(S)
    assert not rk.stats[3]
    rp = chip_smoke.cpu_k2_twin(ekv_dff, chip_smoke.host_setup(S))
    assert _counts_close(rk.stats, rp["stats"]), (rk.stats, rp["stats"])
    rmse = float(np.sqrt(((rk.xs.cpu().numpy() - rp["xs"]) ** 2).mean()))
    tol = (chip_smoke.TWIN_RMSE_TOL if tuple(rk.stats[:3])
           == tuple(rp["stats"][:3]) else chip_smoke.TWIN_FLIP_TOL)
    assert rmse <= tol * 5.0
    ts = np.linspace(0.0, 6e-7, S.n_save)
    q = rk.xs[:, cc.index_of("q")].cpu().numpy()
    assert q[np.searchsorted(ts, 3.5e-7)] < 1.0
    assert q[np.searchsorted(ts, 5.5e-7)] > 4.0


@pytest.mark.gpu
@pytest.mark.parametrize("deck", ["dff", "ekv_dff"])
def test_group_cycles_on_gpu(cuda, ekv_dff, deck):
    """Both DFF decks report the MOSFET group's device-function cycles, as
    `sol.group_cycles` and as the program counter of the call."""
    net = tct.dff_netlist() if deck == "dff" else ekv_dff
    sol = tct.vmem_tran(tct.parse_spice(net, device=cuda), EKV_SPAN,
                        dt=EKV_DT)
    assert sol.group_cycles > 0
    assert sol.timings["integrate.group_cycles#n"] == sol.group_cycles
    assert sol.group_cycles < sum(sol.phase_cycles.values())


@pytest.mark.gpu
def test_va_library_loads_once_a_process_on_gpu(cuda, ekv_dff):
    """A second job of the same Verilog-A models finds the loaded library:
    nvcc runs for the first only."""
    from cadnip_tpu_torch.ops import nvcc
    calls = []
    build = nvcc.build
    nvcc.build = lambda *a, **k: (calls.append(a), build(*a, **k))[1]
    try:
        libs = [vt.prepare(tct.parse_spice(ekv_dff, device=cuda), EKV_SPAN,
                           dt=EKV_DT).va.lib for _ in range(2)]
    finally:
        nvcc.build = build
    assert libs[0] is libs[1] and len(calls) <= 1


#: tests/test_torch_va_cuda.py's RC whose first chunk (8 rows) ends 0.005
#: save intervals short of its last row
CHUNK_END = """rc chunk end
v1 in 0 PWL(0 0 6.995u 1 20u 1)
r1 in out 2k
c1 out 0 1n
.end
"""


@pytest.mark.gpu
def test_k2_chunk_end_row_matches_twin_on_gpu(cuda):
    S = vt.prepare(tct.parse_spice(CHUNK_END, device=cuda), (0, 2e-5),
                   dt=1e-6, rows_per_chunk=8)
    rk, rp = vt.integrate(S), vt.integrate_plain(S)
    assert rk.stats == rp.stats
    cc = S.cc
    assert float(rk.xs[7, cc.index_of("out")]) > 0.4
    assert float((rk.xs - rp.xs).abs().max()) <= 1e-12


@pytest.mark.gpu
def test_k2_graetz_draw_writes_its_chunk_end_rows_on_gpu(cuda):
    """The graetz draw that showed the fault (benchmark graetz_k2, seed
    2147488006, draw 60, 0-1 s at 1 us, 512-row chunks). Without the fix
    its chunk 480 ends within 0.01 save intervals short of row 246271
    (row 290303 on an earlier form of the warp instance), which then keeps
    the chunk's entry state, 511 us back: 0.744 V off the mean of its
    neighbours. Now every chunk's last row lies on the waveform, within
    the draw's sharpest corner anywhere (0.029 V of 20 V)."""
    cfg = bench_tf.load_json("configs", "vacask_graetz")
    text = bench_tf.job_netlist(cfg, 2147488006, 60)
    sol = tct.vmem_tran(tct.parse_spice(text, device=cuda),
                        (0.0, cfg["tstop"]), dt=cfg["dt"])
    assert not bool(sol.stats.fail)
    xs = sol.xs.cpu().numpy()
    ends = np.arange(511, xs.shape[0] - 1, 512)
    off = np.abs(xs[ends] - 0.5 * (xs[ends - 1] + xs[ends + 1])).max(1)
    assert off[ends == 246271][0] <= 1e-3
    assert off.max() <= 0.05
