"""The port's main path end to end on the CPU: SPICE text -> parse ->
DC operating point -> adaptive trapezoidal transient of the DFF benchmark,
against the checked-in f64 golden tests/goldens/dff.npz; and the package's
independence from JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cadnip_tpu_torch as tct

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "goldens", "dff.npz")


def test_dff_transient_matches_golden():
    g = np.load(GOLD)
    cc = tct.parse_spice(tct.dff_netlist(), device="cpu")
    sol = tct.tran(cc, (0, 6e-7), dt=3.333e-10, max_steps=100000)
    st = sol.stats
    # the JAX package on the CPU takes 995 / 143 / 2062 on this run
    print(f"DFF port: accepted {int(st.naccept)}, rejected "
          f"{int(st.nreject)}, newton {int(st.nnewton)}, DC newton "
          f"{int(sol.op_iters)}, host syncs {sol.host_syncs}")
    assert bool(sol.converged)
    q = sol["q"].numpy()
    assert q.shape == g["q"].shape and np.isfinite(q).all()
    rmse = float(np.sqrt(np.mean((q - g["q"]) ** 2))) / 5.0
    assert rmse <= 1e-6, rmse


def test_transient_lanes_and_gear2_on_rc():
    # a batched (B = 2) transient, trap and gear2, against the RC answer
    cir = tct.Circuit("rc")
    cir.V("v1", "in", "0", wave=tct.Pulse(0.0, 1.0, 1e-6, 1e-9, 1e-9))
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-9)
    cc = cir.compile(device="cpu")
    params = cc.alter(cc.params0(), **{"r1.r": [1e3, 2e3]})
    for integ in ("trap", "gear2"):
        sol = tct.tran(cc, (0, 5e-6), params, dt=1e-8, integ=integ)
        assert sol.xs.shape == (2, 501, cc.n)
        assert sol.converged.tolist() == [True, True]
        t = sol.ts
        for k, tau in enumerate((1e-6, 2e-6)):
            ref = np.where(t > 1e-6, 1 - np.exp(-(t - 1e-6) / tau), 0.0)
            np.testing.assert_allclose(sol["out"][k].numpy(), ref,
                                       atol=5e-3)


def test_uic_and_ic_pin_the_start():
    cir = tct.Circuit("rc_ic")
    cir.V("v1", "in", "0", dc=0.0)
    cir.R("r1", "in", "out", 1e3)
    cir.C("c1", "out", "0", 1e-9)
    sol = tct.tran(cir.compile(device="cpu"), (0, 3e-6), dt=1e-8, uic=True,
                   ic={"out": 1.0})
    v = sol["out"].numpy()
    assert v[0] == pytest.approx(1.0)
    np.testing.assert_allclose(v, np.exp(-sol.ts / 1e-6), atol=5e-3)


def test_package_imports_no_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'cadnip_tpu',\n"
        "                                  'matplotlib'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "had = 'jax' in sys.modules\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pkgutil, importlib, cadnip_tpu_torch\n"
        "for m in pkgutil.walk_packages(cadnip_tpu_torch.__path__,\n"
        "                               'cadnip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'cadnip_tpu_torch.va.codegen' in sys.modules\n"
        "assert 'cadnip_tpu_torch.analyses.tran_pit' in sys.modules\n"
        "assert 'cadnip_tpu_torch.analyses.tran_linear' in sys.modules\n"
        "assert 'cadnip_tpu_torch.ops.bbd' in sys.modules\n"
        "assert 'cadnip_tpu_torch.mna.bbd_assemble' in sys.modules\n"
        "assert 'cadnip_tpu_torch.frontend.spectre' in sys.modules\n"
        "assert 'cadnip_tpu_torch.frontend.explore' in sys.modules\n"
        "assert 'cadnip_tpu_torch.convert' in sys.modules\n"
        "assert had or 'jax' not in sys.modules\n"
        "assert 'cadnip_tpu' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "cadnip_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in src and "from jax" not in src
                assert "from cadnip_tpu." not in src
                assert "import cadnip_tpu\n" not in src
