"""Parameter sensitivities of DC solutions (PyTorch port of
`cadnip_tpu/analyses/sensitivity.py`).

The implicit function theorem at the converged Newton point:

    F(x*, p) = 0   =>   dx*/dp = -G(x*)^{-1} dF/dp.

dF/dp comes from `torch.func.jvp` of the assembler with a unit tangent on
each requested parameter; then one dense solve (kernel K1 on a CUDA
circuit) takes every requested parameter as a right-hand-side column.
"""
from __future__ import annotations

import torch

from ..config import DTYPE
from ..mna.assemble import make_assembler, pad_state
from ..mna.spec import MODE_DCOP
from ..mna.structure import CompiledCircuit
from ..ops.linalg import solve as dense_solve
from .dc import _cached, dc, param_lanes
from .sweeps import _base_value


def dc_sensitivity(cc: CompiledCircuit, names, params=None, *, sol=None,
                   mode=MODE_DCOP, time=0.0):
    """d(x*)/d(param) for each 'inst.param' in names: {name: tensor [n]}.

    Single-point only, as in the JAX package: parameters and solution
    carry no lane axis."""
    if isinstance(names, str):
        names = [names]
    if params is None:
        params = cc.params0()
    if param_lanes(params) is not None:
        raise NotImplementedError("dc_sensitivity is single-point only; "
                                  "index one lane of a batched solution")
    if sol is None:
        sol = dc(cc, params, mode=mode, time=time)
    assemble = _cached(cc, "assembler", make_assembler)
    xp = pad_state(torch.as_tensor(sol.x, dtype=DTYPE,
                                   device=cc.device).reshape(1, cc.n))
    lim = assemble.init_lim(xp)
    dyn = cc.spec.dyn(cc.device, mode=mode, time=time)

    def residual(name):
        def F(v):
            return assemble(xp, lim, cc.alter(params, **{name: v}), dyn)[0]
        return F

    cols = []
    for name in names:
        v0 = torch.tensor(_base_value(cc, params, name), dtype=DTYPE,
                          device=cc.device)
        _, dF = torch.func.jvp(residual(name), (v0,), (torch.ones_like(v0),))
        cols.append(dF)
    _, _, G, _, _ = assemble(xp, lim, params, dyn)
    S = dense_solve(G, -torch.stack(cols, dim=-1))[0]
    return {name: S[:, i] for i, name in enumerate(names)}
