"""Simulator option block (PyTorch port of `cadnip_tpu/mna/spec.py`).

Two pieces, as in the JAX package:

  * `SimSpec` — static, hashable Python config (mode, tolerances, limits).
  * `DynSpec` — a NamedTuple of 0-d tensors (temp, time, gmin, gshunt,
    srcfact, mode) threaded through every device residual. A batched
    solve may carry a leading lane axis on any field.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import DTYPE, ITYPE

KB = 1.380649e-23
QE = 1.602176634e-19
T0_K = 273.15


class DynSpec(NamedTuple):
    """Dynamic simulation scalars: 0-d tensors (or [B] for batched lanes)."""

    temp: torch.Tensor      # device temperature [K]
    time: torch.Tensor      # current simulation time [s] (0 for DC)
    gmin: torch.Tensor      # junction gmin [S]
    gshunt: torch.Tensor    # node-to-ground shunt for gmin stepping [S]
    srcfact: torch.Tensor   # independent-source scale factor
    mode: torch.Tensor      # analysis mode code (MODE_* below), int64

    @property
    def vt(self):
        return KB * self.temp / QE


# analysis mode codes (tensors so devices can branch with torch.where)
MODE_DCOP = 0     # DC operating point: capacitors open, inductors short
MODE_TRANOP = 1   # operating point for transient: time sources at t=0
MODE_TRAN = 2     # transient time stepping
MODE_AC = 3       # small-signal linearization


def make_dynspec(temp_c: float = 27.0, time: float = 0.0,
                 gmin: float = 1e-12, gshunt: float = 0.0,
                 srcfact: float = 1.0, mode: int = MODE_DCOP, *,
                 device) -> DynSpec:
    def f(v):
        return torch.as_tensor(v, dtype=DTYPE, device=device)

    return DynSpec(temp=f(temp_c + T0_K), time=f(time), gmin=f(gmin),
                   gshunt=f(gshunt), srcfact=f(srcfact),
                   mode=torch.as_tensor(mode, dtype=ITYPE, device=device))


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Static solver configuration.

    An unknown `i` of class voltage converges when
    |dx_i| <= reltol*max(|x_i|, |x_prev_i|) + vntol; currents use abstol,
    charge-like states chgtol.
    """

    temp_c: float = 27.0
    tnom_c: float = 27.0
    reltol: float = 1e-4
    abstol: float = 1e-12   # branch currents [A]
    vntol: float = 1e-6     # node voltages [V]
    chgtol: float = 1e-14   # charges [C]
    gmin: float = 1e-12
    gshunt: float = 0.0
    max_newton_iters: int = 60
    # DC robustness chain (reference `solve.jl:871-929`)
    gmin_steps: int = 10        # gshunt ladder length for gmin stepping
    gshunt_start: float = 1e-2  # first rung of the ladder
    src_steps: int = 10         # source-stepping ramp points
    # Newton voltage-step clamp (helps exp nonlinearities; 0 disables)
    max_dv: float = 5.0

    def dyn(self, device, **kw) -> DynSpec:
        base = dict(temp_c=self.temp_c, gmin=self.gmin, gshunt=self.gshunt)
        base.update(kw)
        return make_dynspec(device=device, **base)
