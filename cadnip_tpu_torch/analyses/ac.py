"""AC small-signal analysis (PyTorch port of `cadnip_tpu/analyses/ac.py`).

Linearize at the DC operating point (G = df/dx, C = dq/dx), then solve
(G + jωC) x = b_ac at every frequency. The frequency axis is the batch of
one real 2N x 2N solve (`ops/linalg.py::solve_complex`): on a CUDA circuit
the whole sweep is one launch of kernel K1, [n_f, 2n, 2n] with [n_f, 2n]:
its block variant while one system fits a block's shared memory (up to
about n = 84 unknowns in f64), its grid variant beyond. A large circuit
compiled to the block-bordered-diagonal backend keeps the dense
linearization here, as in the JAX package.

Transport delays (Verilog-A `absdelay`) enter the small-signal system as
Y(jω) = S diag(e^{-jωτ}) P, with S = ∂F/∂dly and P = ∂probe/∂x at the
operating point: each frequency's block of the batch then carries its own
G(ω) and C(ω), and the sweep stays one launch.

`subsystem` exports the single-output descriptor system (A = -G, E = C,
B = b_ac) as numpy for control-systems tooling; its `freqresp` is host
numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DTYPE
from torch.func import jacfwd

from ..mna.assemble import (ensure_setup, make_ac_rhs, make_assembler,
                            make_delay_meta, pad_state)
from ..mna.spec import MODE_AC
from ..mna.structure import CompiledCircuit
from ..ops.linalg import solve_complex
from .dc import dc, param_lanes


class ACSolution:
    """Complex phasors per frequency: sol['out'] -> complex [n_freq]."""

    def __init__(self, cc, freqs, x_re, x_im, op, converged=True):
        self.cc = cc
        self.freqs = np.asarray(freqs)
        self.x_re = x_re
        self.x_im = x_im
        self.op = op
        self.converged = converged

    def __getitem__(self, name):
        i = self.cc.index_of(str(name))
        return (self.x_re[..., i].cpu().numpy()
                + 1j * self.x_im[..., i].cpu().numpy())

    def v(self, p, n=None):
        vp = self[p]
        return vp if n is None else vp - self[n]

    def magnitude_db(self, name):
        return 20.0 * np.log10(np.maximum(np.abs(self[name]), 1e-300))

    def phase_deg(self, name):
        return np.angle(self[name], deg=True)

    def __repr__(self):
        return (f"ACSolution({self.cc.title!r}, {len(self.freqs)} freqs "
                f"{self.freqs.min():.3g}..{self.freqs.max():.3g} Hz)")


def acdec(points_per_decade: int, fstart: float, fstop: float) -> np.ndarray:
    """SPICE-style logarithmic frequency grid (f64)."""
    ndec = np.log10(fstop / fstart)
    n = int(np.ceil(points_per_decade * ndec)) + 1
    return np.logspace(np.log10(fstart), np.log10(fstop), n)


def linearize(cc: CompiledCircuit, assemble, x_op, params, dyn):
    """G, C [n, n] from `make_assembler(cc)` at the operating point x_op
    [n] (unbatched)."""
    xp = pad_state(torch.as_tensor(x_op, dtype=DTYPE,
                                   device=cc.device)[None])
    _, _, G, C, _ = assemble(xp, assemble.init_lim(xp), params, dyn)
    return G[0], C[0]


def make_ac_sweep(cc: CompiledCircuit, method: str | None = None):
    """Build ac_sweep(x_op, params, dyn, omegas) -> (x_re, x_im), each
    [n_freq, n]: one batched solve over the frequencies, by the dense
    `method` of `ops/linalg.py` ("gauss" by default; "gjpl32ir" makes the
    sweep one f32 launch of K1, the inverses of the equilibrated 2N
    forms)."""
    assemble = make_assembler(cc)
    b_ac_fn = make_ac_rhs(cc)
    dmeta = make_delay_meta(cc)

    def delay_terms(x_op, params, dyn):
        """G, C with the delayed inputs held at their operating-point
        values, S = ∂F/∂dly [n, size], P = ∂probe/∂x [size, n] and the
        delays [size]."""
        x = torch.as_tensor(x_op, dtype=DTYPE, device=cc.device)
        xp = pad_state(x[None])
        lim = assemble.init_lim(xp)
        vals, taus = dmeta.probe(xp, params, dyn)
        _, _, G, C, _ = assemble(xp, lim, params, dyn, vals)
        S = jacfwd(lambda d: assemble(xp, lim, params, dyn,
                                      d[None])[0][0])(vals[0])
        P = jacfwd(lambda xx: dmeta.probe(pad_state(xx[None]), params,
                                          dyn)[0][0])(x)
        return G[0], C[0], S, P, taus[0]

    def ac_sweep(x_op, params, dyn, omegas):
        br, bi = b_ac_fn(params)
        nf = omegas.shape[0]
        w = omegas[:, None, None]
        if dmeta is None:
            G, C = linearize(cc, assemble, x_op, params, dyn)
            return solve_complex(G.expand(nf, -1, -1), w * C,
                                 br.expand(nf, -1), bi.expand(nf, -1),
                                 method)
        G, C, S, P, taus = delay_terms(x_op, params, dyn)
        # S diag(e^{-jωτ}) P: the real part joins G, the imaginary part
        # the ωC slot
        wt = omegas[:, None] * taus[None, :]
        cosr = S[None] * torch.cos(wt)[:, None, :]
        sinr = S[None] * torch.sin(wt)[:, None, :]
        Gw = G[None] + cosr @ P
        Cw = C[None] - (sinr @ P) / torch.clamp(w, min=1e-300)
        return solve_complex(Gw, w * Cw, br.expand(nf, -1),
                             bi.expand(nf, -1), method)

    return ac_sweep


def _unbatched(params, what):
    if param_lanes(params) is not None:
        raise ValueError(f"{what} takes unbatched parameters ([n_inst] "
                         f"leaves); run one lane at a time")


def ac(cc: CompiledCircuit, freqs, params=None, *, op_x=None) -> ACSolution:
    """AC analysis over the frequency grid `freqs` [Hz]. The operating point
    comes from `dc` unless `op_x` is given; where it does not converge, the
    solution says so (`converged=False`) and is not raised."""
    if params is None:
        params = cc.params0()
    _unbatched(params, "ac")
    params = ensure_setup(cc, params)
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    op = None
    if op_x is None:
        op = dc(cc, params)
        op_x = op.x
    if "ac_sweep" not in cc.cache:
        cc.cache["ac_sweep"] = make_ac_sweep(cc)
    dyn = cc.spec.dyn(cc.device, mode=MODE_AC)
    omegas = torch.as_tensor(2.0 * np.pi * freqs, dtype=DTYPE,
                             device=cc.device)
    x_re, x_im = cc.cache["ac_sweep"](op_x, params, dyn, omegas)
    return ACSolution(cc, freqs, x_re, x_im, op,
                      converged=(op.converged if op is not None else True))


class DescriptorSISO:
    """Single-output descriptor state-space (s E - A) x = B u, y = C x,
    as numpy matrices for python-control / scipy.signal style tooling."""

    def __init__(self, A, E, B, C, D, name):
        self.A, self.E, self.B, self.C, self.D = A, E, B, C, D
        self.name = name

    def freqresp(self, freqs):
        """Complex response y(jω) = C (jωE − A)⁻¹ B + D per frequency
        [Hz], on the host."""
        freqs = np.atleast_1d(np.asarray(freqs, np.float64))
        out = np.empty(len(freqs), np.complex128)
        for k, f in enumerate(freqs):
            s = 2j * np.pi * f
            x = np.linalg.solve(s * self.E - self.A, self.B)
            out[k] = (self.C @ x + self.D)[0, 0]
        return out

    def __repr__(self):
        return (f"DescriptorSISO(output={self.name!r}, "
                f"n={self.A.shape[0]})")


def subsystem(cc: CompiledCircuit, name, params=None, *,
              op_x=None) -> DescriptorSISO:
    """SISO descriptor export: A = −G, E = C (charge Jacobian), B = the
    deck's AC excitation vector, C selecting node/branch `name`, D = 0."""
    if params is None:
        params = cc.params0()
    _unbatched(params, "subsystem")
    params = ensure_setup(cc, params)
    if op_x is None:
        op_x = dc(cc, params).x
    dyn = cc.spec.dyn(cc.device, mode=MODE_AC)
    G, Cm = linearize(cc, make_assembler(cc), op_x, params, dyn)
    br, bi = make_ac_rhs(cc)(params)
    n = cc.n
    C_row = np.zeros((1, n))
    C_row[0, cc.index_of(str(name))] = 1.0
    B = (br.cpu().numpy() + 1j * bi.cpu().numpy()).reshape(n, 1)
    if np.allclose(B.imag, 0.0):
        B = B.real
    return DescriptorSISO(-G.cpu().numpy(), Cm.cpu().numpy(), B, C_row,
                          np.zeros((1, 1)), str(name))
