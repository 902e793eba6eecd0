"""Small-signal noise analysis through adjoint solves (PyTorch port of
`cadnip_tpu/analyses/noise.py`).

At the DC operating point, ONE adjoint solve per frequency

    (G + jωC)^T z = e_out

gives every noise source's transfer to the output (H_k = z[p_k] - z[n_k]);
the output PSD is the incoherent sum S_out = Σ|H_k|² S_k(f), and the
input referral divides by |b_in · z|². The frequency axis is the batch of
one real 2N x 2N solve: on a CUDA circuit one launch of kernel K1 for the
whole sweep.

Device noise sources come from each model's `noise` (white PSD) and
`flicker` (num / f^exp) channels between its local node pairs.

Noise is quasi-static on transport delays, as in the JAX package: a
Verilog-A `absdelay` linearizes as the identity here, without the phase
term that `ac` gives it.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ..config import DTYPE, ITYPE
from ..mna.assemble import ensure_setup, make_assembler, pad_state
from ..mna.spec import MODE_AC
from ..mna.structure import CompiledCircuit
from ..ops.linalg import solve_complex
from .ac import _unbatched, linearize
from .dc import dc


class NoiseSolution:
    """onoise_psd [nf] in V^2/Hz (or A^2/Hz), per-device contributions,
    optional input-referred PSD (numpy)."""

    def __init__(self, cc, freqs, onoise_psd, contributions, inoise_psd,
                 converged=True):
        self.cc = cc
        self.freqs = np.asarray(freqs)
        self.onoise_psd = np.asarray(onoise_psd)
        self.contributions = {k: np.asarray(v)
                              for k, v in contributions.items()}
        self.inoise_psd = (None if inoise_psd is None
                           else np.asarray(inoise_psd))
        self.converged = converged

    def total_noise(self, fmin=None, fmax=None):
        """Band-integrated RMS output noise (trapezoidal)."""
        f, s = self.freqs, self.onoise_psd
        m = np.ones_like(f, bool)
        if fmin is not None:
            m &= f >= fmin
        if fmax is not None:
            m &= f <= fmax
        return float(np.sqrt(np.trapezoid(s[m], f[m])))

    def __repr__(self):
        return (f"NoiseSolution({self.cc.title!r}, {len(self.freqs)} freqs, "
                f"{len(self.contributions)} sources)")


def _out_selector(cc: CompiledCircuit, out):
    e = np.zeros(cc.n, np.float64)
    if isinstance(out, (tuple, list)):
        e[cc.index_of(out[0])] += 1.0
        if len(out) > 1 and str(out[1]) not in ("0", "gnd", "GND"):
            e[cc.index_of(out[1])] -= 1.0
    else:
        e[cc.index_of(out)] = 1.0
    return e


def make_noise_sweep(cc: CompiledCircuit, method: str | None = None):
    """Build sweep(x_op, params, dyn, omegas, e_out, b_in) -> (onoise [nf],
    inoise [nf] or None, contrib [nf, n_src]), with the (group, n_inst,
    n_pairs) sizes of the contrib columns. `method` is the dense method of
    the adjoint solve (`ops/linalg.py`, "gauss" by default)."""
    assemble = make_assembler(cc)
    n, dev = cc.n, cc.device
    src_groups, sizes = [], []
    rows_p, rows_n = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for gi, g in enumerate(cc.groups):
        if g.model.noise is None:
            continue
        src_groups.append((gi, g.model,
                           torch.as_tensor(g.conn, dtype=ITYPE, device=dev)))
        sizes.append((gi, g.n_inst, len(g.model.noise_pairs)))
        # each source's rows, instance-major (ground is the padding slot n)
        rows_p.append(g.conn[:, [p for p, _ in g.model.noise_pairs]].ravel())
        rows_n.append(g.conn[:, [m for _, m in g.model.noise_pairs]].ravel())
    rp = torch.as_tensor(np.concatenate(rows_p), dtype=ITYPE, device=dev)
    rn = torch.as_tensor(np.concatenate(rows_n), dtype=ITYPE, device=dev)

    def sources(xp, params, dyn):
        """White PSD, flicker numerator and exponent of every source at
        the operating point: [n_src] each."""
        white, fl_num, fl_exp = [], [], []
        for gi, model, conn in src_groups:
            u, p = xp[conn], params[gi]
            w = vmap(model.noise, in_dims=(0, 0, None))(u, p, dyn)
            white.append(w.reshape(-1))
            if model.flicker is not None:
                num, ex = vmap(model.flicker, in_dims=(0, 0, None))(u, p, dyn)
            else:
                num, ex = torch.zeros_like(w), torch.ones_like(w)
            fl_num.append(num.reshape(-1))
            fl_exp.append(ex.reshape(-1))
        z = [torch.zeros(0, dtype=DTYPE, device=dev)]
        return (torch.cat(z + white), torch.cat(z + fl_num),
                torch.cat(z + fl_exp))

    def sweep(x_op, params, dyn, omegas, e_out, b_in):
        G, C = linearize(cc, assemble, x_op, params, dyn)
        xp = pad_state(torch.as_tensor(x_op, dtype=DTYPE, device=dev))
        white, fl_num, fl_exp = sources(xp, params, dyn)
        nf = omegas.shape[0]
        # the adjoint (G + jwC)^T z = e_out, every frequency in one solve
        zr, zi = solve_complex(
            G.T.expand(nf, -1, -1), omegas[:, None, None] * C.T,
            e_out.expand(nf, -1), torch.zeros((nf, n), dtype=DTYPE,
                                              device=dev), method)
        pad = torch.zeros((nf, 1), dtype=DTYPE, device=dev)
        zr, zi = torch.cat([zr, pad], 1), torch.cat([zi, pad], 1)
        hr = zr[:, rp] - zr[:, rn]
        hi = zi[:, rp] - zi[:, rn]
        f_hz = (omegas / (2.0 * torch.pi))[:, None]
        s_k = white + fl_num / torch.pow(torch.clamp(f_hz, min=1e-300),
                                         fl_exp)
        contrib = (hr * hr + hi * hi) * s_k
        onoise = contrib.sum(-1)
        inoise = None
        if b_in is not None:
            # input referral through the same adjoint: H_in = b_in . z
            h_in2 = zr[:, :n] @ b_in
            h_in2 = torch.clamp(h_in2 * h_in2 + (zi[:, :n] @ b_in) ** 2,
                                min=1e-300)
            inoise = onoise / h_in2
        return onoise, inoise, contrib

    return sweep, sizes


def noise(cc: CompiledCircuit, out, freqs, params=None, *, input=None,
          op_x=None) -> NoiseSolution:
    """Noise analysis: output PSD at `out` (node name or (p, n) pair) over
    `freqs`; if `input` names a V or I source, the input-referred PSD
    too."""
    if params is None:
        params = cc.params0()
    _unbatched(params, "noise")
    params = ensure_setup(cc, params)
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    op = None
    if op_x is None:
        op = dc(cc, params)
        op_x = op.x
    if "noise_sweep" not in cc.cache:
        cc.cache["noise_sweep"] = make_noise_sweep(cc)
    sweep, sizes = cc.cache["noise_sweep"]

    dev = cc.device
    e_out = torch.as_tensor(_out_selector(cc, out), dtype=DTYPE, device=dev)
    b_in = None
    if input is not None:
        # the unit-amplitude excitation of the input source (acmag = 1)
        gi, slot = cc.inst_group[input]
        g = cc.groups[gi]
        if not g.model.ac_rhs:
            raise ValueError(f"input {input!r} is not an independent source")
        b = np.zeros(cc.n + 1, np.float64)
        for local, sign in g.model.ac_rhs:
            b[g.conn[slot, local]] += sign
        b_in = torch.as_tensor(b[:cc.n], dtype=DTYPE, device=dev)
    dyn = cc.spec.dyn(dev, mode=MODE_AC)
    omegas = torch.as_tensor(2 * np.pi * freqs, dtype=DTYPE, device=dev)
    onoise, inoise, contrib = sweep(op_x, params, dyn, omegas, e_out, b_in)

    # split the contributions back to named devices (summed over pairs)
    contrib = contrib.cpu().numpy()
    contributions = {}
    col = 0
    for gi, n_inst, n_pairs in sizes:
        block = contrib[:, col:col + n_inst * n_pairs].reshape(
            len(freqs), n_inst, n_pairs)
        for si, iname in enumerate(cc.groups[gi].names):
            contributions[iname] = block[:, si, :].sum(-1)
        col += n_inst * n_pairs
    return NoiseSolution(
        cc, freqs, onoise.cpu().numpy(), contributions,
        None if inoise is None else inoise.cpu().numpy(),
        converged=(op.converged if op is not None else True))
