"""Fixed-step transient for linear (affine) circuits (PyTorch port of
`cadnip_tpu/analyses/tran_linear.py`).

For a circuit whose devices are all affine (R, C, L, V, I, E/G/F/H, K), the
MNA system is G x + C dx/dt = b(t) with constant G, C. A fixed-step
trapezoidal discretization is the affine recurrence

    z_k = T z_{k-1} + U b_k,        z = [x; qdot]  (2n state)

with constant T, U. Instead of stepping serially, the recurrence is
evaluated by blocked prefix products:

  * the source values b_k over the whole time grid come from one residual
    evaluation with the grid as its lane axis;
  * K^-1 (K = G + 2C/h) is one launch of kernel K1 with the identity as
    its right-hand sides (`ops/linalg.factorize(K, "gauss")`);
  * the matrix powers T^i (i <= B), the lower block-triangular convolution
    matrix W[i, j] = T^(i-j), the convolution of every block at once and the
    block-end recurrence are f64 `torch.matmul`s, as the JAX package
    computes them outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..config import DTYPE
from ..mna.assemble import make_assembler, make_rhs_assembler, pad_state
from ..mna.spec import MODE_TRAN, MODE_TRANOP
from ..mna.structure import CompiledCircuit
from ..ops.linalg import factorize, solve
from .tran import TranSolution, TranStats


def is_linear(cc: CompiledCircuit) -> bool:
    return all(g.model.linear for g in cc.groups)


def make_linear_runner(cc: CompiledCircuit, n_steps: int, block: int = 256):
    """Build run(x0 [n], params, t0, dt) -> xs [n_steps + 1, n] (exact
    trap)."""
    assemble = make_assembler(cc)
    rhs = make_rhs_assembler(cc)
    n = cc.n
    dev = cc.device
    nb = int(np.ceil(n_steps / block))
    n_pad = nb * block
    m2 = 2 * n

    def run(x0, params, t0, dt):
        dyn = cc.spec.dyn(dev, mode=MODE_TRAN, time=t0)
        xp0 = pad_state(x0[None])
        lim = assemble.init_lim(xp0)
        _, _, G, C, _ = assemble(xp0, lim, params, dyn)
        G, C = G[0], C[0]
        # b(t) = -F(0, t) over the whole grid (affine residual: F = Gx - b)
        ts = t0 + dt * torch.arange(1, n_pad + 1, dtype=DTYPE, device=dev)
        zeros = torch.zeros((n_pad, n + 1), dtype=DTYPE, device=dev)
        F, _ = rhs(zeros, params, dyn._replace(time=ts))
        B = -F                                             # [n_pad, n]

        c = 2.0 / dt
        K = G + c * C
        eye = torch.eye(n, dtype=DTYPE, device=dev)
        Kinv = factorize(K, "gauss").solve(eye)            # one K1 launch
        A1 = Kinv @ (c * C)
        A2 = Kinv
        T = torch.cat([torch.cat([A1, A2], 1),
                       torch.cat([c * C @ (A1 - eye), c * C @ A2 - eye], 1)],
                      0)
        U = torch.cat([A2, c * C @ A2], 0)                 # [2n, n]

        # initial state: x0 and the consistent qdot0 = -f(x0, t0)
        F0, _ = rhs(xp0, params, dyn)
        z0 = torch.cat([x0, -F0[0]])

        u = B @ U.T                                        # [n_pad, 2n]

        # matrix powers T^0..T^block
        powers = [torch.eye(m2, dtype=DTYPE, device=dev)]
        for _ in range(block):
            powers.append(powers[-1] @ T)
        Tp = torch.stack(powers)                           # [block+1, 2n, 2n]
        # W[i, j] = T^(i-j) for j <= i else 0, flattened to one
        # [B*2n, B*2n] lower block-triangular matrix
        ii = np.arange(block)[:, None]
        jj = np.arange(block)[None, :]
        idx = torch.as_tensor(np.where(jj <= ii, ii - jj, 0), device=dev)
        mask = torch.as_tensor(jj <= ii, device=dev)[..., None, None]
        Wt = torch.where(mask, Tp[idx], 0.0)               # [B, B, 2n, 2n]
        Wm = Wt.permute(0, 2, 1, 3).reshape(block * m2, block * m2)

        # 1) the within-block causal convolutions of every block at once:
        #    conv[m, i] = sum_{j<=i} T^(i-j) u[mB+j]
        conv = (u.reshape(nb, block * m2) @ Wm.T).reshape(nb, block, m2)

        # 2) the block-end recurrence Z_{m+1} = T^B Z_m + conv[m, -1]: the
        #    only sequential piece, nb small matvecs
        TB = Tp[block]
        tails = conv[:, -1]
        z = z0
        starts = []
        for m in range(nb):
            starts.append(z)
            z = TB @ z + tails[m]
        Zstart = torch.stack(starts)                       # [nb, 2n]

        # 3) every in-block state: z_{mB+i+1} = T^(i+1) Z_m + conv[m, i]
        Pm = Tp[1:block + 1].reshape(block * m2, m2)       # [B*2n, 2n]
        Z = (Zstart @ Pm.T).reshape(nb, block, m2) + conv
        Z = Z.reshape(n_pad, m2)[:n_steps]
        return torch.cat([x0[None, :], Z[:, :n]], 0)

    return run


def auto_block(n: int, budget_bytes: float = 64e6) -> int:
    """Largest power-of-two block with W tensor under the memory budget."""
    b = int(np.sqrt(budget_bytes / ((2 * n) ** 2 * 8)))
    b = max(16, min(512, b))
    return 1 << (b.bit_length() - 1)


@obs.entry
def tran_linear(cc: CompiledCircuit, tspan, dt, params=None, *,
                block: int | None = None, x0=None) -> TranSolution:
    """Fixed-step trapezoidal transient for linear circuits. Saves every
    step: ts = t0 + dt*[0..n_steps]."""
    if not is_linear(cc):
        raise ValueError("tran_linear requires an all-linear circuit; "
                         "use tran() instead")
    with obs.span("op"):
        if block is None:
            block = auto_block(cc.n)
        t0, tstop = float(tspan[0]), float(tspan[1])
        n_steps = int(round((tstop - t0) / dt))
        if params is None:
            params = cc.params0()
        dev = cc.device
        op_conv = True
        if x0 is None:
            # linear circuit: the operating point is ONE linear solve
            assemble = make_assembler(cc)
            zp = torch.zeros((1, cc.n + 1), dtype=DTYPE, device=dev)
            F, _, G, _, _ = assemble(zp, assemble.init_lim(zp), params,
                                     cc.spec.dyn(dev, mode=MODE_TRANOP,
                                                 time=t0))
            x0 = solve(G[0], -F[0], method="gauss")
            op_conv = bool(torch.isfinite(x0).all())
        x0 = torch.as_tensor(x0, dtype=DTYPE, device=dev)
    with obs.span("transient"):
        xs = make_linear_runner(cc, n_steps, block)(x0, params, t0,
                                                    float(dt))
        xs[-1, 0].item()          # the run's end, for the wall time
    ts = t0 + dt * np.arange(n_steps + 1)
    z = torch.tensor(0)
    stats = TranStats(naccept=torch.tensor(n_steps), nreject=z, nnewton=z,
                      fail=torch.tensor(False))
    return TranSolution(cc, ts, xs, stats, op_converged=op_conv)
