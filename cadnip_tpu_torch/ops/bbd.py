"""Block-bordered-diagonal (BBD) sparse solve (PyTorch port of
`cadnip_tpu/ops/bbd.py`): the replacement for SuiteSparse KLU on circuits
beyond the dense solver's range (SURVEY §2.9).

The circuit graph is cut into K blocks of about block_size unknowns plus
a global border, and the MNA system reordered into

    [D_1          E_1] [x_1]   [f_1]
    [     ...     ...] [...] = [...]
    [         D_K E_K] [x_K]   [f_K]
    [F_1  ... F_K  B ] [x_b]   [f_b]

which is solved by batched dense block solves and a dense Schur
complement:

    S = B - sum_k F_k D_k^{-1} E_k
    S x_b = f_b - sum_k F_k D_k^{-1} f_k
    x_k = D_k^{-1} (f_k - E_k x_b)

The coupling strips E_k / F_k are compressed to each block's own border
set (`bmap`), so memory is K*bs*nbl, not K*bs*nb.

The partition (`BBDPartition`, `partition_graph`, `row_maps`) is host
numpy, copied from the JAX package. The solve is batch-first: every
tensor carries a lane axis B, D is [B, K, bs, bs], and the block solves
with [E | f] as right-hand sides are one solve over B*K systems (kernel
K1 on the card), the Schur solve one over B systems (K1's grid variant
once the border outgrows one block's shared memory). Every scatter-add
with repeated destinations (several blocks stamp one border entry) goes
through a host-built sorted plan (`mna/assemble.py::make_sorted_scatter`),
so that its sums run in one order on every run: f64 atomics would move
the last bits, and through them `tran`'s step decisions.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..config import DTYPE, ITYPE
from .linalg import solve as dense_solve


@dataclasses.dataclass
class BBDPartition:
    n: int
    K: int                 # number of blocks
    bs: int                # padded block size
    nb: int                # border size (excl. pad slot)
    nbl: int               # per-block border cap (padded)
    kind: np.ndarray       # [n] 0 = block interior, 1 = border
    block_of: np.ndarray   # [n] block index (-1 for border)
    local_of: np.ndarray   # [n] slot within block / border index
    bmap: np.ndarray       # [K, nbl] global border slots per block (pad=nb)
    #: device index plans of `global_row_sums` / `bbd_matvec`, per device
    plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def shapes(self):
        return dict(D=(self.K, self.bs, self.bs),
                    E=(self.K, self.bs, self.nbl),
                    F=(self.K, self.nbl, self.bs),
                    B=(self.nb + 1, self.nb + 1))


def partition_graph(n: int, edges, block_size: int = 256,
                    device_unknowns=None, pre_border=()) -> BBDPartition:
    """Greedy BFS partition of the unknown-connectivity graph.

    edges: iterable of (i, j) pairs (device co-occurrence).
    device_unknowns: list of per-device unknown index arrays; after BFS
    blocking, unknowns of devices that span multiple blocks are promoted to
    the border until every device touches at most one block.
    pre_border: unknowns forced to the border up front (the caller's
    structural-singularity guard: a zero-diagonal branch-current row whose
    every coupling partner is border would make its D block singular).
    """
    adj = [[] for _ in range(n)]
    for i, j in edges:
        if i != j and i < n and j < n:
            adj[i].append(j)
            adj[j].append(i)

    # hub nets (power/ground rails, global clocks) go straight to the
    # border and the BFS never crosses them
    deg = np.array([len(a) for a in adj])
    is_border = np.zeros(n, bool)
    hub_cut = max(4 * block_size, 64)
    is_border[deg >= hub_cut] = True
    for i in pre_border:
        if 0 <= i < n:
            is_border[i] = True

    # BFS region growing from LOW-degree seeds (periphery first)
    block_of = np.full(n, -1, np.int64)
    order = np.argsort(deg, kind="stable")
    bidx = 0
    for seed in order:
        if block_of[seed] >= 0 or is_border[seed]:
            continue
        q = deque([seed])
        count = 0
        while q and count < block_size:
            u = q.popleft()
            if block_of[u] >= 0 or is_border[u]:
                continue
            block_of[u] = bidx
            count += 1
            for v in adj[u]:
                if block_of[v] < 0 and not is_border[v]:
                    q.append(v)
        bidx += 1
    K = bidx

    # promote block-spanning device unknowns to the border
    if device_unknowns is not None:
        for _ in range(40):  # usually converges in a couple of sweeps
            changed = False
            for idx in device_unknowns:
                idx = [i for i in idx if i < n and not is_border[i]]
                blocks = {block_of[i] for i in idx}
                if len(blocks) <= 1:
                    continue
                # promote everything but the majority block
                counts = {}
                for i in idx:
                    counts[block_of[i]] = counts.get(block_of[i], 0) + 1
                keep = max(counts, key=counts.get)
                for i in idx:
                    if block_of[i] != keep:
                        is_border[i] = True
                        changed = True
            if not changed:
                break
        # demotion sweep: a border unknown whose every device now touches
        # a single block can rejoin it
        block_of[is_border] = -1
        touching = [[] for _ in range(n)]
        for di, idx in enumerate(device_unknowns):
            for i in idx:
                if i < n:
                    touching[i].append(di)
        bcnt = (np.bincount(block_of[block_of >= 0], minlength=K)
                if K else np.zeros(0, np.int64))
        frozen = set(pre_border)
        for _ in range(4):
            changed = False
            for u in range(n):
                if not is_border[u] or deg[u] >= hub_cut or u in frozen:
                    continue
                tgt = set()
                ok = True
                for di in touching[u]:
                    for i in device_unknowns[di]:
                        if i < n and i != u and block_of[i] >= 0:
                            tgt.add(block_of[i])
                    if len(tgt) > 1:
                        ok = False
                        break
                if not ok or not tgt:
                    continue
                b = next(iter(tgt))
                if bcnt[b] >= block_size:
                    continue
                is_border[u] = False
                block_of[u] = b
                bcnt[b] += 1
                changed = True
            if not changed:
                break
    else:
        for i in range(n):
            for j in adj[i]:
                if block_of[j] != block_of[i]:
                    is_border[i] = True

    # compact numbering
    local_of = np.zeros(n, np.int64)
    bcount = np.zeros(K, np.int64)
    border_ids = []
    for i in range(n):
        if is_border[i]:
            local_of[i] = len(border_ids)
            border_ids.append(i)
        else:
            local_of[i] = bcount[block_of[i]]
            bcount[block_of[i]] += 1
    nb = len(border_ids)
    bs = max(int(bcount.max()) if K else 1, 1)
    block_of = np.where(is_border, -1, block_of)

    # per-block border sets, from the devices that touch one block
    bsets = [set() for _ in range(K)]
    if device_unknowns is not None:
        for idx in device_unknowns:
            blocks = {block_of[i] for i in idx if block_of[i] >= 0}
            if len(blocks) == 1:
                b = next(iter(blocks))
                for i in idx:
                    if block_of[i] < 0:
                        bsets[b].add(local_of[i])
    nbl = max(max((len(s) for s in bsets), default=1), 1)
    bmap = np.full((K, nbl), nb, np.int64)   # pad -> slot nb
    for b, s in enumerate(bsets):
        for pos, g in enumerate(sorted(s)):
            bmap[b, pos] = g

    return BBDPartition(n=n, K=K, bs=bs, nb=nb, nbl=nbl,
                        kind=is_border.astype(np.int8),
                        block_of=block_of, local_of=local_of, bmap=bmap)


def row_maps(part: BBDPartition):
    """(blk_rows [K, bs], border_rows [nb+1]) global indices (pad -> n)."""
    inner = part.block_of >= 0
    rows = np.arange(part.n)
    blk_rows = np.full((part.K, part.bs), part.n, np.int64)
    blk_rows[part.block_of[inner], part.local_of[inner]] = rows[inner]
    border_rows = np.full(part.nb + 1, part.n, np.int64)
    border_rows[part.local_of[~inner]] = rows[~inner]
    return blk_rows, border_rows


class _Plans:
    """A partition's gather maps and sorted scatters on one device."""

    def __init__(self, part: BBDPartition, device):
        from ..mna.assemble import make_sorted_scatter
        blk_rows, border_rows = row_maps(part)
        nb = part.nb

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=ITYPE, device=device)

        self.blk_rows = t(blk_rows)                       # [K, bs]
        self.border_rows = t(border_rows)                 # [nb + 1]
        self.bmap = t(part.bmap)                          # [K, nbl]
        valid = (blk_rows != part.n).reshape(-1)
        self.xk_pos = t(np.flatnonzero(valid))            # block slots
        self.dx_rows = t(blk_rows.reshape(-1)[valid])     # their rows
        self.bor_rows = t(border_rows[:nb])               # border rows
        # F-strip rows summed into border slots through bmap; the pad
        # entries (slot nb) take no part
        self.to_border = make_sorted_scatter([part.bmap], nb + 1, device,
                                             skip=nb)


def _plans(part: BBDPartition, device) -> _Plans:
    key = str(torch.device(device))
    if key not in part.plans:
        part.plans[key] = _Plans(part, device)
    return part.plans[key]


def _scatter_rows(part, pl, yk, yb):
    """[B, n] from block rows yk [B, K, bs] and border rows yb [B, nb+1]
    (pad slots dropped): every global row is written exactly once."""
    B = yk.shape[0]
    y = torch.zeros((B, part.n + 1), dtype=yk.dtype, device=yk.device)
    y[:, pl.dx_rows] = yk.reshape(B, -1)[:, pl.xk_pos]
    y[:, pl.bor_rows] = yb[:, :part.nb]
    return y[:, :part.n]


def global_row_sums(part: BBDPartition, T):
    """Sum |entries| per global row of a BBD-form matrix tuple
    (D, E, F, B), each with a lane axis -> [B, n]."""
    D, E, F, Bm = T
    pl = _plans(part, D.device)
    blk_sum = D.abs().sum(-1) + E.abs().sum(-1)                # [B, K, bs]
    bor_sum = Bm.abs().sum(-1) + pl.to_border([F.abs().sum(-1)])
    return _scatter_rows(part, pl, blk_sum, bor_sum)


def _bmv(M, v):
    """Batched matrix-vector product over the trailing two axes."""
    return (M @ v[..., None])[..., 0]


def bbd_matvec(part: BBDPartition, T, v):
    """y = M @ v for a BBD-form matrix tuple (D, E, F, B) and v [B, n]."""
    D, E, F, Bm = T
    pl = _plans(part, v.device)
    vp = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
    vk = vp[:, pl.blk_rows]                          # [B, K, bs]
    vb = vp[:, pl.border_rows]                       # [B, nb+1]
    vbl = vb[:, pl.bmap]                             # [B, K, nbl]
    yk = _bmv(D, vk) + _bmv(E, vbl)
    yb = _bmv(Bm, vb) + pl.to_border([_bmv(F, vk)])
    return _scatter_rows(part, pl, yk, yb)


def make_bbd_solver(part: BBDPartition, device, method: str | None = None,
                    nested: "BBDPartition | None" = None):
    """Build solve(D, E, F, B, f) -> dx for the BBD system, batch-first.

    D [B, K, bs, bs], E [B, K, bs, nbl], F [B, K, nbl, bs],
    B [B, nb+1, nb+1] (slot nb is the pad target); f is the GLOBAL
    right-hand side [B, n]; returns the global dx [B, n]. `method` is the
    dense method of `ops/linalg.py` for the block and Schur solves ("gauss",
    kernel K1, by default).

    `nested`: a BBDPartition over the nb BORDER unknowns
    (`mna.bbd_assemble.nested_border_partition`; its fill graph covers
    every Schur-complement nonzero). The dense Schur solve is then a
    second BBD level: S is gathered into (D2, E2, F2, B2) and solved by
    this function's recursion, so the border costs O(K2*bs2^3 + nb2^3)
    instead of O(nb^3). S is still formed densely (O(nb^2) memory)."""
    from ..mna.assemble import make_sorted_scatter
    K, bs, nb, nbl = part.K, part.bs, part.nb, part.nbl
    pl = _plans(part, device)
    blk_rows, _ = row_maps(part)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=ITYPE, device=device)

    # ghost pad slots (slots with no unknown assigned) get identity rows:
    # a structural mask, not a value test (MNA voltage-source rows have
    # legitimately zero diagonals)
    ghost = torch.as_tensor((blk_rows == part.n).astype(np.float64),
                            dtype=DTYPE, device=device)
    ghost_eye = ghost[:, :, None] * torch.eye(bs, dtype=DTYPE,
                                              device=device)   # [K, bs, bs]
    # S -= F DinvE and rb -= F Dinvf over the valid (non-pad) bmap pairs,
    # in a fixed order
    bm = np.asarray(part.bmap)
    valid2 = (bm[:, :, None] != nb) & (bm[:, None, :] != nb)
    s_rows = np.where(valid2, bm[:, :, None] * (nb + 1) + bm[:, None, :],
                      -1)
    s_scatter = make_sorted_scatter([s_rows], (nb + 1) ** 2, device,
                                    skip=-1)
    pad = torch.ones(nb + 1, dtype=DTYPE, device=device)
    pad[nb] = 0.0
    pad2 = pad[:, None] * pad[None, :]       # zero the pad row and column
    pad_eye = torch.zeros((nb + 1, nb + 1), dtype=DTYPE, device=device)
    pad_eye[nb, nb] = 1.0

    if nested is not None:
        assert nested.n == nb, (nested.n, nb)
        # border-local gather maps for the level-2 system; pad -> slot nb,
        # whose S row/column is zeroed first (so ghost slots read 0 and the
        # recursion's own ghost identity and pad handling apply unchanged)
        blk2 = np.full((nested.K, nested.bs), nb, np.int64)
        bor2 = np.full(nested.nb + 1, nb, np.int64)
        for i in range(nb):
            if nested.block_of[i] >= 0:
                blk2[nested.block_of[i], nested.local_of[i]] = i
            else:
                bor2[nested.local_of[i]] = i
        bmap2g = bor2[np.asarray(nested.bmap)]          # [K2, nbl2]
        m = nb + 1
        g_D2 = t(blk2[:, :, None] * m + blk2[:, None, :])
        g_E2 = t(blk2[:, :, None] * m + bmap2g[:, None, :])
        g_F2 = t(bmap2g[:, :, None] * m + blk2[:, None, :])
        g_B2 = t(bor2[:, None] * m + bor2[None, :])
        solve2 = make_bbd_solver(nested, device, method)

    def solve(D, E, F, Bm, f):
        B = f.shape[0]
        fp = torch.cat([f, torch.zeros_like(f[:, :1])], dim=1)
        fk = fp[:, pl.blk_rows]                         # [B, K, bs]
        fb = fp[:, pl.border_rows]                      # [B, nb+1]
        D = D + ghost_eye
        # the block solves, columns of E and the rhs together: one solve
        # over B*K systems
        rhs = torch.cat([E, fk[..., None]], dim=-1)
        sol = dense_solve(D.reshape(B * K, bs, bs).contiguous(),
                          rhs.reshape(B * K, bs, nbl + 1).contiguous(),
                          method).reshape(B, K, bs, nbl + 1)
        DinvE, Dinvf = sol[..., :nbl], sol[..., nbl]
        # Schur complement S = B - sum_k F_k DinvE_k, scattered via bmap
        S = Bm - s_scatter([F @ DinvE]).reshape(B, nb + 1, nb + 1)
        rb = (fb - pl.to_border([_bmv(F, Dinvf)])) * pad
        if nested is None:
            # pad slot: identity row
            xb = dense_solve((S * pad2 + pad_eye).contiguous(), rb, method)
        else:
            Sf = (S * pad2).reshape(B, -1)
            xb2 = solve2(Sf[:, g_D2], Sf[:, g_E2], Sf[:, g_F2], Sf[:, g_B2],
                         rb[:, :nb])
            xb = torch.cat([xb2, torch.zeros_like(xb2[:, :1])], dim=1)
        xk = Dinvf - _bmv(DinvE, xb[:, pl.bmap])
        return _scatter_rows(part, pl, xk, xb)

    return solve
