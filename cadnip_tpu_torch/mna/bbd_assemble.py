"""Assembly into block-bordered-diagonal form for large circuits (PyTorch
port of `cadnip_tpu/mna/bbd_assemble.py`).

The same gather -> vmapped evaluation as the dense assembler
(`assemble.GroupEvaluator`), but the Jacobian values are summed into the
BBD tensors (D blocks, E / F coupling strips, border matrix B) instead of
a dense [n, n] matrix. The stamp -> slot map is computed on the host at
build time (the analogue of the reference's COO -> nzval maps,
`src/mna/precompile.jl:253`); each tensor then takes one deterministic
sorted scatter (`assemble.make_sorted_scatter`). Ground and cross-tensor
stamps route to a trash slot that the plans leave out.

The partitioners (`partition_circuit`, `nested_border_partition`,
`_dest`) are host numpy, copied from the JAX package. Its f32 Jacobian
tensors on the TPU (`gc_dtype`) are not ported: every tensor is f64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DTYPE
from ..ops.bbd import BBDPartition, partition_graph
from .assemble import GroupEvaluator, make_sorted_scatter
from .devices import CLASS_I, CLASS_V
from .spec import DynSpec
from .structure import CompiledCircuit


def default_block_size() -> int:
    """BBD block size. Measured by the JAX package on the c6288 CMOS
    multiplier (5,156 unknowns): small blocks win by a wide margin, since
    the batched block cost scales with K*bs^2*nbl while the border stays
    flat."""
    return 32


def partition_circuit(cc: CompiledCircuit, block_size: int | None = None
                      ) -> BBDPartition:
    """Partition a compiled circuit's unknown-connectivity graph.

    Re-partitions with forced border promotion for any branch-current
    (CLASS_I, zero structural diagonal) unknown whose every coupling
    partner landed in the border: its D row would be all zero and the
    block singular (a supply rail's source branch current is the
    canonical case)."""
    if block_size is None:
        block_size = default_block_size()
    edges = []
    device_unknowns = []
    for g in cc.groups:
        for row in g.conn:
            idx = [int(i) for i in row if i < cc.n]
            device_unknowns.append(idx)
            for a in range(len(idx)):
                for b in range(a + 1, len(idx)):
                    edges.append((idx[a], idx[b]))
    pre_border: set = set()
    for _ in range(3):
        part = partition_graph(cc.n, edges, block_size=block_size,
                               device_unknowns=device_unknowns,
                               pre_border=pre_border)
        partners: dict = {}
        for idx in device_unknowns:
            for i in idx:
                if cc.classes[i] == CLASS_I:
                    partners.setdefault(i, set()).update(
                        j for j in idx if j != i)
        viol = {i for i, ps in partners.items()
                if part.block_of[i] >= 0
                and all(part.block_of[j] < 0 for j in ps)}
        if not viol - pre_border:
            break
        pre_border |= viol
    return part


def nested_border_partition(cc: CompiledCircuit, part: BBDPartition,
                            block_size: int = 128
                            ) -> BBDPartition | None:
    """Partition the BORDER unknowns for the nested Schur solve.

    The Schur complement S = B - sum_k F_k D_k^{-1} E_k has an exactly
    known fill pattern: B's entries (devices whose unknowns all sit in
    the border) plus, per block k, a dense clique over that block's bmap
    set. Both go to `partition_graph` as device groups, so its
    block-spanning promotion drops no S nonzero from the level-2 gathers.
    The CLASS_I singular-row guard repeats at this level. Returns None
    where the level-2 border would not shrink below 0.7 nb."""
    nb = part.nb
    lob = part.local_of
    dev2: list = []
    for g in cc.groups:
        for row in g.conn:
            idx = [int(lob[i]) for i in row
                   if i < cc.n and part.block_of[i] < 0]
            if len(idx) > 1:
                dev2.append(sorted(set(idx)))
    for k in range(part.K):
        clique = sorted(int(j) for j in part.bmap[k] if j < nb)
        if len(clique) > 1:
            dev2.append(clique)
    edges2 = []
    for idx in dev2:
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                edges2.append((idx[a], idx[b]))
    classes_b = np.zeros(nb, np.int8)
    for i in range(cc.n):
        if part.block_of[i] < 0:
            classes_b[lob[i]] = cc.classes[i]
    pre_border: set = set()
    part2 = None
    for _ in range(3):
        part2 = partition_graph(nb, edges2, block_size=block_size,
                                device_unknowns=dev2,
                                pre_border=pre_border)
        partners: dict = {}
        for idx in dev2:
            for i in idx:
                if classes_b[i] == CLASS_I:
                    partners.setdefault(i, set()).update(
                        j for j in idx if j != i)
        viol = {i for i, ps in partners.items()
                if part2.block_of[i] >= 0
                and all(part2.block_of[j] < 0 for j in ps)}
        if not viol - pre_border:
            break
        pre_border |= viol
    # only worth it if the level-2 border actually shrank
    if part2 is None or part2.nb > 0.7 * nb:
        return None
    return part2


def _dest(part: BBDPartition, gi: int, gj: int):
    """(tensor_id, flat_index) for a stamp at global (gi, gj).
    tensor ids: 0=D, 1=E, 2=F, 3=B; flat index into the flattened tensor,
    whose size is the trash slot."""
    K, bs, nb, nbl = part.K, part.bs, part.nb, part.nbl
    n = part.n
    if gi >= n or gj >= n:
        return 0, K * bs * bs  # ground -> D trash
    bi = part.block_of[gi]
    bj = part.block_of[gj]
    li = part.local_of[gi]
    lj = part.local_of[gj]
    if bi >= 0 and bj >= 0:
        if bi != bj:
            raise AssertionError("cross-block stamp (promotion failed)")
        return 0, (bi * bs + li) * bs + lj
    if bi >= 0 and bj < 0:
        pos = np.searchsorted(part.bmap[bi], lj)
        if pos >= nbl or part.bmap[bi, pos] != lj:
            raise AssertionError("border slot missing from bmap")
        return 1, (bi * bs + li) * nbl + pos
    if bi < 0 and bj >= 0:
        pos = np.searchsorted(part.bmap[bj], li)
        if pos >= nbl or part.bmap[bj, pos] != li:
            raise AssertionError("border slot missing from bmap")
        return 2, (bj * nbl + pos) * bs + lj
    return 3, li * (nb + 1) + lj


def make_bbd_assembler(cc: CompiledCircuit, part: BBDPartition):
    """Build assemble(x_pad, lim, params, dyn, dly=None) ->
    (F, Q, (GD, GE, GF, GB), (CD, CE, CF, CB), lim_new), batch-first:
    x_pad [B, n+1], F / Q [B, n], GD [B, K, bs, bs], GE [B, K, bs, nbl],
    GF [B, K, nbl, bs], GB [B, nb+1, nb+1]. It carries `init_lim`, `n_lim`
    and `eval_group` as the dense assembler does."""
    n = cc.n
    dev = cc.device
    K, bs, nb, nbl = part.K, part.bs, part.nb, part.nbl
    sizes = {0: K * bs * bs, 1: K * bs * nbl, 2: K * nbl * bs,
             3: (nb + 1) * (nb + 1)}
    shapes = {0: (K, bs, bs), 1: (K, bs, nbl), 2: (K, nbl, bs),
              3: (nb + 1, nb + 1)}
    ev = GroupEvaluator(cc)
    idx = {t: [] for t in range(4)}
    for g in cc.groups:
        nl = g.model.n_local
        gidx = {t: np.full((g.n_inst, nl, nl), sizes[t], np.int64)
                for t in range(4)}
        for si in range(g.n_inst):
            row = g.conn[si]
            for a in range(nl):
                for b in range(nl):
                    t, flat = _dest(part, int(row[a]), int(row[b]))
                    gidx[t][si, a, b] = flat
        for t in range(4):
            idx[t].append(gidx[t])
    # per tensor, the stamps destined for it; the others (its trash slot)
    # take no part
    gc_scatter = {t: make_sorted_scatter(idx[t], sizes[t], dev,
                                         skip=sizes[t]) for t in range(4)}
    fq_scatter = make_sorted_scatter([g.conn for g in cc.groups], n + 1, dev,
                                     skip=n)
    # gshunt lands on node-voltage diagonals only (reference build.jl)
    vmask = torch.as_tensor(cc.classes == CLASS_V, dtype=DTYPE, device=dev)
    gsh = {t: torch.zeros(sizes[t], dtype=DTYPE, device=dev)
           for t in range(4)}
    for i in np.flatnonzero(cc.classes == CLASS_V):
        t, flat = _dest(part, int(i), int(i))
        gsh[t][flat] = 1.0

    def assemble(x_pad, lim, params, dyn: DynSpec, dly=None):
        B = x_pad.shape[0]
        fs, qs, Js, Cs, lim_new = ev.evaluate(x_pad, lim, params, dyn, dly)
        gs = torch.as_tensor(dyn.gshunt).reshape(-1, 1)
        F = fq_scatter(fs)[:, :n] + gs * vmask * x_pad[:, :n]
        Q = fq_scatter(qs)[:, :n]
        G = tuple((gc_scatter[t](Js) + gs * gsh[t]).reshape((B,) + shapes[t])
                  for t in range(4))
        C = tuple(gc_scatter[t](Cs).reshape((B,) + shapes[t])
                  for t in range(4))
        return F, Q, G, C, lim_new

    assemble.init_lim = ev.init_lim
    assemble.n_lim = ev.n_lim
    assemble.n_delay = ev.n_delay
    assemble.eval_group = ev.eval_group
    return assemble
