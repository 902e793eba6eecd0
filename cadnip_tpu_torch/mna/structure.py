"""Circuit construction and elaboration to a fixed-structure compiled form
(PyTorch port of `cadnip_tpu/mna/structure.py`).

All structure (node table, unknown indices, device grouping, scatter index
arrays) is computed in Python at elaboration; the numeric code only sees
fixed-shape gathers and scatters. Instances of the same `DeviceModel` form
one group, evaluated as one vmapped batch. A compiled circuit lives on one
explicit torch device: every tensor it hands out is placed there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, DTYPE, resolve_device
from .devices import CLASS_V, DeviceModel
from .spec import SimSpec
from .waveforms import DC, Waveform, pack_waveforms

GROUND_NAMES = ("0", "gnd", "GND", "Gnd")


@dataclasses.dataclass
class Instance:
    model: DeviceModel
    name: str
    nodes: tuple                       # node names (terminals only)
    params: dict                       # scalar overrides
    wave: Optional[Waveform] = None
    sense: tuple = ()


@dataclasses.dataclass
class Group:
    """All instances of one model, batched."""
    model: DeviceModel
    names: list
    conn: np.ndarray                   # [n_inst, n_local] global unknown idx
    params: dict                       # param name -> np.ndarray [n_inst]
    waves: Optional[list] = None       # list[Waveform] if model uses waves

    @property
    def n_inst(self):
        return len(self.names)


class Circuit:
    """Programmatic netlist. The SPICE front end lowers to this API; users
    can also drive it directly."""

    def __init__(self, title: str = "circuit"):
        self.title = title
        self.instances: list[Instance] = []
        self._names = set()

    def add(self, model: DeviceModel, name: str, nodes, *,
            wave: Waveform | None = None, sense: str | None = None,
            **params):
        if name in self._names:
            raise ValueError(f"duplicate instance name {name!r}")
        unknown = set(params) - set(model.defaults)
        if unknown:
            raise ValueError(
                f"{name}: unknown parameter(s) {sorted(unknown)} for model "
                f"{model.name!r}; valid: {sorted(model.defaults)}")
        nodes = tuple(str(n) for n in nodes)
        if sense is None:
            sense = ()
        elif isinstance(sense, str):
            sense = (sense,)
        n_sense = sum(1 for t in model.terminals if t.startswith("isense"))
        if len(sense) != n_sense:
            raise ValueError(f"{name}: model {model.name!r} needs "
                             f"{n_sense} sensed branch(es), got {len(sense)}")
        n_term = len(model.terminals) - n_sense
        if len(nodes) != n_term:
            raise ValueError(f"{name}: model {model.name!r} needs {n_term} "
                             f"nodes, got {len(nodes)}")
        self._names.add(name)
        self.instances.append(Instance(model, name, nodes, dict(params),
                                       wave, tuple(sense)))
        return self

    # convenience wrappers -------------------------------------------------
    def R(self, name, p, n, r):
        from .devices import RESISTOR
        return self.add(RESISTOR, name, (p, n), r=float(r))

    def C(self, name, p, n, c):
        from .devices import CAPACITOR
        return self.add(CAPACITOR, name, (p, n), c=float(c))

    def L(self, name, p, n, l):
        from .devices import INDUCTOR
        return self.add(INDUCTOR, name, (p, n), l=float(l))

    def V(self, name, p, n, wave=None, dc=0.0, acmag=0.0, acphase=0.0):
        from .devices import VSOURCE
        if wave is None:
            wave = DC(dc)
        return self.add(VSOURCE, name, (p, n), wave=wave,
                        acmag=float(acmag), acphase=float(acphase))

    def I(self, name, p, n, wave=None, dc=0.0, acmag=0.0, acphase=0.0):
        from .devices import ISOURCE
        if wave is None:
            wave = DC(dc)
        return self.add(ISOURCE, name, (p, n), wave=wave,
                        acmag=float(acmag), acphase=float(acphase))

    def D(self, name, anode, cathode, **params):
        from .devices import DIODE, DIODE_RS
        model = DIODE_RS if params.get("rs", 0.0) else DIODE
        return self.add(model, name, (anode, cathode), **params)

    def M(self, name, d, g, s, b="0", **params):
        from .devices import MOSFET1
        return self.add(MOSFET1, name, (d, g, s, b), **params)

    def compile(self, spec: SimSpec | None = None, *, solver: str = "auto",
                block_size: int | None = None,
                device=DEFAULT_DEVICE) -> "CompiledCircuit":
        """Elaborate for one torch device: the card by default (raises
        where there is none), "cpu" for the host.

        solver: "dense", "bbd" or "auto". The block-bordered-diagonal
        decomposition (`mna/bbd_assemble.py`, blocks of `block_size`
        unknowns, 32 by default) is taken when asked, and by "auto" above
        BBD_AUTO_N unknowns; a second BBD level over the border
        (`bbd_nested`) where the border reaches NESTED_AUTO_NB."""
        if solver not in ("auto", "dense", "bbd"):
            raise ValueError(f"solver must be 'auto', 'dense' or 'bbd', got "
                             f"{solver!r}")
        cc = elaborate(self, spec or SimSpec(), device=resolve_device(device))
        if solver == "bbd" or (solver == "auto" and cc.n > BBD_AUTO_N):
            from .bbd_assemble import (nested_border_partition,
                                       partition_circuit)
            cc.bbd = partition_circuit(cc, block_size=block_size)
            if cc.bbd.nb >= NESTED_AUTO_NB:
                # past about a thousand border unknowns the one dense Schur
                # solve starts to dominate
                cc.bbd_nested = nested_border_partition(cc, cc.bbd)
        return cc


#: "auto" compiles to the block-bordered-diagonal backend above this many
#: unknowns, and adds its nested level from this border size on (the JAX
#: package's thresholds, `cadnip_tpu/mna/structure.py:139-145`)
BBD_AUTO_N = 1536
NESTED_AUTO_NB = 1024


@dataclasses.dataclass
class CompiledCircuit:
    """Fixed structure + default parameters on one torch device."""

    title: str
    n: int                              # number of unknowns (excl. ground)
    node_names: dict                    # node name -> unknown index
    names: dict                         # every named unknown -> index
    classes: np.ndarray                 # [n] CLASS_* per unknown
    groups: list                        # list[Group]
    spec: SimSpec
    param_slots: dict                   # "inst.param" -> (gi, pname, slot)
    inst_group: dict                    # inst name -> (gi, slot)
    device: torch.device
    cache: dict = dataclasses.field(default_factory=dict)
    bbd: object = None                  # BBDPartition for large circuits
    bbd_nested: object = None           # level-2 border partition (Schur)
    # host seconds of the front end's spans (`parse_spice`)
    timings: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ params
    def params0(self):
        """Default parameters: list over groups of {name: f64[n_inst]},
        with packed waveforms under 'wave'."""
        out = []
        for g in self.groups:
            d = {k: torch.as_tensor(v, dtype=DTYPE, device=self.device)
                 for k, v in g.params.items()}
            if g.waves is not None:
                d["wave"] = pack_waveforms(g.waves, device=self.device)
            out.append(d)
        return out

    @staticmethod
    def _get_leaf(gparams, pname):
        """Resolve a (possibly dotted, e.g. 'wave.dc') parameter path:
        (holder, head, tail), the leaf being holder[tail]."""
        if "." in pname:
            head, tail = pname.split(".", 1)
            return gparams[head], head, tail
        return gparams, None, pname

    def alter(self, params, **overrides):
        """Functionally update instance parameters: alter(p, **{'r1.r': 2e3}).
        A 1-D value of length B gives that parameter a leading lane axis
        [B, n_inst] for a batched solve. Source DC values are addressable
        as 'v1.dc'."""
        params = [dict(d) for d in params]
        for key, val in overrides.items():
            if key not in self.param_slots:
                valid = ", ".join(sorted(self.param_slots)[:8])
                raise KeyError(f"unknown parameter {key!r}; e.g. {valid}")
            gi, pname, slot = self.param_slots[key]
            params[gi] = dict(params[gi])
            holder, head, pname = self._get_leaf(params[gi], pname)
            if head is not None:
                holder = params[gi][head] = dict(holder)
            arr = holder[pname]
            val = torch.as_tensor(val, dtype=DTYPE, device=self.device)
            if val.ndim == 0:
                arr = arr.clone()
                arr[..., slot] = val
            else:
                batch = val.shape[0]
                if arr.ndim == 1:
                    arr = arr.expand((batch,) + arr.shape)
                arr = arr.clone()
                arr[:, slot] = val
            holder[pname] = arr
        return params

    def index_of(self, name: str) -> int:
        if name in self.names:
            return self.names[name]
        raise KeyError(f"unknown node/unknown {name!r}; known: "
                       f"{sorted(self.names)[:12]}...")


def elaborate(cir: Circuit, spec: SimSpec,
              device: torch.device) -> CompiledCircuit:
    # ---- node table (ground excluded; padding slot == n_unknowns)
    node_names: dict[str, int] = {}
    for inst in cir.instances:
        for nd in inst.nodes:
            if nd in GROUND_NAMES or nd in node_names:
                continue
            node_names[nd] = len(node_names)
    n_nodes = len(node_names)

    # ---- group instances by model, preserving first-seen order
    order: list[DeviceModel] = []
    by_model: dict[DeviceModel, list[Instance]] = {}
    for inst in cir.instances:
        if inst.model not in by_model:
            by_model[inst.model] = []
            order.append(inst.model)
        by_model[inst.model].append(inst)

    # ---- allocate internal unknowns
    names = dict(node_names)
    classes = [CLASS_V] * n_nodes
    next_idx = n_nodes
    internal_idx: dict[tuple, int] = {}   # (inst_name, internal) -> idx
    branch_of: dict[str, int] = {}        # inst -> its 'i' branch unknown
    for model in order:
        cmap = dict(model.collapses)
        for inst in by_model[model]:
            for iname, icls in model.internals:
                if iname in cmap:
                    continue      # merged into its collapse target below
                idx = next_idx
                next_idx += 1
                internal_idx[(inst.name, iname)] = idx
                names[f"{inst.name}#{iname}"] = idx
                classes.append(icls)
                if iname == "i":
                    branch_of[inst.name] = idx
    n = next_idx
    ground = n  # padding slot

    def node_idx(nd: str) -> int:
        return ground if nd in GROUND_NAMES else node_names[nd]

    # resolve collapsed internals (VA `V(a,b) <+ 0` node merges, reference
    # detect_short_circuits `src/vasim.jl:2723`): the collapsed internal's
    # unknown IS its target's: a terminal node, another internal (chains
    # resolve transitively), or ground
    for model in order:
        cmap = dict(model.collapses)
        if not cmap:
            continue
        terms = {t: i for i, t in enumerate(model.terminals)}
        for inst in by_model[model]:
            for iname, _ in model.internals:
                if iname not in cmap:
                    continue
                tgt, seen = iname, set()
                while tgt in cmap and tgt not in seen:
                    seen.add(tgt)
                    tgt = cmap[tgt]
                if tgt is None:
                    idx = ground
                elif tgt in terms:
                    idx = node_idx(inst.nodes[terms[tgt]])
                elif (inst.name, tgt) in internal_idx:
                    idx = internal_idx[(inst.name, tgt)]
                else:
                    raise ValueError(
                        f"{inst.name}: cannot resolve collapse target "
                        f"{tgt!r} for internal node {iname!r}")
                internal_idx[(inst.name, iname)] = idx
                names[f"{inst.name}#{iname}"] = idx

    # ---- build groups
    groups: list[Group] = []
    param_slots: dict[str, tuple] = {}
    inst_group: dict[str, tuple] = {}
    for gi, model in enumerate(order):
        insts = by_model[model]
        conn = np.full((len(insts), model.n_local), ground, np.int64)
        pvals = {k: np.full(len(insts), float(v))
                 for k, v in model.defaults.items()}
        waves = [] if any(i.wave is not None for i in insts) else None
        for si, inst in enumerate(insts):
            col = 0
            node_i = 0
            sense_i = 0
            for tname in model.terminals:
                if tname.startswith("isense"):
                    target = inst.sense[sense_i]
                    sense_i += 1
                    if target not in branch_of:
                        raise ValueError(
                            f"{inst.name}: sensed device {target!r} has no "
                            f"branch current (must be a V source or "
                            f"inductor)")
                    conn[si, col] = branch_of[target]
                else:
                    conn[si, col] = node_idx(inst.nodes[node_i])
                    node_i += 1
                col += 1
            for iname, _ in model.internals:
                conn[si, col] = internal_idx[(inst.name, iname)]
                col += 1
            for k, v in inst.params.items():
                pvals[k][si] = float(v)
            for k in model.defaults:
                param_slots[f"{inst.name}.{k}"] = (gi, k, si)
            if waves is not None:
                # expose the DC value of the source waveform for alter
                param_slots[f"{inst.name}.dc"] = (gi, "wave.dc", si)
                waves.append(inst.wave if inst.wave is not None
                             else DC(0.0))
            inst_group[inst.name] = (gi, si)
        groups.append(Group(model=model, names=[i.name for i in insts],
                            conn=conn, params=pvals, waves=waves))

    return CompiledCircuit(
        title=cir.title, n=n, node_names=node_names, names=names,
        classes=np.asarray(classes, np.int32), groups=groups, spec=spec,
        param_slots=param_slots, inst_group=inst_group, device=device)
