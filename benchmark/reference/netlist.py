"""A SPICE netlist reader for the plain reference: elements, `.model`,
`.hdl`, `.tran` and `.end` cards, `+` continuation lines, `*` comments and
engineering suffixes.

What an element line holds is read from its model's module
(`registry.py`): an element letter that takes no card (r, c, v, i) has one
of its own, and any other element names a `.model` card, whose type names
the module. A card type or a parameter that the reference does not model
raises ValueError, so nothing is judged under equations it does not state.
`.hdl "<path>"` is recorded and never opened: the reference's equations of
a Verilog-A device are its model module's, selected by the card's type.
The `.tran` card's step and stop are kept for the source defaults that
SPICE takes from them (`waves.py`); the span and step of a run are the
traffic's.

It knows nothing of the program under test: it turns text into a list of
elements with their numeric parameters, which `mna.py` assembles.
"""
from __future__ import annotations

import dataclasses
import re

from . import registry

GROUND = ("0", "gnd")

_SUFFIX = {"t": 1e12, "g": 1e9, "meg": 1e6, "k": 1e3, "m": 1e-3,
           "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15}
_NUM = re.compile(
    r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:e[+-]?\d+)?)(meg|[tgkmunpf])?")
_HDL = re.compile(r"""^\.hdl\s+["']?([^"']+?)["']?\s*$""", re.IGNORECASE)


def value(tok: str) -> float:
    """A SPICE number: 1meg, 100u, 3.6e-07, 42.0m (trailing units ignored)."""
    m = _NUM.match(tok.lower())
    if m is None:
        raise ValueError(f"not a number: {tok!r}")
    return float(m.group(1)) * _SUFFIX.get(m.group(2), 1.0)


@dataclasses.dataclass
class Element:
    name: str            # lower case, e.g. "mno1"
    kind: str            # its model module (registry), e.g. "nmos", "r"
    nodes: tuple         # node names, in the module's terminal order
    params: dict         # the parameters its line and its card set
    model: str = ""      # the `.model` card's name, where it names one
    wave: tuple = ()     # a source's waveform (waves.py)


@dataclasses.dataclass
class Netlist:
    title: str
    elements: list
    models: dict         # name -> (type, {param: value})
    hdl: list = dataclasses.field(default_factory=list)   # `.hdl` paths
    tran: tuple | None = None    # the `.tran` card's (step, stop)


def _logical_lines(text: str):
    lines = text.splitlines()
    out = []
    for raw in lines[1:]:
        s = raw.strip()
        if not s or s.startswith("*"):
            continue
        if s.startswith("+"):
            if not out:
                raise ValueError("continuation line without a line")
            out[-1] += " " + s[1:]
        else:
            out.append(s)
    return lines[0].strip() if lines else "", out


def _tokens(line: str):
    s = line.lower().replace("(", " ").replace(")", " ").replace(",", " ")
    s = re.sub(r"\s*=\s*", "=", s)
    return s.split()


def _kv(toks):
    pos, kw = [], {}
    for t in toks:
        if "=" in t:
            k, v = t.split("=", 1)
            kw[k] = value(v)
        else:
            pos.append(t)
    return pos, kw


def _card(name, toks):
    """A `.model` card: (type, {param: value}), each key one its module
    evaluates with or selects by."""
    type_ = toks[2]
    mod = registry.card(type_)
    _, kw = _kv(toks[3:])
    for k, v in kw.items():
        if k in mod.SELECT:
            if v != mod.SELECT[k]:
                raise ValueError(f".model {name} {type_}: the reference's "
                                 f"{type_} takes {k}={mod.SELECT[k]:g}, "
                                 f"not {v:g}")
        elif k not in mod.PARAMS or k in mod.FIXED:
            raise ValueError(f".model {name} {type_}: the reference does not "
                             f"model parameter {k!r}")
    return type_, {k: v for k, v in kw.items() if k not in mod.SELECT}


def _locate(name, toks, models):
    """(module, nodes, card name, the rest) of an element that names a
    card: the first positional token that names a `.model` card of this
    letter whose type has that many terminals before it."""
    for k in range(2, len(toks)):
        if "=" in toks[k] or toks[k] not in models:
            continue
        mod = registry.card(models[toks[k]][0])
        if mod.LETTER == name[0] and len(mod.TERMINALS) == k - 1:
            return mod, tuple(toks[1:k]), toks[k], toks[k + 1:]
    raise ValueError(f"{name}: names no .model card of a type the reference "
                     f"models for {name[0]!r} elements")


def _element(toks, models, tran) -> Element:
    name = toks[0]
    mod = registry.element(name[0])
    card = ""
    if mod is None:
        mod, nodes, card, rest = _locate(name, toks, models)
    else:
        L = len(mod.TERMINALS)
        nodes, rest = tuple(toks[1:1 + L]), toks[1 + L:]
        if len(nodes) < L:
            raise ValueError(f"{name}: {L} nodes needed")
    kind = mod.__name__.rsplit(".", 1)[1]
    if mod.SOURCE:
        return Element(name, kind, nodes, {}, card,
                       wave=mod.parse_wave(rest, tran))
    pos, kw = _kv(rest)
    if pos:
        if mod.VALUE is None or len(pos) > 1:
            raise ValueError(f"{name}: unexpected {' '.join(pos)!r}")
        kw = {mod.VALUE: value(pos[0]), **kw}
    bad = sorted(set(kw) - set(mod.INSTANCE))
    if bad:
        raise ValueError(f"{name}: an instance of {kind} may not set {bad}")
    params = dict(models[card][1]) if card else {}
    params.update(kw)
    return Element(name, kind, nodes, params, card)


def parse(text: str) -> Netlist:
    title, lines = _logical_lines(text)
    models, hdl, tran, rest = {}, [], None, []
    for line in lines:
        toks = _tokens(line)
        head = toks[0]
        if head == ".end":
            break
        if head == ".model":
            models[toks[1]] = _card(toks[1], toks)
        elif head == ".hdl":
            m = _HDL.match(line)
            if m is None:
                raise ValueError(f"a .hdl card names one file: {line!r}")
            hdl.append(m.group(1))
        elif head == ".tran":
            if len(toks) < 3:
                raise ValueError(f"a .tran card gives a step and a stop: "
                                 f"{line!r}")
            tran = (value(toks[1]), value(toks[2]))
        elif head.startswith("."):
            raise ValueError(f"unsupported card {head!r}")
        else:
            rest.append(toks)
    els = [_element(toks, models, tran) for toks in rest]
    return Netlist(title, els, models, hdl, tran)
