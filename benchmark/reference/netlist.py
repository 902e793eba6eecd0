"""A SPICE netlist reader for the plain reference: the subset the
benchmark's decks use (R, C, V with DC / SIN / PWL, D, level-1 M, .model,
`+` continuation lines, `*` comments, engineering suffixes; a .tran card
is read past).

It knows nothing of the program under test: it turns text into a list of
elements with their numeric parameters, which `mna.py` assembles.
"""
from __future__ import annotations

import dataclasses
import re

GROUND = ("0", "gnd")

_SUFFIX = {"t": 1e12, "g": 1e9, "meg": 1e6, "k": 1e3, "m": 1e-3,
           "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15}
_NUM = re.compile(
    r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:e[+-]?\d+)?)(meg|[tgkmunpf])?")


def value(tok: str) -> float:
    """A SPICE number: 1meg, 100u, 3.6e-07, 42.0m (trailing units ignored)."""
    m = _NUM.match(tok.lower())
    if m is None:
        raise ValueError(f"not a number: {tok!r}")
    return float(m.group(1)) * _SUFFIX.get(m.group(2), 1.0)


@dataclasses.dataclass
class Element:
    name: str            # lower case, e.g. "mno1"
    kind: str            # first letter: r c v d m
    nodes: tuple         # node names
    params: dict         # numeric parameters
    model: str = ""      # model name (d, m)
    wave: tuple = ()     # ("dc", v) | ("sin", vo, va, f, td, theta, ph)
    #                      | ("pwl", t0, v0, t1, v1, ...)


@dataclasses.dataclass
class Netlist:
    title: str
    elements: list
    models: dict         # name -> (type, {param: value})


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


def _wave(toks):
    """The value part of a V line: [dc] v, sin ..., pwl ..."""
    dc = 0.0
    i = 0
    if i < len(toks) and toks[i] == "dc":
        i += 1
    if i < len(toks) and toks[i] not in ("sin", "pwl"):
        dc = value(toks[i])
        i += 1
    if i >= len(toks):
        return ("dc", dc)
    kind, args = toks[i], [value(t) for t in toks[i + 1:]]
    if kind == "sin":
        args = (args + [0.0] * 6)[:6]
        return ("sin", *args)
    if kind == "pwl":
        if len(args) % 2 or not args:
            raise ValueError("PWL needs time/value pairs")
        return ("pwl", *args)
    raise ValueError(f"unsupported source {kind!r}")


def parse(text: str) -> Netlist:
    title, lines = _logical_lines(text)
    els, models = [], {}
    for line in lines:
        toks = _tokens(line)
        head = toks[0]
        if head == ".end":
            break
        if head == ".model":
            _, kw = _kv(toks[3:])
            models[toks[1]] = (toks[2], kw)
            continue
        if head == ".tran":
            continue            # the span and step are the traffic's
        if head.startswith("."):
            raise ValueError(f"unsupported card {head!r}")
        kind = head[0]
        if kind in "rc":
            els.append(Element(head, kind, tuple(toks[1:3]),
                               {"v": value(toks[3])}))
        elif kind == "v":
            els.append(Element(head, kind, tuple(toks[1:3]), {},
                               wave=_wave(toks[3:])))
        elif kind == "d":
            els.append(Element(head, kind, tuple(toks[1:3]), {},
                               model=toks[3]))
        elif kind == "m":
            pos, kw = _kv(toks[1:])
            els.append(Element(head, kind, tuple(pos[:4]), kw, model=pos[4]))
        else:
            raise ValueError(f"unsupported element {head!r}")
    return Netlist(title, els, models)


def breakpoints(net: Netlist, tstop: float):
    """Source corners in (0, tstop]: the PWL times (SIN has none after 0)."""
    out = set()
    for e in net.elements:
        if e.kind == "v" and e.wave[0] == "pwl":
            out.update(t for t in e.wave[1::2] if 0.0 < t < tstop)
    out.add(tstop)
    return sorted(out)
