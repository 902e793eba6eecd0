"""The reference's devices and sources, each a module of its own under
`models/`, found by name: an element letter that takes no `.model` card
(r, c, v, i) by `models/<letter>.py`, and a `.model NAME TYPE` card by
`models/<type>.py`. So a configuration brings a device to the reference
with one new file, and no other file names a device kind. A file whose
name starts with `_` holds equations that typed modules share (`_mos1.py`
behind `nmos.py` and `pmos.py`) and is no type itself.

A model module declares:

  LETTER     the element letter of its instances
  CARD       True where an instance names a `.model` card of this type
  TERMINALS  its terminals, in the element line's order
  INTERNAL   its internal unknowns, as (suffix, kind) pairs: the program
             names each `<element><suffix>` ("#i", "#int"); kind
             "current" or "voltage"
  PARAMS     {name: default} of every parameter it evaluates with; None
             where the netlist has to give it
  INSTANCE   the parameters that an element line may set (name=value)
  VALUE      the parameter that a bare number on the element line sets,
             or None
  SELECT     {card key: value}: keys that select these equations rather
             than parametrise them, with the one value they may take
             (`level` 1 for the level-1 MOSFET)
  FIXED      {name: value} that the type itself sets (nmos: type +1)
  LINEAR     True where f and q are affine in u (G and C are constant)
  SOURCE     True for an independent source: the rest of its line is a
             waveform that its `parse_wave(toks, tran)` reads (`waves.py`),
             its parameter "val" is `value(wave, t)`, and `corners(wave,
             tstop)` are the times at which the integrator has to step
  evaluate(u, p, vt, gmin) -> f, q, G, C
             u [B, I, L] local terminal and internal voltages (lanes,
             instances, locals), p {name: [B, I]}; f and q the currents
             and charges leaving each local [B, I, L], G = df/du and
             C = dq/du [B, I, L, L], written out by hand in NumPy
  limit(u, uold, p, vt) -> u       (optional) the evaluation point
  validate(name, p)                (optional) raises ValueError on
             parameters the equations do not hold for

LETTER, CARD, TERMINALS, PARAMS and `evaluate` are required; the others
default to None, False or empty. Modules that share `evaluate` form one
group of instances (nmos and pmos instances are one level-1 group, as the
program groups them).
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path

MODELS = Path(__file__).resolve().parent / "models"
_NAME = re.compile(r"^[a-z][a-z0-9_]*$")
OPTIONAL = {"INTERNAL": (), "INSTANCE": (), "VALUE": None, "SELECT": {},
            "FIXED": {}, "LINEAR": False, "SOURCE": False, "limit": None,
            "validate": None}


def _load(name: str):
    if not _NAME.match(name) or not (MODELS / f"{name}.py").is_file():
        return None
    mod = importlib.import_module(f"{__package__}.models.{name}")
    for key, default in OPTIONAL.items():
        if not hasattr(mod, key):
            setattr(mod, key, default)
    return mod


def element(letter: str):
    """The module of an element letter that takes no `.model` card, or
    None where the element names a card."""
    mod = _load(letter)
    return None if mod is None or mod.CARD else mod


def card(type_: str):
    """The module of a `.model` card's type."""
    mod = _load(type_)
    if mod is None or not mod.CARD:
        raise ValueError(
            f"no reference model for .model type {type_!r}: the reference "
            f"needs benchmark/reference/models/{type_}.py")
    return mod


def module(name: str):
    """The module an element was resolved to (`Element.kind`)."""
    mod = _load(name)
    if mod is None:
        raise ValueError(f"no reference model {name!r}")
    return mod
