"""Tier-1 model registry: `.model` cards -> compiled compact models (a copy
of `cadnip_tpu/models/registry.py` that compiles through the port's
`va/codegen.py::load_va_file`).

The reference resolves `.model` cards in two tiers (`src/spc/sema.jl:308-333`):
tier 2 walks netlist-scope VA modules (most recent wins) and tier 1 falls
back to the ModelRegistry, where VADistillerModels registers the ngspice
SPICE levels (`src/model_registry.jl:37-120`, levels 1/2/3/6/9, 49=BSIM3,
14/54=BSIM4, d, npn, njf, ...).

This module is our tier 1. The VA sources are the ngspice-distilled compact
models shipped as reference model-package DATA; they are located through
CADNIP_VA_MODELS (a directory of .va files; the JAX package also looks in
a checkout of the reference, which the port does not assume). Compiled
DeviceModels are cached per file. When a model file is unavailable the
caller falls back to the builtin level-1 devices.
"""
from __future__ import annotations

import os

_SEARCH_DIRS = (os.environ.get("CADNIP_VA_MODELS", ""),)

# (mtype, level) -> VADistiller file stem. Levels follow ngspice:
# MOS 1/2/3/6/9 classical, 8/49 BSIM3v3, 14/54 BSIM4; JFET level 1/2;
# 'nmf'/'pmf' MESFET; 'vdmos' power MOS.
_MOS_LEVELS = {1: "mos1", 2: "mos2", 3: "mos3", 6: "mos6", 9: "mos9",
               8: "bsim3v3", 49: "bsim3v3", 14: "bsim4v8", 54: "bsim4v8"}

VA_LEVELS = {}
for _lvl, _stem in _MOS_LEVELS.items():
    VA_LEVELS[("nmos", _lvl)] = _stem
    VA_LEVELS[("pmos", _lvl)] = _stem
for _lvl, _stem in ((1, "jfet1"), (2, "jfet2")):
    VA_LEVELS[("njf", _lvl)] = _stem
    VA_LEVELS[("pjf", _lvl)] = _stem
VA_LEVELS[("nmf", 1)] = "mes1"
VA_LEVELS[("pmf", 1)] = "mes1"
VA_LEVELS[("vdmos", 1)] = "vdmos"
VA_LEVELS[("d", 1)] = "diode"
VA_LEVELS[("npn", 1)] = "bjt"
VA_LEVELS[("pnp", 1)] = "bjt"

#: mtypes whose level-1 default resolves to a BUILTIN device (fast vmapped
#: residuals); the registry only takes over for levels the builtins do not
#: implement, or when the deck opts in via `.option vamodels`.
BUILTIN_LEVEL1 = {"d", "npn", "pnp", "nmos", "pmos"}

_cache = {}


def model_dir() -> str | None:
    for d in _SEARCH_DIRS:
        if d and os.path.isdir(d):
            return d
    return None


def getmodel(mtype: str, level: int = 1, prefer_va: bool = False):
    """Resolve (.model type, level) to a compiled VA DeviceModel, or None
    when the builtin device should be used / no VA source is available."""
    mtype = mtype.lower()
    level = int(level)
    if not prefer_va and level == 1 and mtype in BUILTIN_LEVEL1:
        return None
    stem = VA_LEVELS.get((mtype, level))
    if stem is None:
        return None
    d = model_dir()
    if d is None:
        return None
    path = os.path.join(d, stem + ".va")
    if not os.path.exists(path):
        return None
    if path not in _cache:
        from ..va.codegen import load_va_file
        models = load_va_file(path)
        _cache[path] = list(models.values())[0]
    return _cache[path]
