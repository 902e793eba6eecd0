"""Carry parameters and results between the JAX package and the port.

Both packages hold a circuit's parameters as a list over device groups of
dicts {name: [n_inst] array}, with packed waveforms in a nested "wave"
dict (int `kind`/`ncoef`, float `coeffs`/`dc`). A Verilog-A group also
carries a `<name>__given` mask per parameter and, for a model with a
hoisted setup pass, the `__setup__` matrix [n_inst, K]. These helpers move that
structure, converted to numpy, into torch tensors and back, so a test can
run both packages on the same numbers. Only numpy crosses the boundary:
this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_DEVICE, DTYPE, ITYPE, resolve_device


def _leaf_to_torch(v, device):
    a = np.array(v)
    dtype = ITYPE if np.issubdtype(a.dtype, np.integer) else DTYPE
    return torch.as_tensor(a, dtype=dtype, device=device)


def params_from_numpy(params_np, device=DEFAULT_DEVICE):
    """[{name: array | {name: array}}] (e.g. the JAX `cc.params0()` after
    np.asarray on every leaf) -> the port's parameters on `device` (the
    card by default, "cpu" for the host)."""
    device = resolve_device(device)
    def conv(d):
        return {k: conv(v) if isinstance(v, dict)
                else _leaf_to_torch(v, device) for k, v in d.items()}

    return [conv(d) for d in params_np]


def to_numpy(obj):
    """Tensors, lists, tuples and dicts of them -> the same with numpy
    arrays (NamedTuples keep their type)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj
