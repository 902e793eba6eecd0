"""A linear capacitor: `cNAME n+ n- value`, in farads."""
from __future__ import annotations

import numpy as np

LETTER = "c"
CARD = False
TERMINALS = ("p", "n")
PARAMS = {"c": None}
INSTANCE = ("c",)
VALUE = "c"
LINEAR = True


def evaluate(u, p, vt, gmin):
    c = p["c"]
    q = c * (u[..., 0] - u[..., 1])
    C = np.stack([np.stack([c, -c], -1), np.stack([-c, c], -1)], -2)
    return (np.zeros(u.shape, u.dtype), np.stack([q, -q], -1),
            np.zeros(u.shape + (2,), u.dtype), np.broadcast_to(C, u.shape
                                                                + (2,)))
