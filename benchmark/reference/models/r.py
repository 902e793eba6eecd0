"""A linear resistor: `rNAME n+ n- value`, in ohms."""
from __future__ import annotations

import numpy as np

LETTER = "r"
CARD = False
TERMINALS = ("p", "n")
PARAMS = {"r": None}
INSTANCE = ("r",)
VALUE = "r"
LINEAR = True


def evaluate(u, p, vt, gmin):
    g = 1.0 / p["r"]
    i = g * (u[..., 0] - u[..., 1])
    f = np.stack([i, -i], -1)
    G = np.stack([np.stack([g, -g], -1), np.stack([-g, g], -1)], -2)
    z = np.zeros_like(f)
    return f, z, np.broadcast_to(G, u.shape + (2,)), np.zeros(
        u.shape + (2,), u.dtype)
