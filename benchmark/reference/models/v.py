"""An independent voltage source: `vNAME n+ n- <waveform>` (`waves.py`).
Its branch current, from n+ through the source to n-, is an unknown, which
the program names `<name>#i`."""
from __future__ import annotations

import numpy as np

from ..waves import corners, parse_wave, value  # noqa: F401

LETTER = "v"
CARD = False
TERMINALS = ("p", "n")
INTERNAL = (("#i", "current"),)
PARAMS = {}
LINEAR = True
SOURCE = True


def evaluate(u, p, vt, gmin):
    f = np.stack([u[..., 2], -u[..., 2], u[..., 0] - u[..., 1] - p["val"]],
                 -1)
    G = np.zeros(u.shape + (3,), u.dtype)
    G[..., 0, 2] = 1.0
    G[..., 1, 2] = -1.0
    G[..., 2, 0] = 1.0
    G[..., 2, 1] = -1.0
    return f, np.zeros_like(f), G, np.zeros_like(G)
