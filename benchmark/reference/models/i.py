"""An independent current source: `iNAME n+ n- <waveform>` (`waves.py`),
its value the current from n+ through the source to n-: it leaves node n+
and enters node n-."""
from __future__ import annotations

import numpy as np

from ..waves import corners, parse_wave, value  # noqa: F401

LETTER = "i"
CARD = False
TERMINALS = ("p", "n")
PARAMS = {}
LINEAR = True
SOURCE = True


def evaluate(u, p, vt, gmin):
    i = np.broadcast_to(p["val"], u.shape[:-1]).astype(u.dtype)
    f = np.stack([i, -i], -1)
    G = np.zeros(u.shape + (2,), u.dtype)
    return f, np.zeros_like(f), G, np.zeros_like(G)
