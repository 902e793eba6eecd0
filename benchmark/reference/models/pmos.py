"""The level-1 MOSFET of `_mos1.py` as a `.model pmos` card gives it."""
from __future__ import annotations

from ._mos1 import (CARD, INSTANCE, LETTER, PARAMS, SELECT,  # noqa: F401
                    TERMINALS, evaluate, limit)

FIXED = {"type": -1.0}
