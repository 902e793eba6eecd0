"""Global numeric configuration of the PyTorch port.

Circuit simulation needs double precision for Newton convergence and
LTE-controlled integration (node voltages 1e-9..1e3 V, currents
1e-15..1 A). Every state vector, residual and Jacobian is float64; the
Gauss-Jordan kernel also has a float32 mode that reproduces the JAX
package's f32 Pallas solve.

torch's default dtype is float32, so every tensor constructor in this
package names its dtype explicitly; index tensors are int64.
"""
from __future__ import annotations

import torch

#: working dtype for residual evaluation, state vectors and solves
DTYPE = torch.float64
#: dtype of the Gauss-Jordan kernel's f32 mode
F32 = torch.float32
#: dtype of index tensors (gathers, scatter plans, waveform kinds)
ITYPE = torch.int64

#: the device the public entry points build on unless told otherwise
DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """The torch device an entry point was asked for. A CUDA device on a
    machine without a card raises: the entry points default to the card,
    and a CPU circuit is built only where the caller passes "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"cadnip_tpu_torch: device {str(dev)!r} requested but no CUDA "
            f"device is available; pass device=\"cpu\" to run on the host")
    return dev
