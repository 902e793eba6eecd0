"""The table of peaks and the least time of a kernel, counted from the
circuit and the traffic (never from the program's internals).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s
of HBM3, 67 TFLOP/s in FP64 on the tensor cores (and in FP32 outside
them). The least time is the larger of the bytes read once and written
once over the memory rate and the operations over the peak rate.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_FP64 = 67e12


def solve_flops(n: int, k: int) -> int:
    """Operations that solving A X = B needs, A [n, n] and B [n, k]: an LU
    factorisation (2n^3/3) and two triangular solves per column (2n^2 k).
    A Gauss-Jordan elimination does more; the bound does not charge them."""
    return 2 * n ** 3 // 3 + 2 * n * n * k


def bound_s(bytes_: float, flops: float) -> tuple:
    """(least seconds, "bytes" or "operations")."""
    tb = bytes_ / HBM_BYTES_PER_S
    tf = flops / PEAK_FLOPS_FP64
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def batched_solve_bound(batch: int, n: int, k: int, itemsize: int = 8):
    """A batch of dense solves [batch, n, n + k] -> [batch, n, k]."""
    bytes_ = itemsize * batch * (n * (n + k) + n * k)
    return bound_s(bytes_, batch * solve_flops(n, k))


def transient_bound(n: int, n_save: int, input_bytes: int, nnewton: int):
    """One fused transient: its inputs read once, its save grid [n_save, n]
    and final state [3, n] written once, or one LU solve of the Newton
    system per Newton iteration these inputs took."""
    bytes_ = input_bytes + 8 * (n_save * n + 3 * n)
    return bound_s(bytes_, nnewton * solve_flops(n, 1))


def circuit_counts(cfg: dict) -> tuple:
    """(unknowns n, input bytes) of a configuration's nominal netlist, as
    the reference assembles it: per instance its terminal indices (int32)
    and parameters (f64), then x0, q0, dq/dt0 and the tolerances [n] and
    the source corners up to the stop time, which closes them."""
    from . import traffic as tf
    from ..reference import mna, netlist

    cir = mna.Circuit(netlist.parse(tf.render(cfg)))
    bytes_ = 8 * 4 * cir.n + 8 * len(cir.breakpoints(0.0, cfg["tstop"]))
    for g in cir.groups:
        I, L = g.conn.shape
        bytes_ += 4 * I * L + 8 * I * len(g.params)
    return cir.n, bytes_
