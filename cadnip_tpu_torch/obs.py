"""Host spans and call records: the port's one tracing mechanism.

A public entry (`parse_spice`, `vmem_tran`, `tran`, `tran_linear`,
`tran_pit`) opens `call()` (the last four through `entry`), which yields
the dict that becomes the result's `timings`. Inside it, `span(name)`
adds its host seconds (`time.perf_counter_ns`) under `name` and its
occurrences under `name#n` to the innermost open call's dict. A span's
name is the dotted path of the spans open around it within that call, so
the Newton loop of `mna/newton.py` records under
`prepare.op.direct.iter` inside `vmem_tran` and under `op.direct.iter`
inside `tran`. A span with no call open records nothing. `count(name, n)`
adds a program counter under `name#n` at the same place. The stack is
per thread: each shard thread of `parallel/mesh.py` keeps its own
record.

While a torch profiler records, a span also opens a range of its dotted
name, so the port's spans sit in the same trace as the device's kernels,
on the profiler's clock; with no profiler it opens none. The range is a
CPU op (`_RecordFunctionFast`), not a `torch.profiler.record_function`
user annotation: the profiler mirrors a user annotation on the device's
timeline over the kernels launched inside it, and a trace reduction that
unions the device's events would count those spans as device time. A span reads no tensor and makes
no host sync or device allocation: it only ever wraps syncs the code
makes anyway.

    with obs.call() as timings:
        with obs.span("op"):
            ...
    sol.timings = timings          # {"op": s, "op#n": 1, ...}
"""
from __future__ import annotations

import functools
import threading
import time

import torch

_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def _frames() -> list:
    """This thread's stack of (record or None, open span names)."""
    frames = getattr(_local, "frames", None)
    if frames is None:
        frames = _local.frames = [(None, [])]
    return frames


class call:
    """Context manager of one public entry: a fresh record and name path,
    restored to the enclosing call's on exit."""

    __slots__ = ("record",)

    def __enter__(self) -> dict:
        self.record = {}
        _frames().append((self.record, []))
        return self.record

    def __exit__(self, *exc):
        _frames().pop()
        return False


class span:
    """Context manager timing one named piece of host work (see the
    module's docstring)."""

    __slots__ = ("name", "_rec", "_path", "_range", "_t")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec, path = _frames()[-1]
        name = f"{path[-1]}.{self.name}" if path else self.name
        path.append(name)
        self._rec, self._path = rec, path
        self._range = None
        if _profiling():
            self._range = _Range(name)
            self._range.__enter__()
        self._t = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t
        if self._range is not None:
            self._range.__exit__(*exc)
        name = self._path.pop()
        rec = self._rec
        if rec is not None:
            rec[name] = rec.get(name, 0.0) + dt * 1e-9
            rec[name + "#n"] = rec.get(name + "#n", 0) + 1
        return False


def count(name: str, n) -> None:
    """Add n to the count `name#n` under the dotted path of the open spans
    in the innermost open call's record: a program counter, such as K2's
    cycles (`integrate.group_cycles#n`). Nothing with no call open."""
    rec, path = _frames()[-1]
    if rec is not None:
        key = f"{path[-1]}.{name}#n" if path else f"{name}#n"
        rec[key] = rec.get(key, 0) + n


def entry(fn):
    """Decorator of a public entry whose result carries `timings`: runs
    it inside `call()` and adds the record to the result's dict."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with call() as record:
            out = fn(*args, **kwargs)
        out.timings.update(record)
        return out

    return run


def merge(records) -> dict:
    """Key-wise sum of several records (the shards of one sweep, which
    need not have taken the same tiers)."""
    out = {}
    for rec in records:
        for k, v in rec.items():
            out[k] = out.get(k, 0) + v
    return out
